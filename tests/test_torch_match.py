"""The port's matcher vs the JAX matcher (scores within 1e-6) and the five
corpus identification matrices, run through the port's matcher on the
committed JAX fingerprint fixtures (tests/test_corpus_identification.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_torch.ops.match import (  # noqa: E402
    match_fingerprints, match_one_vs_many_padded)
from tests.conftest import BIRDS, CACHE  # noqa: E402


def _random_fp(rng, n_sub, pairs=100, p_zero=0.2):
    cls = rng.choice(3, size=(n_sub, pairs), p=[p_zero, (1 - p_zero) / 2, (1 - p_zero) / 2])
    return (cls == 1).astype(np.uint8), (cls == 2).astype(np.uint8)


@pytest.mark.parametrize("comparison_range", [0, 50, 201])
def test_match_fingerprints_equals_jax(comparison_range):
    from lbaudiodetective_tpu.ops.match import match_fingerprints as jax_match

    rng = np.random.default_rng(7 + comparison_range)
    for n1, n2 in [(10, 10), (20, 7), (5, 12), (1, 1), (48, 21), (3, 40)]:
        fp1, fp2 = _random_fp(rng, n1), _random_fp(rng, n2)
        got = match_fingerprints(fp1, fp2, comparison_range, device="cpu")
        assert abs(got - jax_match(fp1, fp2, comparison_range)) <= 1e-6
        if n1 != n2:             # the longer side is always slid: symmetric
            assert abs(got - match_fingerprints(fp2, fp1, comparison_range, device="cpu")) <= 1e-6
    assert match_fingerprints(_random_fp(rng, 0), _random_fp(rng, 4), device="cpu") == 0.0


@pytest.mark.parametrize("comparison_range", [0, 50, 201])
def test_one_vs_many_equals_jax(comparison_range):
    """Unequal lengths exercise both swap orientations."""
    import jax.numpy as jnp

    from lbaudiodetective_tpu.ops.match import match_one_vs_many_padded as jax_many

    rng = np.random.default_rng(40 + comparison_range)
    s, pairs = 24, 100
    n_lib = np.array([24, 3, 11, 17, 1, 0, 9, 24], np.int32)
    lib_pos = np.zeros((len(n_lib), s, pairs), np.uint8)
    lib_neg = np.zeros_like(lib_pos)
    for i, n in enumerate(n_lib):
        lib_pos[i, :n], lib_neg[i, :n] = _random_fp(rng, n)
    for n_q in (11, 24, 2):
        qp, qn = np.zeros((s, pairs), np.uint8), np.zeros((s, pairs), np.uint8)
        qp[:n_q], qn[:n_q] = _random_fp(rng, n_q)
        m = min(n_q, 11)                         # entry 2 partly equal to the query
        lib_pos[2, :m], lib_neg[2, :m] = qp[:m], qn[:m]
        got = match_one_vs_many_padded(
            torch.from_numpy(qp), torch.from_numpy(qn), torch.tensor(n_q),
            torch.from_numpy(lib_pos), torch.from_numpy(lib_neg),
            torch.from_numpy(n_lib), comparison_range).numpy()
        exp = np.asarray(jax_many(jnp.asarray(qp), jnp.asarray(qn), jnp.int32(n_q),
                                  jnp.asarray(lib_pos), jnp.asarray(lib_neg),
                                  jnp.asarray(n_lib), comparison_range))
        np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6)
        for i, n in enumerate(n_lib):
            one = match_fingerprints((lib_pos[i, :n], lib_neg[i, :n]), (qp[:n_q], qn[:n_q]),
                                     comparison_range, device="cpu")
            assert abs(got[i] - one) <= 1e-6


# Identified counts and diagonal bounds of tests/test_corpus_identification.py.
IDENTIFIED = {"_eql": 10, "_dif": 0, "_blu1": 6, "_blu2": 8, "_rec": 4}


def _check_suite(suffix, m):
    diag = np.diag(m)
    d = {b: m[i, i] for i, b in enumerate(BIRDS)}
    if suffix == "_eql":
        assert (np.sort(diag)[1:] >= 95.0).all() and diag.min() >= 56.0
        assert m[~np.eye(10, dtype=bool)].max() < 55.0
    elif suffix == "_dif":
        assert (diag >= 50.0).all() and (diag <= 54.5).all()
        assert m.max() < 56.0 and m.min() > 49.0
    elif suffix == "_blu1":
        assert d["Crow"] >= 79.0 and d["BlackBird"] >= 74.0
        assert d["Pigeon"] >= 65.0 and d["Kestrel"] >= 63.0
        assert diag.min() >= 52.0
    elif suffix == "_blu2":
        assert d["Crow"] >= 74.5 and d["BlackBird"] >= 69.0 and diag.min() >= 51.0
    else:
        assert (diag >= 52.0).all() and (diag <= 55.5).all()


@pytest.mark.parametrize("suffix", list(IDENTIFIED))
def test_corpus_matrices_through_port_matcher(suffix):
    from tests.conftest import config_cache_key

    key = config_cache_key()
    names = list(BIRDS) + [b + suffix for b in BIRDS]
    files = {n: CACHE / f"jaxfp_{key}_{n}.npz" for n in names}
    if not all(f.exists() for f in files.values()):
        pytest.skip("committed jaxfp fixtures for this pipeline key are absent")
    fps = {}
    for n, f in files.items():
        with np.load(f) as z:
            fps[n] = (z["pos"], z["neg"])
    m = np.array([[match_fingerprints(fps[a], fps[b + suffix], device="cpu") * 100.0 for b in BIRDS]
                  for a in BIRDS])
    identified = int(sum(m[i, i] == m[i].max() for i in range(10)))
    assert identified == IDENTIFIED[suffix]
    _check_suite(suffix, m)
