"""The port's long-context matchers (``ops/match.py``: ``match_long_padded``,
``match_long_hierarchical``) vs the JAX package's on the CPU, on seeded
fingerprints (``tests/test_match.py::random_fp``) and queries planted in
longer fingerprints with 5 % of their bits flipped.

Tolerance: within 1e-6 of the JAX package's function and of the one-vs-one
``match_fingerprints`` (float32 sums in another order), as
tests/test_long_match.py holds the reference.  The JAX package's dense
matcher is compared only below 256 rows: it compiles one roll a row."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lbaudiodetective_tpu.ops import match as jax_match  # noqa: E402
from lbaudiodetective_torch.ops.match import (  # noqa: E402
    match_fingerprints, match_long_hierarchical, match_long_padded)
from tests.test_match import random_fp  # noqa: E402

TOL = 1e-6
#: (n1, n2, chunk, S2, comparison_range, planted offset or None)
CASES = {"dense": (200, 17, 64, 32, 0, None),
         "range_51": (100, 9, 64, 16, 51, None),
         "planted": (1000, 30, 256, 32, 0, 611),
         "planted_range_64": (700, 20, 128, 24, 64, 333)}


def _case(name):
    n1, n2, chunk, s2, cr, at = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 91)
    fp1 = random_fp(rng, n1)
    fp2 = random_fp(rng, n2)
    if at is not None:          # the query is fp1's rows at `at`, 5 % flipped
        flips = rng.random((n2, 100)) < 0.05
        pos = np.where(flips, 1 - fp1[0][at:at + n2], fp1[0][at:at + n2]).astype(np.uint8)
        fp2 = (pos, (fp1[1][at:at + n2] * (1 - pos)).astype(np.uint8))
    s1 = -(-n1 // chunk) * chunk
    p1, q1 = (np.zeros((s1, 100), np.uint8) for _ in range(2))
    p2, q2 = (np.zeros((s2, 100), np.uint8) for _ in range(2))
    p1[:n1], q1[:n1] = fp1
    p2[:n2], q2[:n2] = fp2
    return (p1, q1, n1, p2, q2, n2), fp1, fp2, chunk, cr


def _jax(fn, args, **kw):
    p1, q1, n1, p2, q2, n2 = args
    return float(fn(jnp.asarray(p1), jnp.asarray(q1), jnp.int32(n1),
                    jnp.asarray(p2), jnp.asarray(q2), jnp.int32(n2), **kw))


@pytest.mark.parametrize("name", sorted(CASES))
def test_long_padded_equals_jax_and_dense(name):
    args, fp1, fp2, chunk, cr = _case(name)
    got = float(match_long_padded(*args, comparison_range=cr, chunk=chunk, device="cpu"))
    assert got == pytest.approx(_jax(jax_match.match_long_padded, args,
                                     comparison_range=cr, chunk=chunk), abs=TOL)
    assert got == pytest.approx(match_fingerprints(fp1, fp2, cr, device="cpu"), abs=TOL)
    if CASES[name][0] < 256:
        assert got == pytest.approx(jax_match.match_fingerprints(fp1, fp2, cr), abs=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_long_hierarchical_equals_jax(name):
    args, fp1, fp2, _, cr = _case(name)
    got = float(match_long_hierarchical(*args, comparison_range=cr, device="cpu"))
    assert got == pytest.approx(_jax(jax_match.match_long_hierarchical, args,
                                     comparison_range=cr), abs=TOL)
    if CASES[name][5] is not None:      # a genuine match: its peak survives
        assert got == pytest.approx(match_fingerprints(fp1, fp2, cr, device="cpu"), abs=TOL)


def test_long_matchers_take_tensors_and_refuse_unpadded_fp1():
    args, fp1, fp2, chunk, cr = _case("planted")
    tensors = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    assert float(match_long_padded(*tensors, chunk=chunk, device="cpu")) == float(
        match_long_padded(*args, chunk=chunk, device="cpu"))
    p1, q1, n1, p2, q2, n2 = args
    with pytest.raises(ValueError, match="multiple of chunk"):
        match_long_padded(p1[:-1], q1[:-1], n1, p2, q2, n2, chunk=chunk, device="cpu")


def test_hierarchical_ties_go_to_the_lower_offset():
    """A query repeated at two offsets: equal coarse means, and both the
    port and the JAX package keep the lower one among the candidates."""
    rng = np.random.default_rng(5)
    base = random_fp(rng, 300)
    q = (base[0][40:60].copy(), base[1][40:60].copy())
    pos, neg = base[0].copy(), base[1].copy()
    pos[200:220], neg[200:220] = q
    p1, q1 = (np.zeros((320, 100), np.uint8) for _ in range(2))
    p1[:300], q1[:300] = pos, neg
    p2, q2 = (np.zeros((24, 100), np.uint8) for _ in range(2))
    p2[:20], q2[:20] = q
    args = (p1, q1, 300, p2, q2, 20)
    got = float(match_long_hierarchical(*args, n_candidates=1, refine_radius=0,
                                        device="cpu"))
    assert got == 1.0 == _jax(jax_match.match_long_hierarchical, args,
                              n_candidates=1, refine_radius=0)
