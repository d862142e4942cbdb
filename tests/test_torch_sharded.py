"""The port's sharded paths on unpacked planes (``lbaudiodetective_torch/
parallel/{sharded,dedup,dryrun}.py``) against the JAX package's
``parallel.sharded`` and ``parallel.dedup`` on the same numpy inputs: the
JAX side on its 8-device virtual CPU mesh, the port on an 8-slot CPU mesh.
Data-parallel extraction equals the port's unsharded extraction bit for
bit (and the JAX package's at the port's 99.9 % bar).  The port matches
unpacked planes by packing them, so its match, ring and dedup scores, and
dedup indices, equal the JAX package's packed paths and
``match_one_vs_many_padded`` bit for bit; the JAX package's own unpacked
paths divide where its packed ones multiply by a reciprocal and differ
from them by an ulp, so against those the bar is the JAX package's own
between its two paths (1e-6, tests/test_sharded_packed.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lbaudiodetective_tpu.ops.match import match_one_vs_many_padded  # noqa: E402
from lbaudiodetective_tpu.oracle.pipeline import oracle_match_fingerprints  # noqa: E402
from lbaudiodetective_tpu.parallel import sharded_packed as jax_packed  # noqa: E402
from lbaudiodetective_tpu.parallel import dedup as jax_dedup  # noqa: E402
from lbaudiodetective_tpu.parallel import sharded as jax_sharded  # noqa: E402
from lbaudiodetective_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from lbaudiodetective_tpu.utils import packing  # noqa: E402
from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.ops.extract import (  # noqa: E402
    extract_fingerprint_padded, required_padded_length)
from lbaudiodetective_torch.parallel import dedup, sharded  # noqa: E402
from lbaudiodetective_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from lbaudiodetective_torch.parallel.mesh import make_mesh, unshard  # noqa: E402
from tests._torch_common import bit_agreement, brown_noise, jax_config  # noqa: E402
from tests.test_match import random_fp  # noqa: E402


def _jax_words(pos, neg):
    l, s, pairs = pos.shape
    return [jnp.asarray(packing.pack_bits(x.reshape(-1, pairs)).reshape(l, s, -1))
            for x in (pos, neg)]


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(8), make_mesh(8, device="cpu")


def _padded_library(rng, sizes, s_max, pairs=100):
    fps = [random_fp(rng, n, pairs) for n in sizes]
    pos = np.zeros((len(sizes), s_max, pairs), np.uint8)
    neg = np.zeros_like(pos)
    for i, (p, n) in enumerate(fps):
        pos[i, :p.shape[0]] = p
        neg[i, :n.shape[0]] = n
    return fps, pos, neg, np.array(sizes, np.int32)


@pytest.mark.parametrize("n_sub", [1, 3])
def test_extract_data_parallel_equals_unsharded_and_jax(meshes, n_sub):
    jmesh, mesh = meshes
    cfg = FingerprintConfig()
    n_rows = cfg.rows_per_frame * n_sub
    audio = brown_noise(20 + n_sub, 8, required_padded_length(cfg, n_rows))
    valid = np.array([n_sub, 1, n_sub, 0, n_sub, n_sub, 1, n_sub], np.int32)
    pos_s, neg_s = sharded.extract_data_parallel(audio, valid, cfg, n_rows, mesh)
    assert len(pos_s) == 4 and pos_s[0].shape == (2, n_sub, cfg.num_wavelet_pairs)
    pos_s, neg_s = unshard(pos_s).numpy(), unshard(neg_s).numpy()
    pos_1, neg_1 = extract_fingerprint_padded(torch.from_numpy(audio),
                                              torch.from_numpy(valid), cfg, n_rows)
    np.testing.assert_array_equal(pos_s, pos_1.numpy())
    np.testing.assert_array_equal(neg_s, neg_1.numpy())
    jp, jn = jax_sharded.extract_data_parallel(jnp.asarray(audio), jnp.asarray(valid),
                                               jax_config(cfg), n_rows, jmesh)
    assert bit_agreement(pos_s, neg_s, np.asarray(jp), np.asarray(jn)) >= 0.999
    ragged = sharded.extract_data_parallel(audio[:7], valid[:7], cfg, n_rows, mesh)[0]
    np.testing.assert_array_equal(unshard(ragged).numpy()[:7], pos_s[:7])   # padded slot


def test_match_library_sharded_equals_jax_and_oracle(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(21)
    sizes = [12, 3, 7, 9, 1, 12, 5, 8]
    fps, pos, neg, counts = _padded_library(rng, sizes, 12)
    qp, qn = np.zeros((12, 100), np.uint8), np.zeros((12, 100), np.uint8)
    query = random_fp(rng, 6)
    qp[:6], qn[:6] = query
    got = sharded.match_library_sharded(qp, qn, 6, pos, neg, counts, mesh)
    assert [s.shape for s in got] == [(4,), (4,)]
    got = unshard(got).numpy()
    single = np.asarray(match_one_vs_many_padded(
        jnp.asarray(qp), jnp.asarray(qn), jnp.int32(6), jnp.asarray(pos), jnp.asarray(neg),
        jnp.asarray(counts)))
    np.testing.assert_array_equal(got, single)
    ref = np.asarray(jax_sharded.match_library_sharded(
        jnp.asarray(qp), jnp.asarray(qn), jnp.int32(6), jnp.asarray(pos), jnp.asarray(neg),
        jnp.asarray(counts), jmesh))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    for i, fp in enumerate(fps):
        np.testing.assert_allclose(got[i], oracle_match_fingerprints(fp, query), atol=1e-6)


@pytest.mark.parametrize("comparison_range", [0, 37])
def test_ring_all_pairs_equals_jax(meshes, comparison_range):
    jmesh, mesh = meshes
    rng = np.random.default_rng(22)
    sizes = [4, 7, 2, 9, 5, 3, 8, 6]
    fps, pos, neg, counts = _padded_library(rng, sizes, 9)
    got = unshard(sharded.ring_all_pairs_scores(
        pos, neg, counts, mesh, comparison_range=comparison_range)).numpy()
    packed = np.asarray(jax_packed.ring_all_pairs_scores_packed(
        *_jax_words(pos, neg), jnp.asarray(counts), 100, jmesh,
        comparison_range=comparison_range))
    np.testing.assert_array_equal(got, packed)
    ref = np.asarray(jax_sharded.ring_all_pairs_scores(
        jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(counts), jmesh,
        comparison_range=comparison_range))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    if comparison_range == 0:
        oracle = np.array([[oracle_match_fingerprints(a, b) for b in fps] for a in fps])
        np.testing.assert_allclose(got, oracle, atol=1e-6)
        np.testing.assert_allclose(got, got.T, atol=1e-6)


def test_ring_dedup_topk_equals_jax(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(60)
    l, s_max, k = 16, 6, 3
    sizes = rng.integers(2, s_max + 1, size=l)
    _, pos, neg, counts = _padded_library(rng, [int(n) for n in sizes], s_max)
    scores, idx = (unshard(x).numpy() for x in dedup.ring_dedup_topk(pos, neg, counts, mesh,
                                                                     k=k))
    js, ji = jax_packed.ring_dedup_topk_packed(*_jax_words(pos, neg), jnp.asarray(counts), 100,
                                               jmesh, k=k)
    np.testing.assert_array_equal(scores, np.asarray(js))
    np.testing.assert_array_equal(idx, np.asarray(ji))
    us, ui = jax_dedup.ring_dedup_topk(jnp.asarray(pos), jnp.asarray(neg),
                                       jnp.asarray(counts), jmesh, k=k)
    np.testing.assert_allclose(scores, np.asarray(us), rtol=0, atol=1e-6)
    full = unshard(sharded.ring_all_pairs_scores(pos, neg, counts, mesh)).numpy()
    np.testing.assert_allclose(np.take_along_axis(full, np.asarray(ui), 1), scores,
                               rtol=0, atol=1e-6)     # JAX's picks score what the port's do


@pytest.mark.parametrize("n_slots", [8, 2])
def test_dryrun_multichip_on_cpu_slots(n_slots):
    dryrun_multichip(n_slots, "cpu")
