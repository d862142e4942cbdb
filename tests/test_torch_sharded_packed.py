"""The port's packed sharded paths (``lbaudiodetective_torch/parallel/
sharded_packed.py``) against the JAX package's on the same numpy inputs:
the JAX side on its 8-device virtual CPU mesh (tests/conftest.py), the port
on an 8-slot CPU mesh (both ``{"data": 4, "library": 2}``).  Match, ring,
dedup and search scores are compared bit for bit, and dedup indices too,
ties included; the inputs are the JAX package's own tests'
(tests/test_sharded_packed.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lbaudiodetective_tpu.ops.match import match_one_vs_many_padded  # noqa: E402
from lbaudiodetective_tpu.ops.match_packed import (  # noqa: E402
    pack_bits_device as jax_pack, phase_strided_query_planes)
from lbaudiodetective_tpu.oracle.pipeline import oracle_match_fingerprints  # noqa: E402
from lbaudiodetective_tpu.parallel import sharded_packed as jsp  # noqa: E402
from lbaudiodetective_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from lbaudiodetective_tpu.utils import packing  # noqa: E402
from lbaudiodetective_torch.parallel import sharded_packed as sp  # noqa: E402
from lbaudiodetective_torch.parallel.mesh import as_tensor, make_mesh, unshard  # noqa: E402
from tests.test_match import random_fp  # noqa: E402

PAIRS = 100


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(8), make_mesh(8, device="cpu")


def _library(rng, sizes, s_max, pairs=PAIRS):
    fps = [random_fp(rng, int(n), pairs) for n in sizes]
    pos = np.zeros((len(sizes), s_max, pairs), np.uint8)
    neg = np.zeros_like(pos)
    for i, (p, n) in enumerate(fps):
        pos[i, :p.shape[0]] = p
        neg[i, :n.shape[0]] = n
    return fps, pos, neg, *_words(pos, neg), np.asarray(sizes, np.int32)


def _words(pos, neg):
    l, s, pairs = pos.shape
    return tuple(packing.pack_bits(x.reshape(-1, pairs)).reshape(l, s, -1) for x in (pos, neg))


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_match_equals_jax_unpacked_and_oracle(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(70)
    sizes = [12, 3, 7, 9, 1, 12, 5, 8]
    fps, pos, neg, pos_w, neg_w, counts = _library(rng, sizes, 12)
    got = unshard(sp.match_library_sharded_packed(
        as_tensor(pos_w[2]), as_tensor(neg_w[2]), sizes[2], pos_w, neg_w, counts, PAIRS,
        mesh)).numpy()
    ref = np.asarray(jsp.match_library_sharded_packed(
        *_jax(pos_w[2], neg_w[2]), jnp.int32(sizes[2]), *_jax(pos_w, neg_w, counts), PAIRS,
        jmesh))
    np.testing.assert_array_equal(got, ref)
    single = np.asarray(match_one_vs_many_padded(
        *_jax(pos[2], neg[2]), jnp.int32(sizes[2]), *_jax(pos, neg, counts)))
    np.testing.assert_array_equal(got, single)
    oracle = np.array([oracle_match_fingerprints(fps[2], f) for f in fps])
    np.testing.assert_allclose(got, oracle, atol=1e-6)
    assert got[2] == pytest.approx(1.0)


def test_match_many_equals_jax(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(73)
    sizes = [12, 3, 7, 9, 1, 12, 5, 8, 6, 10]
    _, _, _, pos_w, neg_w, counts = _library(rng, sizes, 12)
    q = [0, 4, 9]
    got = sp.match_many_library_sharded_packed(
        as_tensor(pos_w[q]), as_tensor(neg_w[q]), counts[q], pos_w, neg_w, counts, PAIRS, mesh)
    assert [tuple(s.shape) for s in got] == [(3, 5), (3, 5)]
    ref = np.asarray(jsp.match_many_library_sharded_packed(
        *_jax(pos_w[q], neg_w[q], counts[q], pos_w, neg_w, counts), PAIRS, jmesh))
    np.testing.assert_array_equal(unshard(got, dim=1).numpy(), ref)


def test_ring_all_pairs_equals_jax(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(71)
    sizes = rng.integers(1, 9, size=16)
    _, pos, neg, pos_w, neg_w, counts = _library(rng, sizes, 8)
    got = sp.ring_all_pairs_scores_packed(pos_w, neg_w, counts, PAIRS, mesh)
    assert [tuple(s.shape) for s in got] == [(8, 16), (8, 16)]
    got = unshard(got).numpy()
    ref = np.asarray(jsp.ring_all_pairs_scores_packed(*_jax(pos_w, neg_w, counts), PAIRS,
                                                      jmesh))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(np.diag(got), 1.0, atol=1e-6)


def test_ring_splits_visiting_blocks_past_the_launch_cap(meshes, monkeypatch):
    """A visiting block of more queries than a launch takes goes in parts:
    the same scores and dedup picks."""
    _, mesh = meshes
    rng = np.random.default_rng(75)
    _, _, _, pos_w, neg_w, counts = _library(rng, rng.integers(1, 7, size=14), 6)
    whole = unshard(sp.ring_all_pairs_scores_packed(pos_w, neg_w, counts, PAIRS, mesh))
    dd = [unshard(x) for x in sp.ring_dedup_topk_packed(pos_w, neg_w, counts, PAIRS, mesh, k=4)]
    monkeypatch.setattr(sp, "MAX_QUERIES", 3)
    assert torch.equal(unshard(sp.ring_all_pairs_scores_packed(pos_w, neg_w, counts, PAIRS,
                                                               mesh)), whole)
    split = [unshard(x) for x in sp.ring_dedup_topk_packed(pos_w, neg_w, counts, PAIRS, mesh,
                                                           k=4)]
    assert all(torch.equal(a, b) for a, b in zip(dd, split))


def test_ring_dedup_equals_jax_and_bruteforce(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(60)
    l, k = 16, 3
    sizes = rng.integers(2, 7, size=l)
    fps, _, _, pos_w, neg_w, counts = _library(rng, sizes, 6)
    scores, idx = (unshard(x).numpy() for x in sp.ring_dedup_topk_packed(
        pos_w, neg_w, counts, PAIRS, mesh, k=k))
    js, ji = jsp.ring_dedup_topk_packed(*_jax(pos_w, neg_w, counts), PAIRS, jmesh, k=k)
    np.testing.assert_array_equal(scores, np.asarray(js))
    np.testing.assert_array_equal(idx, np.asarray(ji))
    full = np.array([[oracle_match_fingerprints(fps[i], fps[j]) if i != j else -np.inf
                      for j in range(l)] for i in range(l)])
    for i in range(l):
        top = np.sort(full[i])[::-1][:k]
        np.testing.assert_allclose(scores[i], top, atol=1e-6)
        np.testing.assert_allclose(full[i][idx[i]], scores[i], atol=1e-6)


def test_ring_dedup_ties_take_jax_indices(meshes):
    """Duplicated entries, silent entries (score 0 against everything) and
    a k past the real candidates: many equal scores, in the running best
    and the new block alike.  The indices must be JAX's (lax.top_k: the
    lower position wins), including the -1 of never-filled slots."""
    jmesh, mesh = meshes
    rng = np.random.default_rng(61)
    sizes = [5, 5, 0, 4, 5, 0, 3, 5]
    _, pos, neg, _, _, counts = _library(rng, sizes, 6)
    for dst, src in ((1, 0), (4, 0), (7, 3)):              # exact duplicates
        pos[dst], neg[dst], counts[dst] = pos[src], neg[src], counts[src]
    pos_w, neg_w = _words(pos, neg)
    for k in (3, 9):
        scores, idx = (unshard(x).numpy() for x in sp.ring_dedup_topk_packed(
            pos_w, neg_w, counts, PAIRS, mesh, k=k))
        js, ji = jsp.ring_dedup_topk_packed(*_jax(pos_w, neg_w, counts), PAIRS, jmesh, k=k)
        np.testing.assert_array_equal(scores, np.asarray(js))
        np.testing.assert_array_equal(idx, np.asarray(ji))
    assert (idx == -1).any() and (scores == 0.0).sum() > 8


def test_ring_dedup_at_scale_equals_jax(meshes):
    """L=1024 over the ring (the JAX package's at-scale case)."""
    jmesh, mesh = meshes
    rng = np.random.default_rng(72)
    l, s_max, k = 1024, 4, 4
    sizes = rng.integers(1, s_max + 1, size=l)
    cls = rng.choice(3, size=(l, s_max, PAIRS), p=[0.3, 0.35, 0.35])
    valid = np.arange(s_max)[None, :, None] < sizes[:, None, None]
    pos = ((cls == 1) & valid).astype(np.uint8)
    neg = ((cls == 2) & valid).astype(np.uint8)
    pos_w, neg_w = _words(pos, neg)
    counts = sizes.astype(np.int32)
    scores, idx = (unshard(x).numpy() for x in sp.ring_dedup_topk_packed(
        pos_w, neg_w, counts, PAIRS, mesh, k=k))
    js, ji = jsp.ring_dedup_topk_packed(*_jax(pos_w, neg_w, counts), PAIRS, jmesh, k=k)
    np.testing.assert_array_equal(scores, np.asarray(js))
    np.testing.assert_array_equal(idx, np.asarray(ji))
    assert (idx != np.arange(l)[:, None]).all()


def _search_inputs(seed, l, s_max, stride):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(4, s_max + 1, l).tolist()
    _, pos, neg, pos_w, neg_w, counts = _library(rng, sizes, s_max)
    queries = []
    for qi in (5, 11, 30):
        qp, qn = np.zeros((s_max, PAIRS), np.uint8), np.zeros((s_max, PAIRS), np.uint8)
        qp[:sizes[qi]], qn[:sizes[qi]] = pos[qi, :sizes[qi]], neg[qi, :sizes[qi]]
        qcp, qcn, nc = phase_strided_query_planes(qp, qn, sizes[qi], stride)
        queries.append((qp, qn, sizes[qi], qcp, qcn, nc))
    lib = (pos_w, neg_w, counts, np.ascontiguousarray(pos_w[:, ::stride]),
           np.ascontiguousarray(neg_w[:, ::stride]), -(-counts // stride))
    return queries, lib


def _packed_query(q):
    """``([S, W], [S, W], n, [P, Sc, W], [P, Sc, W], [P])`` uint32 words."""
    qp, qn, n, qcp, qcn, nc = q
    qpw, qnw = _words(qp[None], qn[None])
    return (qpw[0], qnw[0], n, *_words(qcp, qcn), nc)


@pytest.mark.parametrize("chunk", [65536, 12])
def test_search_equals_jax(meshes, chunk):
    """Per-shard shortlists merged on the host: the JAX package's indices
    and exact scores (chunk 12 does not divide the 32-entry shards)."""
    jmesh, mesh = meshes
    queries, lib = _search_inputs(71, 64, 16, 2)
    for q in queries:
        qpw, qnw, n, qcpw, qcnw, nc = _packed_query(q)
        kw = dict(coarse_range=64, shortlist=8, top_k=3, chunk=chunk)
        got = sp.search_library_sharded_packed(
            as_tensor(qpw), as_tensor(qnw), n, as_tensor(qcpw), as_tensor(qcnw), nc,
            *lib, PAIRS, mesh, **kw)
        ref = jsp.search_library_sharded_packed(
            *_jax(qpw, qnw), jnp.int32(n), *_jax(qcpw, qcnw, nc), *_jax(*lib), PAIRS,
            jmesh, **kw)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[0].dtype == np.int64


def test_search_many_equals_jax(meshes):
    jmesh, mesh = meshes
    queries, lib = _search_inputs(72, 48, 12, 2)
    packed = [_packed_query(q) for q in queries]
    qpw, qnw, qcpw, qcnw = (np.stack([p[i] for p in packed]) for i in (0, 1, 3, 4))
    n = np.array([p[2] for p in packed], np.int32)
    nc = np.stack([p[5] for p in packed])
    kw = dict(coarse_range=64, shortlist=6, top_k=2, chunk=16)
    gi, gs = sp.search_many_library_sharded_packed(
        *(as_tensor(x) for x in (qpw, qnw)), n, *(as_tensor(x) for x in (qcpw, qcnw)), nc,
        *lib, PAIRS, mesh, **kw)
    ri, rs = jsp.search_many_library_sharded_packed(
        *_jax(qpw, qnw, n, qcpw, qcnw, nc), *_jax(*lib), PAIRS, jmesh, **kw)
    assert gi.shape == (3, 2)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gs, rs)
    for r, q in enumerate(packed):                        # batched == one at a time
        si, ss = sp.search_library_sharded_packed(
            as_tensor(q[0]), as_tensor(q[1]), q[2], as_tensor(q[3]), as_tensor(q[4]),
            q[5], *lib, PAIRS, mesh, **kw)
        np.testing.assert_array_equal(gi[r], si)
        np.testing.assert_array_equal(gs[r], ss)


def test_jax_packer_and_the_port_words_agree():
    """The port's words are the JAX package's uint32 bit patterns."""
    rng = np.random.default_rng(74)
    planes = (rng.random((3, 5, PAIRS)) < 0.5).astype(np.uint8)
    from lbaudiodetective_torch.ops.match_packed import pack_bits_device

    got = pack_bits_device(torch.from_numpy(planes)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jax_pack(jnp.asarray(planes))))
