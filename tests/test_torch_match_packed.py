"""The port's packed matcher (``ops/match_packed.py`` and the plain version
of its kernel) vs the JAX package's, on inputs made from a seed with numpy.

Tolerances: scores within 1e-6 of the JAX packed, unpacked and fused
(interpret mode) matchers -- f32 sums that may differ in their order
(the port adds its diagonal terms in the reference's order, and in
practice its scores are equal); two-stage search indices equal (ties
included) and scores within 1e-7."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lbaudiodetective_tpu.ops import match_packed as jmp  # noqa: E402
from lbaudiodetective_tpu.ops.match import match_one_vs_many_padded  # noqa: E402
from lbaudiodetective_tpu.ops.pallas.match_fused import match_one_vs_many_fused  # noqa: E402
from lbaudiodetective_tpu.utils.packing import pack_bits  # noqa: E402
from lbaudiodetective_torch.ops import match_packed as tmp_  # noqa: E402
from lbaudiodetective_torch.ops.kernels.match_packed import (  # noqa: E402
    SMEM_FOUR_CTAS, SMEM_LIMIT, SMEM_TWO_CTAS, launch_plan,
    match_one_vs_many_fused as kernel_wrapper, popcount32)
from tests._torch_common import (  # noqa: E402
    match_packed_layout, ragged_case, sign_planes, synthetic_library)


def t_words(plane):
    return tmp_.pack_bits_device(torch.from_numpy(np.ascontiguousarray(plane)))


def j_words(plane):
    return jmp.pack_bits_device(jnp.asarray(plane))


@pytest.mark.parametrize("pairs", [100, 64, 33])
def test_pack_bits_device_equals_jax_and_numpy(pairs):
    rng = np.random.default_rng(pairs)
    plane = (rng.random((3, 7, pairs)) < 0.5).astype(np.uint8)
    plane[..., 31] = 1                               # bit 31: the int32 sign bit
    plane[0, 0] = 1                                  # an all-ones word
    got = t_words(plane)
    assert got.dtype == torch.int32
    got = got.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(j_words(plane)))
    np.testing.assert_array_equal(got, pack_bits(plane))
    assert (got[..., 0] >= 1 << 31).all()


def test_popcount32_counts_every_bit():
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF], np.uint32)
    got = popcount32(torch.from_numpy(x.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, [bin(int(v)).count("1") for v in x])


@pytest.mark.parametrize("pairs,comparison_range", [(100, 0), (100, 37), (100, 64),
                                                    (100, 100), (64, 0), (33, 5)])
def test_mask_words_equal_jax(pairs, comparison_range):
    np.testing.assert_array_equal(
        tmp_._mask_words(pairs, comparison_range, 200),
        jmp._mask_words(pairs, comparison_range, 200))


@pytest.mark.parametrize("comparison_range", [0, 100, 37, 64])
def test_plain_packed_matcher_equals_jax(comparison_range):
    q_pos, q_neg, nq, lib_pos, lib_neg, n_lib = ragged_case(3, 100)
    got = tmp_.match_one_vs_many_packed(
        t_words(q_pos), t_words(q_neg), nq, t_words(lib_pos), t_words(lib_neg),
        torch.from_numpy(n_lib), 100, comparison_range, 200).numpy()
    jargs = (j_words(q_pos), j_words(q_neg), jnp.int32(nq), j_words(lib_pos),
             j_words(lib_neg), jnp.asarray(n_lib), 100, comparison_range, 200)
    packed = np.asarray(jmp.match_one_vs_many_packed(*jargs))
    fused = np.asarray(match_one_vs_many_fused(*jargs, t_tile=32, interpret=True))
    unpacked = np.asarray(match_one_vs_many_padded(
        jnp.asarray(q_pos), jnp.asarray(q_neg), jnp.int32(nq), jnp.asarray(lib_pos),
        jnp.asarray(lib_neg), jnp.asarray(n_lib), comparison_range, 200))
    assert got.shape == (128,) and got[0] == 0.0
    for ref in (packed, fused, unpacked):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("comparison_range", [0, 37])
def test_plain_packed_matcher_two_words(comparison_range):
    """64 pairs (W=2), the subfingerprint_length=128 layout."""
    q_pos, q_neg, nq, lib_pos, lib_neg, n_lib = ragged_case(4, 64, l=64, nq=40)
    got = tmp_.match_one_vs_many_packed(
        t_words(q_pos), t_words(q_neg), nq, t_words(lib_pos), t_words(lib_neg),
        torch.from_numpy(n_lib), 64, comparison_range, 128).numpy()
    exp = np.asarray(jmp.match_one_vs_many_packed(
        j_words(q_pos), j_words(q_neg), jnp.int32(nq), j_words(lib_pos),
        j_words(lib_neg), jnp.asarray(n_lib), 64, comparison_range, 128))
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6)


def test_query_axis_equals_per_query_and_self_match():
    q_pos, q_neg, _, lib_pos, lib_neg, n_lib = ragged_case(5, 100, l=48)
    lp, ln, nl = t_words(lib_pos), t_words(lib_neg), torch.from_numpy(n_lib)
    picks = [3, 7, 11]
    qp, qn = lp[picks], ln[picks]
    batched = tmp_.match_one_vs_many_packed(qp, qn, nl[picks], lp, ln, nl, 100)
    assert batched.shape == (3, 48)
    for row, i in enumerate(picks):
        single = tmp_.match_one_vs_many_packed(qp[row], qn[row], nl[i], lp, ln, nl, 100)
        assert torch.equal(batched[row], single)
        assert abs(float(single[i]) - 1.0) <= 1e-6
        assert float(single.max()) == float(single[i])


def test_kernel_wrapper_refuses_bad_input():
    q = torch.zeros((1, 8, 4), dtype=torch.int32)
    lib = torch.zeros((5, 8, 4), dtype=torch.int32)
    nq, nl = torch.ones(1, dtype=torch.int32), torch.ones(5, dtype=torch.int32)
    with pytest.raises(TypeError):
        kernel_wrapper(q.long(), q.long(), nq, lib, lib, nl, 100)
    with pytest.raises(ValueError, match="words per row"):
        kernel_wrapper(q[..., :2], q[..., :2], nq, lib, lib, nl, 100)
    with pytest.raises(ValueError, match="counts"):
        kernel_wrapper(q, q, nq, lib, lib, nl[:4], 100)
    meta = [t.to("meta") for t in (q, q, nq, lib, lib, nl)]
    with pytest.raises(NotImplementedError):
        kernel_wrapper(*meta, 100)
    with pytest.raises(ValueError, match="words per row"):
        tmp_.match_one_vs_many_packed(q[0], q[0], 1, lib, lib, nl, 64)


def test_launch_plan_groups_queries_and_names_the_limit():
    """The kernel's launch plan, with its layout as on the card: a full scan
    (1 query of 80 rows vs 80-row entries) runs chunks of 16 entries, two
    CTAs an SM; a search's coarse pass (4 phases of 20 rows) and
    search_many's at B=8 (32 rows) run every query in one CTA, four CTAs an
    SM; 64 queries of 64 rows split into groups of the most that fit; a
    query and an entry of 4000 rows do not fit."""
    def plan(b, sq, sl, w=4):
        return launch_plan(match_packed_layout, b, sq, sl, w)

    assert plan(1, 80, 80) == (1, 16, 2) and match_packed_layout(1, 80, 16, 80, 4) <= SMEM_TWO_CTAS
    assert plan(4, 20, 20) == (4, 32, 4) and match_packed_layout(4, 20, 32, 20, 4) <= SMEM_FOUR_CTAS
    assert plan(32, 20, 20) == (32, 16, 4)
    bg, e, ctas = plan(64, 64, 64)
    assert (e, ctas) == (16, 2) and 1 < bg < 64
    assert match_packed_layout(bg, 64, 16, 64, 4) <= SMEM_TWO_CTAS
    assert match_packed_layout(bg + 1, 64, 16, 64, 4) > SMEM_TWO_CTAS
    bg, e, ctas = plan(1, 40, 1500)
    assert e < 16 and match_packed_layout(1, 40, e, 1500, 4) <= SMEM_LIMIT
    with pytest.raises(ValueError, match=f"the limit is {SMEM_LIMIT}"):
        plan(1, 4000, 4000)


def test_entries_per_call_chunks_only_the_plain_version():
    """The plain version scans ``chunk`` entries a call; the kernel scans
    the whole library in one launch."""
    assert tmp_.entries_per_call(100_000, 65536, torch.device("cpu")) == 65536
    assert tmp_.entries_per_call(100_000, 65536, torch.device("cuda", 0)) == 100_000
    assert tmp_.entries_per_call(0, 16, torch.device("cuda")) == 1


def test_phase_strided_query_planes_equal_jax():
    rng = np.random.default_rng(6)
    qp, qn = sign_planes(rng, (2, 21, 100))
    nq = np.array([21, 6], np.int32)
    for phases in (None, 1, 3):
        for got, exp in zip(tmp_.phase_strided_query_planes(qp, qn, nq, 4, phases),
                            jmp.phase_strided_query_planes(qp, qn, nq, 4, phases)):
            np.testing.assert_array_equal(got, exp)
    for got, exp in zip(tmp_.phase_strided_query_planes(qp[0], qn[0], 21, 4),
                        jmp.phase_strided_query_planes(qp[0], qn[0], 21, 4)):
        np.testing.assert_array_equal(got, exp)


def _search_both(q_pos, q_neg, nq, lib_pos, lib_neg, n_lib, stride, chunk, shortlist,
                 top_k):
    """Port and JAX two-stage search on the same planes."""
    pad = (-len(n_lib)) % chunk
    qcp, qcn, nc = jmp.phase_strided_query_planes(q_pos, q_neg, nq, stride)
    lcp = np.pad(lib_pos[:, ::stride], ((0, pad), (0, 0), (0, 0)))
    lcn = np.pad(lib_neg[:, ::stride], ((0, pad), (0, 0), (0, 0)))
    ncl = np.pad(-(-n_lib // stride), (0, pad)).astype(np.int32)
    planes = (q_pos, q_neg, qcp, qcn, lib_pos, lib_neg, lcp, lcn)
    kw = dict(pairs=100, comparison_range=0, subfingerprint_length=200, coarse_range=64,
              chunk=chunk, shortlist=shortlist, top_k=top_k)
    tp = [t_words(x) for x in planes]
    t_idx, t_sc = tmp_.two_stage_search_packed(
        tp[0], tp[1], nq, tp[2], tp[3], torch.from_numpy(nc), tp[4], tp[5],
        torch.from_numpy(n_lib), tp[6], tp[7], torch.from_numpy(ncl), **kw)
    jp = [j_words(x) for x in planes]
    j_idx, j_sc = jmp.two_stage_search_packed(
        jp[0], jp[1], jnp.int32(nq), jp[2], jp[3], jnp.asarray(nc), jp[4], jp[5],
        jnp.asarray(n_lib), jp[6], jp[7], jnp.asarray(ncl), **kw)
    return t_idx.numpy(), t_sc.numpy(), np.asarray(j_idx), np.asarray(j_sc)


def test_two_stage_search_equals_jax():
    base_pos, base_neg, lib_pos, lib_neg = synthetic_library()
    n_lib = np.full(64, 48, np.int32)
    t_idx, t_sc, j_idx, j_sc = _search_both(base_pos, base_neg, 48, lib_pos, lib_neg,
                                            n_lib, 4, 16, 8, 5)
    assert t_idx[0] == 11
    np.testing.assert_array_equal(t_idx, j_idx)
    np.testing.assert_allclose(t_sc, j_sc, rtol=0, atol=1e-7)


def test_two_stage_search_ties_follow_jax():
    """Duplicate entries tie exactly in both stages; the shortlist and the
    top-k order them as ``lax.top_k`` does (ascending index).  The entry
    count (20) is not a chunk multiple, so padding entries are masked."""
    rng = np.random.default_rng(8)
    bases = [sign_planes(rng, (24, 100)) for _ in range(4)]
    lib_pos = np.stack([bases[i % 4][0] for i in range(20)])
    lib_neg = np.stack([bases[i % 4][1] for i in range(20)])
    n_lib = np.full(20, 24, np.int32)
    n_lib[8] = 0                                     # scores 0, like padding
    q_pos, q_neg = bases[1][0][3:], bases[1][1][3:]  # offset crop of base 1
    q_pos = np.pad(q_pos, ((0, 3), (0, 0)))
    q_neg = np.pad(q_neg, ((0, 3), (0, 0)))
    t_idx, t_sc, j_idx, j_sc = _search_both(q_pos, q_neg, 21, lib_pos, lib_neg, n_lib,
                                            4, 8, 12, 8)
    np.testing.assert_array_equal(t_idx, j_idx)
    np.testing.assert_allclose(t_sc, j_sc, rtol=0, atol=1e-7)
    assert list(t_idx[:5]) == [1, 5, 9, 13, 17]
    assert len(set(t_sc[:5].tolist())) == 1
