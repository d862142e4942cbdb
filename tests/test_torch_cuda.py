"""Tests of the port's CUDA kernels: they need an NVIDIA GPU and skip
without one.  This file imports no JAX (the card's host has none), so it
runs there on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Each kernel is held to its plain version on the same tensors on the card
(the fused rows kernel to the plain version evaluated in float64); the
tolerance of the rows kernels (fused rows, band rows) is the reference's
(rtol 5e-4, atol 3e-6 * max|coeff|: f32 summation order differs); the
match kernel's is
1e-6 (both add the diagonal terms in the same order, so they agree to the
last bit unless the compiler reorders)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.ops import kernels  # noqa: E402
from lbaudiodetective_torch.ops.constants import constants_to_tensors  # noqa: E402
from lbaudiodetective_torch.ops.extract import required_padded_length  # noqa: E402
from lbaudiodetective_torch.ops.kernels import band_rows  # noqa: E402
from lbaudiodetective_torch.ops.kernels.fused_rows import (  # noqa: E402
    fused_band_rows, fused_band_rows_plain, rows_arrays)
from lbaudiodetective_torch.ops.kernels.match_packed import (  # noqa: E402
    match_one_vs_many_fused, match_one_vs_many_fused_plain)
from lbaudiodetective_torch.ops.kernels.select_signs import (  # noqa: E402
    select_sign_classes, select_sign_classes_plain)
from lbaudiodetective_torch.ops.match_packed import _mask_pairs, pack_bits_device  # noqa: E402
from tests._torch_common import (  # noqa: E402,F401
    H100_SMEM_BYTES, band_rows_layout, bit_agreement, brown_noise, cuda_device,
    non_finite_audio, numpy_select, ragged_case, select_cases, synth_clip)

pytestmark = pytest.mark.cuda


def _threshold_cases() -> dict[str, np.ndarray]:
    """Frames that probe the select's threshold: all zeros (every key ties
    at abs bits 0), and 200 equal maxima (the 128th key ties with 72 more
    across the boundary) among smaller values of both signs."""
    rng = np.random.default_rng(9)
    ties = rng.standard_normal((16, 4096)).astype(np.float32)
    for f in ties:
        f[rng.choice(4096, 200, replace=False)] = np.float32(9.5) * rng.choice([-1, 1], 200)
    return {"all_zeros": np.zeros((8, 4096), np.float32), "ties_200_maxima": ties}


CASES = {**select_cases(), **_threshold_cases()}
HOPS = {4: dict(hop_domain="proc", analysis_stride=4), 8: dict(), 64: dict(hop_domain="proc"),
        128: dict(hop_domain="proc", analysis_stride=128)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_select_kernel_matches_plain(case, cuda_device):
    x = torch.from_numpy(CASES[case]).to(cuda_device)
    before = select_sign_classes.launches
    got = select_sign_classes(x)
    torch.cuda.synchronize()
    assert select_sign_classes.launches == before + 1
    assert torch.equal(got, select_sign_classes_plain(x))
    np.testing.assert_array_equal(got.cpu().numpy(), numpy_select(CASES[case]))


@pytest.mark.parametrize("hop", sorted(HOPS))
def test_rows_kernel_matches_plain(hop, cuda_device):
    cfg = FingerprintConfig(**HOPS[hop])
    n_rows = 1024
    audio = brown_noise(51, 3, required_padded_length(cfg, n_rows))
    consts = constants_to_tensors(rows_arrays(cfg), cuda_device)
    x = torch.from_numpy(audio).to(cuda_device)
    before = fused_band_rows.launches
    got = fused_band_rows(x, cfg, n_rows, consts, emit="coeffs")
    cls = fused_band_rows(x, cfg, n_rows, consts)
    torch.cuda.synchronize()
    assert fused_band_rows.launches == before + 2
    # Held to the plain version evaluated in float64: the kernel's stage 2
    # (3xTF32 on the residue-0 remainder) is closer to it than the plain
    # version's own float32 evaluation.
    exp = fused_band_rows_plain(x.double(), cfg, n_rows,
                                {k: v.double() for k, v in consts.items()},
                                emit="coeffs").cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), exp, rtol=5e-4,
                               atol=3e-6 * float(np.abs(exp).max()))
    assert torch.equal(cls, select_sign_classes(got.reshape(-1, 4096)).reshape(cls.shape))
    assert torch.equal(got, fused_band_rows(x, cfg, n_rows, consts, emit="coeffs"))
    assert torch.equal(cls, fused_band_rows(x, cfg, n_rows, consts))


@pytest.mark.parametrize("hop", sorted(HOPS))
def test_rows_kernel_with_non_finite_samples_matches_plain(hop, cuda_device):
    """NaN at a tile's first sample and +inf at a clip's first sample zero
    only the windows that hold them, as in the plain version (which
    tests/test_torch_rows.py holds to the JAX package on such input)."""
    cfg = FingerprintConfig(**HOPS[hop])
    n_rows = 1024
    audio = non_finite_audio(brown_noise(53, 2, required_padded_length(cfg, n_rows)), hop)
    consts = constants_to_tensors(rows_arrays(cfg), cuda_device)
    x = torch.from_numpy(audio).to(cuda_device)
    got = fused_band_rows(x, cfg, n_rows, consts, emit="coeffs")
    cls = fused_band_rows(x, cfg, n_rows, consts)
    exp = fused_band_rows_plain(x.double(), cfg, n_rows,
                                {k: v.double() for k, v in consts.items()},
                                emit="coeffs").cpu().numpy()
    assert np.isfinite(got.cpu().numpy()).all()
    np.testing.assert_allclose(got.cpu().numpy(), exp, rtol=5e-4,
                               atol=3e-6 * float(np.abs(exp).max()))
    assert torch.equal(cls, select_sign_classes(got.reshape(-1, 4096)).reshape(cls.shape))


BAND_ROWS_CASES = {
    # name: (config kwargs, wrapper, fuse_haar / coefficients)
    "rows_oracle_mode": (dict(integer_hop=False), "fused_band_rows", False),
    "rows_rate_8000": (dict(processing_sample_rate=8000.0, integer_hop=False),
                       "fused_band_rows", False),
    "rows_pitch_16": (dict(pitch_step_count=16, integer_hop=False), "fused_band_rows", False),
    "rows_rows_256": (dict(rows_per_frame=256, integer_hop=False), "fused_band_rows", False),
    "rows_hop_512_split": (dict(hop_domain="proc", analysis_stride=512),
                           "fused_band_rows", False),
    "v2_rows": (dict(), "fused_band_rows_v2", False),
    "v2_coeffs": (dict(), "fused_band_rows_v2", True),
    "v3_pitch_16": (dict(pitch_step_count=16), "fused_band_rows_v3", True),
    "v3_rows_256": (dict(rows_per_frame=256), "fused_band_rows_v3", True),
    "v3_length_300": (dict(subfingerprint_length=300), "fused_band_rows_v3", True),
}


@pytest.mark.parametrize("case", sorted(BAND_ROWS_CASES))
def test_band_rows_kernel_matches_plain(case, cuda_device):
    """Rows mode (kernel 5, and 4 without fuse_haar) and coefficients mode
    (kernel 2 at other geometries, and 4 with fuse_haar) against the plain
    version on the same tensors; hop 512 splits 128 windows into sub-tiles
    of 64.  Two runs are bit-identical."""
    kw, name, coeffs = BAND_ROWS_CASES[case]
    cfg = FingerprintConfig(**kw)
    n_rows = 4 * cfg.rows_per_frame
    x = torch.from_numpy(brown_noise(52, 3, required_padded_length(cfg, n_rows))).to(cuda_device)
    wrapper = getattr(band_rows, name)
    extra = {} if name == "fused_band_rows" else {"fuse_haar": coeffs}
    before = wrapper.launches
    got = wrapper(x, cfg, n_rows, **extra)
    again = wrapper(x, cfg, n_rows, **extra)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert got.shape == (3, n_rows, cfg.pitch_step_count) and torch.equal(got, again)
    exp = band_rows.band_rows_plain(x, cfg, n_rows, coeffs).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), exp, rtol=5e-4,
                               atol=3e-6 * float(np.abs(exp).max()))


def test_band_rows_layout_is_the_kernels(cuda_device):
    """The layout the CPU tests plan with is the kernel's own, and the card
    lets a block use an H100's shared memory."""
    from lbaudiodetective_torch.ops.kernels._build import load_library

    lib = load_library()
    for args in ((128, 32, 3072, 0), (64, 32, 34304, 0), (128, 32, 3072, 8192),
                 (256, 16, 3072, 0), (128, 64, 3072, 0), (128, 8, 2048, 4096)):
        assert lib.lbad_band_rows_smem_bytes(*args) == band_rows_layout(*args), args
    assert lib.lbad_band_rows_smem_limit() == H100_SMEM_BYTES


@pytest.mark.parametrize("kw", [dict(integer_hop=False),
                                dict(processing_sample_rate=8000.0, integer_hop=False),
                                dict(pitch_step_count=16), dict(subfingerprint_length=300),
                                dict(rows_per_frame=256)])
def test_every_config_extracts_on_cuda(kw, cuda_device):
    """The configs that raised NotImplementedError before the band-rows
    kernel extract on CUDA through it, >= 99.9 % of bits against the CPU."""
    from lbaudiodetective_torch.models.detective import AudioDetective

    cfg = FingerprintConfig(**kw)
    clips = [synth_clip(74 + i, 4.0, cfg) for i in range(2)]
    kernels.reset_launch_counts()
    fps = AudioDetective(cfg, device=cuda_device).process_decoded_batch(clips)
    counts = kernels.launch_counts()
    key = ("band_rows.fused_band_rows_v3" if cfg.has_integer_hop
           else "band_rows.fused_band_rows")
    assert counts[key] == 1
    refs = AudioDetective(cfg).process_decoded_batch(clips)
    for f, r in zip(fps, refs):
        assert f.num_subfingerprints == r.num_subfingerprints > 0
        assert bit_agreement(f.pos, f.neg, r.pos, r.neg) >= 0.999


def test_cuda_extraction_runs_kernels_and_equals_cpu(cuda_device):
    from lbaudiodetective_torch.models.detective import AudioDetective

    cfg = FingerprintConfig()
    gpu, cpu = AudioDetective(cfg, device=cuda_device), AudioDetective(cfg, device="cpu")
    long_clip, short_clip = synth_clip(70, 4.0, cfg), synth_clip(71, 1.5, cfg)
    kernels.reset_launch_counts()
    fps = [gpu.process_decoded(long_clip), gpu.process_decoded(short_clip)]
    counts = kernels.launch_counts()
    # A 4 s clip takes the fused classes mode; a single clip that fits one
    # 8-tile step takes coefficients + the standalone select.
    assert counts == {"select_sign_classes": 1, "fused_band_rows": 2,
                      "match_one_vs_many_fused": 0, "band_rows.fused_band_rows": 0,
                      "band_rows.fused_band_rows_v2": 0, "band_rows.fused_band_rows_v3": 0}
    refs = [cpu.process_decoded(long_clip), cpu.process_decoded(short_clip)]
    for f, r in zip(fps, refs):
        assert f.num_subfingerprints == r.num_subfingerprints
        assert bit_agreement(f.pos, f.neg, r.pos, r.neg) >= 0.999
    lib = refs + [cpu.process_decoded(synth_clip(72, 3.0, cfg))]
    np.testing.assert_allclose(gpu.match_against_library(refs[0], lib),
                               cpu.match_against_library(refs[0], lib), rtol=0, atol=1e-6)


def test_unported_config_raises_on_cuda(cuda_device):
    """No config the reference runs on its accelerator is refused any more:
    the fractional hop extracts through the band-rows kernel.  The one the
    reference's kernel refuses (window 1024, fractional hop) raises
    ValueError, as it does there."""
    from lbaudiodetective_torch.ops.extract import extract_fingerprint

    cfg = FingerprintConfig(integer_hop=False)
    clip = synth_clip(73, 2.0, cfg)
    before = band_rows.fused_band_rows.launches
    pos, neg, n = extract_fingerprint(clip, cfg, device=cuda_device)
    assert band_rows.fused_band_rows.launches == before + 1
    cpos, cneg, cn = extract_fingerprint(clip, cfg)
    assert n == cn > 0 and bit_agreement(pos, neg, cpos, cneg) >= 0.999
    cfg = FingerprintConfig(window_size=1024, integer_hop=False)
    with pytest.raises(ValueError, match="window_size == 2048"):
        extract_fingerprint(synth_clip(73, 2.0, cfg), cfg, device=cuda_device)


def _words(plane, dev):
    return pack_bits_device(torch.from_numpy(np.ascontiguousarray(plane)).to(dev))


MATCH_CASES = {"range0": (100, 0, 200), "range100": (100, 100, 200),
               "range37": (100, 37, 200), "range64": (100, 64, 200),
               "w2_range0": (64, 0, 128), "w2_range37": (64, 37, 128)}


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_match_kernel_matches_plain(case, cuda_device):
    """Ragged counts (0, shorter than the query, equal to it), W=4 and W=2,
    words with bit 31 set; a batch of three queries incl. two self-matches."""
    pairs, comparison_range, length = MATCH_CASES[case]
    q_pos, q_neg, nq, lib_pos, lib_neg, n_lib = ragged_case(31, pairs)
    lp, ln = _words(lib_pos, cuda_device), _words(lib_neg, cuda_device)
    assert bool((lp < 0).any())                       # bit 31 set somewhere
    nl = torch.from_numpy(n_lib).to(cuda_device)
    qp = torch.stack([_words(q_pos, cuda_device), lp[7], lp[2]])
    qn = torch.stack([_words(q_neg, cuda_device), ln[7], ln[2]])
    nqs = torch.tensor([nq, n_lib[7], n_lib[2]], dtype=torch.int32, device=cuda_device)
    m = _mask_pairs(pairs, comparison_range, length)
    before = match_one_vs_many_fused.launches
    got = match_one_vs_many_fused(qp, qn, nqs, lp, ln, nl, m)
    torch.cuda.synchronize()
    assert match_one_vs_many_fused.launches == before + 1
    exp = match_one_vs_many_fused_plain(qp, qn, nqs, lp, ln, nl, m)
    assert float((got - exp).abs().max()) <= 1e-6
    assert got[0, 0] == 0.0
    for row, i in ((1, 7), (2, 2)):
        assert abs(float(got[row, i]) - 1.0) <= 1e-6 and got[row].max() == got[row, i]
    one = match_one_vs_many_fused(qp[1:2], qn[1:2], nqs[1:2], lp, ln, nl, m)
    assert torch.equal(one[0], got[1])


def test_match_kernel_matches_plain_at_coarse_shape(cuda_device):
    """The shape of a search's coarse launches: 2 queries x 4 phases of
    strided rows against the strided library, range 64 (one word compared),
    ragged counts."""
    from lbaudiodetective_torch.ops.match_packed import phase_strided_query_planes

    q_pos, q_neg, nq, lib_pos, lib_neg, n_lib = ragged_case(33, 100, l=300, s=80)
    qp = np.stack([q_pos, np.roll(q_pos, 3, axis=0)])
    qn = np.stack([q_neg, np.roll(q_neg, 3, axis=0)])
    qcp, qcn, nc = phase_strided_query_planes(qp, qn, np.array([nq, nq]), 4)
    qcpw = _words(qcp.reshape(8, *qcp.shape[2:]), cuda_device)
    qcnw = _words(qcn.reshape(8, *qcn.shape[2:]), cuda_device)
    nc = torch.from_numpy(nc.reshape(8)).to(cuda_device)
    lp, ln = _words(lib_pos[:, ::4], cuda_device), _words(lib_neg[:, ::4], cuda_device)
    nl = torch.from_numpy(-(-n_lib // 4)).to(cuda_device)
    m = _mask_pairs(100, 64, 200)
    got = match_one_vs_many_fused(qcpw, qcnw, nc, lp, ln, nl, m)
    exp = match_one_vs_many_fused_plain(qcpw, qcnw, nc, lp, ln, nl, m)
    assert got.shape == (8, 300)
    assert float((got - exp).abs().max()) <= 1e-6


def test_match_kernel_refuses_too_long_entries(cuda_device):
    words = torch.zeros((1, 4000, 4), dtype=torch.int32, device=cuda_device)
    n = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        match_one_vs_many_fused(words, words, n, words, words, n, 100)


def test_cuda_library_search_equals_match_and_cpu(cuda_device):
    from lbaudiodetective_torch.models.fingerprint import Fingerprint
    from lbaudiodetective_torch.models.library import FingerprintLibrary

    _, _, _, lib_pos, lib_neg, n_lib = ragged_case(32, 100, l=600, nq=40)
    fps = [Fingerprint(p[:n], q[:n]) for p, q, n in zip(lib_pos, lib_neg, n_lib)]
    gpu = FingerprintLibrary.from_fingerprints(fps, device=cuda_device)
    cpu = FingerprintLibrary.from_fingerprints(fps)
    query = Fingerprint(lib_pos[9][2:n_lib[9]], lib_neg[9][2:n_lib[9]])
    kernels.reset_launch_counts()
    brute = gpu.match(query)
    idx, scores = gpu.search(query, top_k=3, shortlist=64)
    assert kernels.launch_counts()["match_one_vs_many_fused"] == 3
    assert idx[0] == int(np.argmax(brute)) == 9
    np.testing.assert_array_equal(scores, brute[idx])
    np.testing.assert_allclose(brute, cpu.match(query), rtol=0, atol=1e-6)
    cidx, cscores = cpu.search(query, top_k=3, shortlist=64)
    np.testing.assert_array_equal(idx, cidx)
    np.testing.assert_allclose(scores, cscores, rtol=0, atol=1e-6)
