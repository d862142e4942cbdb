"""Tests of the port's CUDA kernels: they need an NVIDIA GPU and skip
without one.  This file imports no JAX (the card's host has none), so it
runs there on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Each kernel is held to its plain version on the same tensors on the card.
The rows kernels (fused rows, band rows) run stage 2 in 3xTF32 and are held
to the plain version evaluated in float64, within the reference's tolerance
(rtol 5e-4, atol 3e-6 * max|coeff|: f32 summation order differs).  The match
kernel is held bit-equal (``torch.equal``): both add the diagonal terms in
the same order with the same rounding."""

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
    match_packed_layout, non_finite_audio, numpy_select, ragged_case, select_cases,
    sign_planes, synth_clip)

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
    # name: (config kwargs, coefficients)
    "rows_oracle_mode": (dict(integer_hop=False), False),
    "rows_rate_8000": (dict(processing_sample_rate=8000.0, integer_hop=False), False),
    "rows_pitch_16": (dict(pitch_step_count=16, integer_hop=False), False),
    "rows_rows_256": (dict(rows_per_frame=256, integer_hop=False), False),
    "rows_hop_512_split": (dict(hop_domain="proc", analysis_stride=512), False),
    "v2_rows": (dict(), False),
    "v2_coeffs": (dict(), True),
    "v3_pitch_16": (dict(pitch_step_count=16), True),
    "v3_rows_256": (dict(rows_per_frame=256), True),
    "v3_length_300": (dict(subfingerprint_length=300), True),
}


@pytest.mark.parametrize("case", sorted(BAND_ROWS_CASES))
def test_band_rows_kernel_matches_plain(case, cuda_device):
    """Rows mode (kernel 5, and 4 without fuse_haar) and coefficients mode
    (kernel 2 at other geometries, and 4 with fuse_haar) against the plain
    version on the same tensors; hop 512 splits 128 windows into sub-tiles
    of 64.  Two runs are bit-identical."""
    kw, coeffs = BAND_ROWS_CASES[case]
    cfg = FingerprintConfig(**kw)
    n_rows = 4 * cfg.rows_per_frame
    x = torch.from_numpy(brown_noise(52, 3, required_padded_length(cfg, n_rows))).to(cuda_device)
    before = band_rows.band_rows.launches
    got = band_rows.band_rows(x, cfg, n_rows, coeffs)
    again = band_rows.band_rows(x, cfg, n_rows, coeffs)
    torch.cuda.synchronize()
    assert band_rows.band_rows.launches == before + 2
    assert got.shape == (3, n_rows, cfg.pitch_step_count) and torch.equal(got, again)
    exp = band_rows.band_rows_plain(x.double(), cfg, n_rows, coeffs).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), exp, rtol=5e-4,
                               atol=3e-6 * float(np.abs(exp).max()))


@pytest.mark.parametrize("case", ["rows_oracle_mode", "rows_hop_512_split", "v2_rows",
                                  "v3_pitch_16", "v3_rows_256"])
def test_band_rows_kernel_with_non_finite_samples_matches_plain(case, cuda_device):
    """NaN at the first sample of clip 0's second sub-tile (the sample the
    kernel takes the sub-tile's level from) and +inf at clip 1's first
    sample zero only the windows that hold them, as in the plain version
    (whose non-finite handling tests/test_torch_band_rows.py holds to the
    JAX package)."""
    kw, coeffs = BAND_ROWS_CASES[case]
    cfg = FingerprintConfig(**kw)
    n_rows = 4 * cfg.rows_per_frame
    audio = brown_noise(54, 2, required_padded_length(cfg, n_rows))
    sub = band_rows._device_plan(cfg, n_rows, coeffs, str(cuda_device))["sub"]
    audio[0, cfg.row_starts(n_rows)[sub]] = np.nan
    audio[1, 0] = np.inf
    x = torch.from_numpy(audio).to(cuda_device)
    got = band_rows.band_rows(x, cfg, n_rows, coeffs).cpu().numpy()
    exp = band_rows.band_rows_plain(x.double(), cfg, n_rows, coeffs).cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, exp, rtol=5e-4, atol=3e-6 * float(np.abs(exp).max()))


def test_band_rows_kernel_runs_passes_of_48_slots(cuda_device):
    """No config reaches k_max > 48 (the top bin is 759 at window 2048), so
    the kernel is fed the oracle-mode config's slots spread to every second
    slot of 86 (k_max 43 -> 86: two passes of 48, the second ragged) with the
    projection's rows moved with them: the rows are unchanged."""
    from lbaudiodetective_torch.ops import constants

    cfg = FingerprintConfig(integer_hop=False)
    c16, s16, t_re, t_im, proj_perm, k_max = constants.kernel_constants(cfg)
    spread = 2 * k_max
    t2 = np.zeros((2, 16, 128, spread), np.float32)
    t2[0, :, :, ::2], t2[1, :, :, ::2] = t_re, t_im
    proj = np.zeros((16, spread, cfg.pitch_step_count), np.float32)
    proj[:, ::2] = proj_perm.reshape(16, k_max, -1)
    consts = constants.constants_to_tensors(
        {"c16": c16, "s16": s16, "t2_frag": constants.stage2_fragments(t2[0], t2[1]),
         "proj_pass": constants.projection_passes(proj.reshape(16 * spread, -1), spread)},
        cuda_device)
    assert consts["t2_frag"].shape[1] == 2
    n_rows = 4 * cfg.rows_per_frame
    x = torch.from_numpy(brown_noise(55, 2, required_padded_length(cfg, n_rows))).to(cuda_device)
    before = band_rows.band_rows.launches
    got = band_rows.launch(x, cfg, n_rows, False, consts, spread).cpu().numpy()
    assert band_rows.band_rows.launches == before + 1
    exp = band_rows.band_rows_plain(x.double(), cfg, n_rows).cpu().numpy()
    np.testing.assert_allclose(got, exp, rtol=5e-4, atol=3e-6 * float(np.abs(exp).max()))


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
    kernel extract on CUDA through it: as many subfingerprints as on the
    CPU, and >= 99.9 % of bits against the NumPy oracle, the reference's bar.
    (The CPU path's own float32 rounding is 99.87 % from the oracle on clip
    0 at subfingerprint_length=300, where 150 of 4096 coefficients are
    kept; the kernel is held to the plain version in float64, which equals
    the oracle there.)"""
    from lbaudiodetective_torch.models.detective import AudioDetective
    from lbaudiodetective_torch.oracle.pipeline import oracle_fingerprint

    cfg = FingerprintConfig(**kw)
    clips = [synth_clip(74 + i, 4.0, cfg) for i in range(2)]
    kernels.reset_launch_counts()
    fps = AudioDetective(cfg, device=cuda_device).process_decoded_batch(clips)
    counts = kernels.launch_counts()
    assert counts["band_rows"] == 1
    refs = AudioDetective(cfg, device="cpu").process_decoded_batch(clips)
    for clip, f, r in zip(clips, fps, refs):
        assert f.num_subfingerprints == r.num_subfingerprints > 0
        assert bit_agreement(f.pos, f.neg, *oracle_fingerprint(clip, cfg)) >= 0.999


def test_cuda_extraction_runs_kernels_and_equals_cpu(cuda_device):
    from lbaudiodetective_torch.models.detective import AudioDetective

    cfg = FingerprintConfig()
    gpu, cpu = AudioDetective(cfg, device=cuda_device), AudioDetective(cfg, device="cpu")
    long_clip, short_clip = synth_clip(70, 4.0, cfg), synth_clip(71, 1.5, cfg)
    # Each clip, the 1.5 s one of a single 8-subfingerprint tile included,
    # is one launch of the fused rows kernel, which selects in place.
    fps = []
    for clip in (long_clip, short_clip):
        kernels.reset_launch_counts()
        fps.append(gpu.process_decoded(clip))
        assert kernels.launch_counts() == {"select_sign_classes": 0, "fused_band_rows": 1,
                                           "match_one_vs_many_fused": 0, "band_rows": 0,
                                           "slot_fold": 0}
    refs = [cpu.process_decoded(long_clip), cpu.process_decoded(short_clip)]
    for f, r in zip(fps, refs):
        assert f.num_subfingerprints == r.num_subfingerprints
        assert bit_agreement(f.pos, f.neg, r.pos, r.neg) >= 0.999
    lib = refs + [cpu.process_decoded(synth_clip(72, 3.0, cfg))]
    np.testing.assert_allclose(gpu.match_against_library(refs[0], lib),
                               cpu.match_against_library(refs[0], lib), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def enroll_clips():
    """256 decoded 10 s clips: the [256, 7168 rows] batch of enrollment."""
    from lbaudiodetective_torch.io.decode import DecodedAudio

    cfg = FingerprintConfig()
    n = int(10 * cfg.processing_sample_rate)
    return [DecodedAudio(x, cfg.processing_sample_rate, int(10 * cfg.file_sample_rate),
                         cfg.file_sample_rate) for x in brown_noise(81, 256, n)]


def test_chunked_extraction_equals_one_launch(cuda_device, enroll_clips, monkeypatch):
    """At [256, 7168 rows] the batch goes in whole-wave chunks and gives the
    bits of one launch of the rows kernel over the whole batch; the chunks
    were padded into page-locked staging."""
    from lbaudiodetective_torch.ops import extract

    cfg = FingerprintConfig()
    step = extract._wave_clips("fused_rows", 56, cuda_device)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert step * 56 % n_sm == 0 and len(extract.chunk_bounds(256, step)) > 1
    kernels.reset_launch_counts()
    chunked = extract.extract_fingerprint_batch(enroll_clips, cfg, device=cuda_device)
    assert kernels.launch_counts()["fused_band_rows"] == len(extract.chunk_bounds(256, step))
    monkeypatch.setattr(extract, "_wave_clips", lambda route, n_tiles, device: 0)
    kernels.reset_launch_counts()
    single = extract.extract_fingerprint_batch(enroll_clips, cfg, device=cuda_device)
    assert kernels.launch_counts()["fused_band_rows"] == 1
    assert chunked[0].shape == (256, 56, 100) and chunked[0].any()
    for a, b in zip(chunked, single):
        np.testing.assert_array_equal(a, b)
    rings = extract.get_extractor(cfg, str(cuda_device))._rings
    slots = [t for ring in rings for t in ring.slots if t is not None]
    assert slots and all(t.is_pinned() for t in slots)


def test_chunk_launch_does_not_wait_for_the_kernel(cuda_device, enroll_clips):
    """Inside ``recording()`` the first chunk's ``extract.launch`` closes
    before the batch's ``extract.d2h`` opens, within 5 ms: queuing a chunk
    waits for no kernel; the copy back waits for them all."""
    from lbaudiodetective_torch.ops.extract import extract_fingerprint_batch
    from lbaudiodetective_torch.utils import profiling

    cfg = FingerprintConfig()
    extract_fingerprint_batch(enroll_clips, cfg, device=cuda_device)     # builds the kernels
    torch.cuda.synchronize()
    with profiling.recording() as rec:
        extract_fingerprint_batch(enroll_clips, cfg, device=cuda_device)
    launch = next(s for s in rec.spans if s.name == "extract.launch" and s.attrs["chunk"] == 0)
    d2h = next(s for s in rec.spans if s.name == "extract.d2h")
    assert launch.attrs["chunks"] > 1
    assert launch.end_ns <= d2h.start_ns
    assert launch.end_ns - launch.start_ns < 5_000_000
    h2d = [s.attrs for s in rec.spans if s.name == "extract.h2d"]
    assert len(h2d) == launch.attrs["chunks"] and all(a["pinned"] for a in h2d)


def test_unported_config_raises_on_cuda(cuda_device):
    """No config the reference runs on its accelerator is refused any more:
    the fractional hop extracts through the band-rows kernel.  The one the
    reference's kernel refuses (window 1024, fractional hop) raises
    ValueError, as it does there."""
    from lbaudiodetective_torch.ops.extract import extract_fingerprint

    cfg = FingerprintConfig(integer_hop=False)
    clip = synth_clip(73, 2.0, cfg)
    before = band_rows.band_rows.launches
    pos, neg, n = extract_fingerprint(clip, cfg, device=cuda_device)
    assert band_rows.band_rows.launches == before + 1
    cpos, cneg, cn = extract_fingerprint(clip, cfg, device="cpu")
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
    assert torch.equal(got, exp)
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
    assert torch.equal(got, exp)


def _ragged_words(seed: int, n: int, s: int, dev, lo: int = 1, pairs: int = 100):
    """``[n, s, W]`` packed words with counts in [lo, s], planes zero past
    each count."""
    rng = np.random.default_rng(seed)
    cls = rng.choice(3, size=(n, s, pairs))
    counts = rng.integers(lo, s + 1, size=n).astype(np.int32)
    cls[np.arange(s)[None, :] >= counts[:, None]] = 0
    return _words(cls == 1, dev), _words(cls == 2, dev), torch.from_numpy(counts).to(dev)


MATCH_SHAPES = {
    # name: (queries, query rows, entries, entry rows, comparison range)
    "coarse_32_query_rows": (32, 20, 1000, 20, 64),      # search_many's coarse pass at B=8
    "query_groups": (64, 64, 300, 64, 0),                 # more rows than one CTA holds
    "one_entry": (3, 40, 1, 80, 0),
    "ragged_last_chunk": (2, 40, 37, 80, 37),             # L not a multiple of the chunk
    "more_than_32_offsets": (2, 20, 64, 80, 0),           # 61 offsets against 20 rows
    "long_queries": (2, 80, 200, 40, 100),                # orientation B, 41 offsets
}


@pytest.mark.parametrize("case", sorted(MATCH_SHAPES))
def test_match_kernel_bit_equal_at_launch_shapes(case, cuda_device):
    """The match kernel bit-equal to its plain version at the shapes its
    launch plan splits differently: many query rows, query groups, a
    one-entry library, a ragged last chunk, entries of 0 rows, more offsets
    than a warp has lanes."""
    b, sq, l, sl, comparison_range = MATCH_SHAPES[case]
    qp, qn, nq = _ragged_words(40, b, sq, cuda_device)
    lp, ln, nl = _ragged_words(41, l, sl, cuda_device)
    if l > 3:
        nl[1:3] = 0                                     # entries of 0 rows
        lp[1:3], ln[1:3] = 0, 0
    m = _mask_pairs(100, comparison_range, 200)
    if case == "query_groups":
        from lbaudiodetective_torch.ops.kernels._build import load_library
        from lbaudiodetective_torch.ops.kernels.match_packed import launch_plan

        bg, _, _ = launch_plan(load_library().lbad_match_packed_smem_bytes, b, sq, sl, 4)
        assert bg < b
    got = match_one_vs_many_fused(qp, qn, nq, lp, ln, nl, m)
    exp = match_one_vs_many_fused_plain(qp, qn, nq, lp, ln, nl, m)
    assert got.shape == (b, l) and torch.equal(got, exp)
    assert torch.equal(got, match_one_vs_many_fused(qp, qn, nq, lp, ln, nl, m))


@pytest.mark.parametrize("overlap", ["entries", "queries", "both"])
def test_match_kernel_bit_equal_with_overlapping_planes(overlap, cuda_device):
    """Rows with a pair set in both planes (no fingerprint has one, but the
    words may hold them): the kernel counts each plane's hits on its own
    where both sides hold such rows, and stays bit-equal to the plain
    version in every case."""
    rng = np.random.default_rng(42)
    qp, qn, nq = _ragged_words(43, 3, 40, cuda_device)
    lp, ln, nl = _ragged_words(44, 200, 80, cuda_device)
    if overlap in ("entries", "both"):
        extra = torch.from_numpy(rng.integers(0, 2**31, size=(100, 80, 4), dtype=np.int64)
                                 .astype(np.int32)).to(cuda_device)
        ln[:100] |= lp[:100] & extra                   # bits in both planes
    if overlap in ("queries", "both"):
        qn |= qp
    m = _mask_pairs(100, 0, 200)
    got = match_one_vs_many_fused(qp, qn, nq, lp, ln, nl, m)
    assert torch.equal(got, match_one_vs_many_fused_plain(qp, qn, nq, lp, ln, nl, m))


def test_match_packed_layout_is_the_kernels(cuda_device):
    """The layout the CPU test of the launch plan uses is the kernel's."""
    from lbaudiodetective_torch.ops.kernels._build import load_library

    lib = load_library()
    for args in ((1, 80, 16, 80, 4), (32, 20, 16, 20, 4), (7, 33, 5, 31, 3), (1, 4000, 1, 4000, 4)):
        assert lib.lbad_match_packed_smem_bytes(*args) == match_packed_layout(*args), args


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
    cpu = FingerprintLibrary.from_fingerprints(fps, device="cpu")
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


def test_incremental_matcher_on_card_equals_match_many(cuda_device):
    """Running diagonal sums on the card, slot-batched and lockstep, bit-equal
    to the match kernel (``FingerprintLibrary.match_many``) on the
    accumulated fingerprints after every post."""
    from lbaudiodetective_torch.models.fingerprint import Fingerprint
    from lbaudiodetective_torch.models.library import FingerprintLibrary
    from lbaudiodetective_torch.streaming.incremental import (
        IncrementalLibraryMatcher, StreamSessionPool)

    _, _, _, lib_pos, lib_neg, n_lib = ragged_case(33, 100, l=300, nq=40)
    fps = [Fingerprint(p[:n], q[:n]) for p, q, n in zip(lib_pos, lib_neg, n_lib)]
    lib = FingerprintLibrary.from_fingerprints(fps, device=cuda_device)
    sp, sn = sign_planes(np.random.default_rng(5), (3, 48, 100))
    sp[0, 4:4 + n_lib[7]], sn[0, 4:4 + n_lib[7]] = lib_pos[7, :n_lib[7]], lib_neg[7, :n_lib[7]]
    streams = [Fingerprint(sp[i], sn[i]) for i in range(3)]
    inc = IncrementalLibraryMatcher(lib, batch=3, n_cap=8, stream_group=1, device=cuda_device)
    pool = StreamSessionPool(lib, slots=3, n_cap=8, device=cuda_device)
    for i in range(3):
        pool.open(str(i))
    n = 0
    for k in (5, 1, 8, 13, 21):
        n_new = min(n + k, 48)
        planes = [sp[:, n:n_new], sn[:, n:n_new]]
        inc.update(*planes)
        for i in range(3):
            pool.post(str(i), planes[0][i], planes[1][i])
        pool.flush()
        n = n_new
        want = lib.match_many([Fingerprint(f.pos[:n], f.neg[:n]) for f in streams])
        np.testing.assert_array_equal(inc.scores(), want)
        np.testing.assert_array_equal(pool._m.scores_slots(pool._age), want)
        sc, ix = inc.top_k(2)
        np.testing.assert_array_equal(ix, np.argsort(-want, axis=1, kind="stable")[:, :2])


def test_streaming_identifier_full_mode_launches_the_match_kernel(cuda_device):
    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch.io.decode import DecodedAudio
    from lbaudiodetective_torch.models.library import FingerprintLibrary
    from lbaudiodetective_torch.models.detective import AudioDetective
    from lbaudiodetective_torch.streaming import StreamingIdentifier

    cfg = FingerprintConfig()
    audio = brown_noise(12, 6, 3 * 5512)
    clips = [DecodedAudio(a, 5512.0, 3 * 44100, 44100.0) for a in audio]
    lib = FingerprintLibrary.from_fingerprints(
        AudioDetective(cfg, device=cuda_device).process_decoded_batch(clips), cfg,
        device=cuda_device)
    results = {}
    for mode in ("full", "incremental"):
        ident = StreamingIdentifier(lib, 2, 1024, cfg, rematch=mode, device=cuda_device)
        kernels.reset_launch_counts()
        for s in range(audio.shape[1] // 1024):
            ident.feed(audio[[3, 1], s * 1024:(s + 1) * 1024])
        results[mode] = [(m.track, m.score) for m in ident.finalize()]
        counts = kernels.launch_counts()
        assert counts["fused_band_rows"] > 0
        assert (counts["match_one_vs_many_fused"] > 0) == (mode == "full")
    assert results["full"] == results["incremental"]
    assert [t for t, _ in results["full"]] == [3, 1]


def test_sharded_match_and_ring_on_four_slots_of_one_card(cuda_device, monkeypatch):
    """The library-sharded match, ring all-pairs and ring dedup on a mesh of
    four slots of one card: bit-equal to one slot (one launch a slot for
    the match; n launches a slot for the ring, every visiting block split
    into launches of at most MAX_QUERIES queries)."""
    from lbaudiodetective_torch.parallel import sharded_packed as sp
    from lbaudiodetective_torch.parallel.mesh import make_mesh, unshard

    lp, ln, nl = _ragged_words(45, 203, 40, cuda_device)          # 203: pads to 204
    lp[5:9], ln[5:9] = lp[0], ln[0]                               # duplicates: ties
    nl[5:9] = nl[0]
    one, four = (make_mesh(devices=[cuda_device] * n, library_parallelism=n) for n in (1, 4))
    args = (lp, ln, nl, 100)
    kernels.reset_launch_counts()
    got = sp.match_library_sharded_packed(lp[3], ln[3], nl[3], *args, four)
    assert kernels.launch_counts()["match_one_vs_many_fused"] == 4
    assert [tuple(s.shape) for s in got] == [(51,)] * 4
    ref = sp.match_library_sharded_packed(lp[3], ln[3], nl[3], *args, one)
    assert torch.equal(unshard(got)[:203], ref[0][:203])
    ring = unshard(sp.ring_all_pairs_scores_packed(*args, four))
    ring_one = unshard(sp.ring_all_pairs_scores_packed(*args, one))
    assert torch.equal(ring[:203, :203], ring_one[:203, :203])
    monkeypatch.setattr(sp, "MAX_QUERIES", 16)                     # split the visiting blocks
    assert torch.equal(unshard(sp.ring_all_pairs_scores_packed(*args, four)), ring)
    dd = [unshard(x) for x in sp.ring_dedup_topk_packed(*args, four, k=5)]
    dd_one = [unshard(x) for x in sp.ring_dedup_topk_packed(*args, one, k=5)]
    assert torch.equal(dd[0][:203], dd_one[0][:203])              # the top-5 scores
    full = ring.clone()
    full.fill_diagonal_(-torch.inf)
    want_s, want_i = _ring_order_top_k(full, 4, 5)
    assert torch.equal(dd[0], want_s) and torch.equal(dd[1], want_i)


def _ring_order_top_k(full: torch.Tensor, n: int, k: int):
    """Each row's top-k of an all-pairs plane in a ring's candidate order:
    slot d meets the blocks of slots d, d - 1, ... (mod n) in turn, so an
    equal score goes to the earlier block, then to the lower index, as a
    stable fold of ``[best | block]`` (``lax.top_k``) keeps it."""
    l = full.shape[0] // n
    scores, idx = [], []
    for d in range(n):
        perm = torch.cat([torch.arange(((d - s) % n) * l, ((d - s) % n + 1) * l)
                          for s in range(n)]).to(full.device)
        block = full[d * l:(d + 1) * l][:, perm]
        order = torch.sort(block, dim=1, descending=True, stable=True).indices[:, :k]
        scores.append(torch.gather(block, 1, order))
        idx.append(perm[order])
    return torch.cat(scores), torch.cat(idx)


def _card_words(gen, shape, dev, overlap_every: int = 0):
    """Random int32 (pos, neg) words on the card: disjoint planes, except
    that every ``overlap_every``-th row along the first axis also sets
    some pairs in both."""
    pos = torch.randint(-2**31, 2**31, shape, generator=gen, device=dev, dtype=torch.int64)
    neg = torch.randint(-2**31, 2**31, shape, generator=gen, device=dev, dtype=torch.int64)
    pos, neg = pos.to(torch.int32), neg.to(torch.int32)
    neg = neg & ~pos
    if overlap_every:
        extra = torch.randint(-2**31, 2**31, shape, generator=gen, device=dev,
                              dtype=torch.int64).to(torch.int32)
        neg[::overlap_every] |= pos[::overlap_every] & extra[::overlap_every]
    return pos, neg


#: name: rows a posting slot folds, one entry a slot (64 slots cycle the list)
FOLD_CASES = {"1_slot_k1": [1], "1_slot_k8": [8], "2_slots_k3_k8": [3, 8],
              "2_slots_k13_k5": [13, 5], "64_slots_k1_to_8": list(range(1, 9)),
              "64_slots_k8": [8]}


@pytest.fixture(scope="module")
def cell_pool_matcher():
    """A 64-slot matcher on the live cell's geometry: 65,536 entries of
    31-80 rows, W 4 (100 pairs; words past the pairs and rows past a count
    hold junk), every seventh entry with pairs set in both planes."""
    from lbaudiodetective_torch.models.library import FingerprintLibrary
    from lbaudiodetective_torch.streaming.incremental import IncrementalLibraryMatcher

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    lp, ln = _card_words(gen, (65536, 80, 4), dev, overlap_every=7)
    counts = torch.randint(31, 81, (65536,), generator=gen, device=dev).to(torch.int32)
    lib = FingerprintLibrary(lp, ln, counts, 100, FingerprintConfig())
    return IncrementalLibraryMatcher(lib, batch=64, n_cap=256, device=dev), gen


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_slot_fold_kernel_bit_equal_at_the_cell_geometry(case, cuda_device, cell_pool_matcher):
    """The fold kernel equals its plain version bit for bit on the whole
    state, at 1, 2 and 64 posting slots, 1 to 13 rows a slot (two passes of
    the hit tile past 8), ages on both sides of the entries' counts,
    query rows with pairs set in both planes; one launch; the slots that
    did not post keep their state."""
    from lbaudiodetective_torch.ops.kernels.slot_fold import slot_fold, slot_fold_plain

    m, gen = cell_pool_matcher
    sh = m._shards[0]
    ks = FOLD_CASES[case]
    n_post = 64 if case.startswith("64") else len(ks)
    rng = np.random.default_rng(len(case))
    slots = rng.choice(64, n_post, replace=False)
    k = np.array([ks[j % len(ks)] for j in range(n_post)])
    base = rng.integers(0, 256 - k + 1)
    base[: n_post // 2] = rng.integers(0, 48, n_post // 2)        # orientation A still folds
    qp, qn = _card_words(gen, (n_post, int(k.max()), 4), cuda_device, overlap_every=3)
    table = [torch.from_numpy(x.astype(np.int32)).to(cuda_device) for x in (slots, base, k)]
    d_a = torch.rand((64, 65536, 80), generator=gen, device=cuda_device) * 4
    d_b = torch.rand((64, 65536, 256), generator=gen, device=cuda_device) * 4
    ref_a, ref_b = d_a.clone(), d_b.clone()
    args = (sh.pos_words, sh.neg_words, sh.n_lib, sh.inv_lib, sh.mask_pairs, qp, qn, *table)
    before = slot_fold.launches
    slot_fold(d_a, d_b, *args)
    torch.cuda.synchronize()
    assert slot_fold.launches == before + 1
    idle = torch.ones(64, dtype=torch.bool)
    idle[slots] = False
    assert torch.equal(d_a[idle], ref_a[idle]) and torch.equal(d_b[idle], ref_b[idle])
    assert not (torch.equal(d_a[slots], ref_a[slots]) and torch.equal(d_b[slots], ref_b[slots]))
    slot_fold_plain(ref_a, ref_b, *args)
    assert torch.equal(d_a, ref_a)
    assert torch.equal(d_b, ref_b)


def test_pool_flush_launches_the_fold_once_a_shard(cuda_device):
    """A pooled flush on a library of four shards on the card launches the
    fold kernel once a shard, and leaves every slot that did not post as it
    was; its state equals a one-shard pool's."""
    from lbaudiodetective_torch.models.library import FingerprintLibrary
    from lbaudiodetective_torch.parallel.mesh import make_mesh
    from lbaudiodetective_torch.parallel.sharded_library import ShardedFingerprintLibrary
    from lbaudiodetective_torch.streaming.incremental import StreamSessionPool

    lp, ln, nl = _ragged_words(46, 1001, 80, cuda_device, lo=31)
    lib = FingerprintLibrary(lp, ln, nl, 100, FingerprintConfig())
    four = ShardedFingerprintLibrary(lib, make_mesh(devices=[cuda_device] * 4,
                                                    library_parallelism=4))
    pools = [StreamSessionPool(x, slots=16, n_cap=64, device=cuda_device) for x in (lib, four)]
    rng = np.random.default_rng(20)
    streams = [sign_planes(rng, (40, 100)) for _ in range(16)]
    for pool in pools:
        for j in range(16):
            pool.open(str(j))
            pool.post(str(j), streams[j][0][:5 + j], streams[j][1][:5 + j])
        pool.flush()
    for shards, pool in zip((1, 4), pools):
        before = [pool._m.slot_state(s) for s in range(16)]
        for j in (3, 11):
            pool.post(str(j), streams[j][0][20:28], streams[j][1][20:28])
        kernels.reset_launch_counts()
        pool.flush()
        assert kernels.launch_counts()["slot_fold"] == shards
        assert pool.last_flush["slots_folded"] == 2
        for s in range(16):
            same = all(np.array_equal(x, y) for x, y in zip(pool._m.slot_state(s), before[s]))
            assert same == (s not in (pool._slot["3"], pool._slot["11"])), s
    for j in range(16):
        for x, y in zip(*(p._m.slot_state(p._slot[str(j)]) for p in pools)):
            np.testing.assert_array_equal(x[:, :1001], y[:, :1001])


#: name: (words a row, rows an entry's bucket, subfingerprint length)
LONG_FOLD_CASES = {"w4_s4096": (4, 4096, 200), "w5_s4104": (5, 4104, 300)}


@pytest.mark.parametrize("case", sorted(LONG_FOLD_CASES))
def test_slot_fold_kernel_bit_equal_on_long_entries(case, cuda_device):
    """Entries of thousands of rows, which the kernel streams through its
    shared memory in chunks: bit-equal to the plain version on the whole
    state, with ages at the start, the middle and the end of the longest
    entry, counts at a chunk's edges, 1 to 13 rows a slot; one launch."""
    from lbaudiodetective_torch.models.library import FingerprintLibrary
    from lbaudiodetective_torch.ops.kernels.slot_fold import slot_fold, slot_fold_plain
    from lbaudiodetective_torch.streaming.incremental import IncrementalLibraryMatcher

    w, s, length = LONG_FOLD_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(s)
    lp, ln = _card_words(gen, (48, s, w), cuda_device, overlap_every=5)
    counts = torch.randint(1, s + 1, (48,), generator=gen, device=cuda_device).to(torch.int32)
    counts[:5] = torch.tensor([s, s - 1, 128, 129, 135], dtype=torch.int32)
    lib = FingerprintLibrary(lp, ln, counts, length // 2,
                             FingerprintConfig(subfingerprint_length=length))
    sh = IncrementalLibraryMatcher(lib, batch=6, device=cuda_device)._shards[0]
    slots = np.array([4, 0, 5, 2, 1], np.int32)
    base = np.array([0, 127, s // 2, s - 5, s + 3], np.int32)
    k = np.array([13, 8, 9, 8, 1], np.int32)
    qp, qn = _card_words(gen, (5, 13, w), cuda_device, overlap_every=3)
    table = [torch.from_numpy(x).to(cuda_device) for x in (slots, base, k)]
    d_a = torch.rand((6, 48, s), generator=gen, device=cuda_device) * 4
    d_b = torch.rand((6, 48, 2 * s), generator=gen, device=cuda_device) * 4
    ref_a, ref_b = d_a.clone(), d_b.clone()
    args = (sh.pos_words, sh.neg_words, sh.n_lib, sh.inv_lib, sh.mask_pairs, qp, qn, *table)
    before = slot_fold.launches
    slot_fold(d_a, d_b, *args)
    torch.cuda.synchronize()
    assert slot_fold.launches == before + 1
    assert torch.equal(d_a[3], ref_a[3]) and torch.equal(d_b[3], ref_b[3])
    slot_fold_plain(ref_a, ref_b, *args)
    assert torch.equal(d_a, ref_a)
    assert torch.equal(d_b, ref_b)


def test_pool_with_a_long_entry_equals_per_session_matchers(cuda_device):
    """A pool on the card whose library holds one entry of 3,000 rows
    (beside entries of 31-80): every flush launches the fold once, and
    each session's state and scores equal a per-session matcher's lockstep
    update of the same rows, bit for bit, through ages past 128 that grow
    ``n_cap``; the session posting the long entry's rows finds it first."""
    from lbaudiodetective_torch.models.library import FingerprintLibrary
    from lbaudiodetective_torch.streaming.incremental import (
        IncrementalLibraryMatcher, StreamSessionPool)

    rng = np.random.default_rng(3000)
    cls = rng.integers(0, 3, size=(40, 3000, 100), dtype=np.int8)
    counts = rng.integers(31, 81, size=40).astype(np.int32)
    counts[7] = 3000
    cls[np.arange(3000)[None, :] >= counts[:, None]] = 0
    lib = FingerprintLibrary(_words(cls == 1, cuda_device), _words(cls == 2, cuda_device),
                             torch.from_numpy(counts).to(cuda_device), 100, FingerprintConfig())
    pool = StreamSessionPool(lib, slots=4, n_cap=64, device=cuda_device)
    streams = {"a": ((cls[7, 900:1200] == 1).astype(np.uint8),
                     (cls[7, 900:1200] == 2).astype(np.uint8)),
               "b": sign_planes(rng, (300, 100)), "c": sign_planes(rng, (300, 100))}
    refs = {sid: IncrementalLibraryMatcher(lib, batch=1, n_cap=64, device=cuda_device)
            for sid in streams}
    for sid in streams:
        pool.open(sid)
    for flush in ({"a": 50, "b": 8}, {"a": 50, "c": 13}, {"a": 80, "b": 60}, {"a": 8}):
        for sid, n in flush.items():
            a0 = pool.age(sid)
            p, q = (x[a0:a0 + n] for x in streams[sid])
            pool.post(sid, p, q)
            refs[sid].update(p[None], q[None])
        kernels.reset_launch_counts()
        pool.flush()
        assert kernels.launch_counts()["slot_fold"] == 1
        for sid in streams:
            got, want = pool._m.slot_state(pool._slot[sid]), refs[sid].slot_state(0)
            np.testing.assert_array_equal(got[0], want[0], err_msg=sid)
            cap = min(got[1].shape[-1], want[1].shape[-1])
            np.testing.assert_array_equal(got[1][..., :cap], want[1][..., :cap], err_msg=sid)
            np.testing.assert_array_equal(pool.scores_for(sid), refs[sid].scores()[0],
                                          err_msg=sid)
    assert pool.age("a") == 188 and pool._m.n_cap == 256
    assert int(np.argmax(pool.scores_for("a"))) == 7
