"""Tests of the port's CUDA kernels: they need an NVIDIA GPU and skip
without one.  This file imports no JAX (the card's host has none), so it
runs there on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Each kernel is held to its plain version on the same tensors on the card;
the tolerance of the rows kernel is the reference's (rtol 5e-4, atol
3e-6 * max|coeff|: f32 summation order differs); the match kernel's is
1e-6 (both add the diagonal terms in the same order, so they agree to the
last bit unless the compiler reorders)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_tpu.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.ops import kernels  # noqa: E402
from lbaudiodetective_torch.ops.constants import constants_to_tensors  # noqa: E402
from lbaudiodetective_torch.ops.extract import required_padded_length  # noqa: E402
from lbaudiodetective_torch.ops.kernels.fused_rows import (  # noqa: E402
    fused_band_rows, fused_band_rows_plain, rows_arrays)
from lbaudiodetective_torch.ops.kernels.match_packed import (  # noqa: E402
    match_one_vs_many_fused, match_one_vs_many_fused_plain)
from lbaudiodetective_torch.ops.kernels.select_signs import (  # noqa: E402
    select_sign_classes, select_sign_classes_plain)
from lbaudiodetective_torch.ops.match_packed import _mask_pairs, pack_bits_device  # noqa: E402
from tests._torch_common import (  # noqa: E402,F401
    bit_agreement, brown_noise, cuda_device, numpy_select, ragged_case, select_cases,
    synth_clip)

pytestmark = pytest.mark.cuda
CASES = select_cases()
HOPS = {8: dict(), 64: dict(hop_domain="proc"),
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
    exp = fused_band_rows_plain(x, cfg, n_rows, consts, emit="coeffs").cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), exp, rtol=5e-4,
                               atol=3e-6 * float(np.abs(exp).max()))
    assert torch.equal(cls, select_sign_classes(got.reshape(-1, 4096)).reshape(cls.shape))
    assert torch.equal(got, fused_band_rows(x, cfg, n_rows, consts, emit="coeffs"))


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
                      "match_one_vs_many_fused": 0}
    refs = [cpu.process_decoded(long_clip), cpu.process_decoded(short_clip)]
    for f, r in zip(fps, refs):
        assert f.num_subfingerprints == r.num_subfingerprints
        assert bit_agreement(f.pos, f.neg, r.pos, r.neg) >= 0.999
    lib = refs + [cpu.process_decoded(synth_clip(72, 3.0, cfg))]
    np.testing.assert_allclose(gpu.match_against_library(refs[0], lib),
                               cpu.match_against_library(refs[0], lib), rtol=0, atol=1e-6)


def test_unported_config_raises_on_cuda(cuda_device):
    from lbaudiodetective_torch.ops.extract import extract_fingerprint

    cfg = FingerprintConfig(integer_hop=False)
    with pytest.raises(NotImplementedError, match="fused_band_rows"):
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
    from lbaudiodetective_tpu.models.fingerprint import Fingerprint
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
