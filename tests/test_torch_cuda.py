"""Tests of the port's CUDA kernels: they need an NVIDIA GPU and skip
without one.  This file imports no JAX (the card's host has none), so it
runs there on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Each kernel is held to its plain version on the same tensors on the card;
the tolerance of the rows kernel is the reference's (rtol 5e-4, atol
3e-6 * max|coeff|: f32 summation order differs)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_tpu.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.ops import kernels  # noqa: E402
from lbaudiodetective_torch.ops.constants import constants_to_tensors  # noqa: E402
from lbaudiodetective_torch.ops.extract import required_padded_length  # noqa: E402
from lbaudiodetective_torch.ops.kernels.fused_rows import (  # noqa: E402
    fused_band_rows, fused_band_rows_plain, rows_arrays)
from lbaudiodetective_torch.ops.kernels.select_signs import (  # noqa: E402
    select_sign_classes, select_sign_classes_plain)
from tests._torch_common import (  # noqa: E402,F401
    bit_agreement, brown_noise, cuda_device, numpy_select, select_cases, synth_clip)

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
    assert counts == {"select_sign_classes": 1, "fused_band_rows": 2}
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
