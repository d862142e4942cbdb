"""The port's NumPy constant builders are bit-equal to the JAX package's, and
the port gives identical output with either set of arrays."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_tpu.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.ops import constants as port  # noqa: E402
from tests._torch_common import synth_clip  # noqa: E402

CONFIGS = {"parity": FingerprintConfig(), "proc": FingerprintConfig(hop_domain="proc")}


def _jax_builders(cfg):
    from lbaudiodetective_tpu.ops import dft, haar, spectral
    from lbaudiodetective_tpu.ops.pallas import fused_rows, fused_rows_v2

    ranges = cfg.band_bin_ranges
    lo, hi = int(ranges[:, 0].min()), int(ranges[:, 1].max())
    return {
        "haar128": haar.haar_matrix(128), "haar32": haar.haar_matrix(32),
        "dft": dft._dft_constants(cfg.window_size, lo, hi),
        "proj": spectral.band_projection_matrix(cfg),
        "kernel": fused_rows._kernel_constants(cfg),
        "v2": fused_rows_v2._v2_constants(cfg, False),
        "v2_haar": fused_rows_v2._v2_constants(cfg, True),
        "conv": spectral._conv_constants(cfg),
        "interior": spectral.bands_in_interior(cfg),
    }


def _port_builders(cfg):
    ranges = cfg.band_bin_ranges
    lo, hi = int(ranges[:, 0].min()), int(ranges[:, 1].max())
    return {
        "haar128": port.haar_matrix(128), "haar32": port.haar_matrix(32),
        "dft": port.dft_constants(cfg.window_size, lo, hi),
        "proj": port.band_projection_matrix(cfg),
        "kernel": port.kernel_constants(cfg),
        "v2": port.v2_constants(cfg, False),
        "v2_haar": port.v2_constants(cfg, True),
        "conv": port.conv_constants(cfg),
        "interior": port.bands_in_interior(cfg),
    }


def _assert_bit_equal(a, b, name):
    if isinstance(a, tuple):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bit_equal(x, y, f"{name}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    else:
        assert a == b, name


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_builders_bit_equal_to_jax(cfg_name):
    cfg = CONFIGS[cfg_name]
    jax_arrays, port_arrays = _jax_builders(cfg), _port_builders(cfg)
    for name in jax_arrays:
        _assert_bit_equal(jax_arrays[name], port_arrays[name], name)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_jax_built_constants_give_identical_output(cfg_name):
    """The extractor's buffers may come from the JAX package's builders
    through constants_to_tensors: same fingerprints, bit for bit."""
    from lbaudiodetective_tpu.ops import haar, spectral
    from lbaudiodetective_tpu.ops.pallas import fused_rows_v2
    from lbaudiodetective_torch.ops.extract import FingerprintExtractor
    from lbaudiodetective_torch.ops.kernels.fused_rows import rows_arrays

    cfg = CONFIGS[cfg_name]
    c16, s16, t2a, _, proj_r, _, perm, h_cols_t = fused_rows_v2._v2_constants(cfg, True)
    w1, w2, proj_perm, _ = spectral._conv_constants(cfg)
    jax_arrays = {"c16": c16, "s16": s16, "t2a": t2a, "proj_r": proj_r, "perm": perm,
                  "h_cols_t": h_cols_t, "conv_w1": w1, "conv_w2": w2,
                  "proj_perm": proj_perm, "h_rows": haar.haar_matrix(128),
                  "h_cols": haar.haar_matrix(32)}
    assert sorted(jax_arrays) == sorted(rows_arrays(cfg))
    tensors = port.constants_to_tensors(jax_arrays, "cpu")
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in tensors.values())

    own = FingerprintExtractor(cfg, "cpu")
    from_jax = FingerprintExtractor(cfg, "cpu", arrays=jax_arrays)
    assert own.impl == from_jax.impl == "fused_v3"
    n_sub = 8
    n_rows = n_sub * cfg.rows_per_frame
    from lbaudiodetective_torch.ops.extract import required_padded_length

    clip = synth_clip(11, 30.0, cfg).samples
    audio = np.zeros((2, required_padded_length(cfg, n_rows)), np.float32)
    t = min(len(clip), audio.shape[1])
    audio[0, :t] = clip[:t]
    audio[1, :t] = -clip[:t]
    x = torch.from_numpy(audio)
    n_valid = torch.tensor([n_sub, n_sub - 1])
    for a, b in zip(own(x, n_valid, n_rows), from_jax(x, n_valid, n_rows)):
        assert torch.equal(a, b)
