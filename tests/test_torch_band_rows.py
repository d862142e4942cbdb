"""The band-rows kernel's plain version (``ops/kernels/band_rows.py::band_rows``
on CPU tensors) vs the JAX package's Pallas kernels in interpret mode, as the
JAX package's own tests run them: ``fused_band_rows`` at fractional hops,
``fused_band_rows_v2`` at hop 8 (rows and Haar coefficients) and
``fused_band_rows_v3`` with ``fuse_haar`` at frame geometries other than
128 x 32.  Tolerance rtol 1e-4, atol 1e-6 * max|ref|, the JAX package's own
bar (tests/test_fused_rows.py): f32 summation order differs between the
formulations.  The CUDA kernel's own test is in tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.ops import constants as port  # noqa: E402
from lbaudiodetective_torch.ops.extract import (  # noqa: E402
    extraction_route, required_padded_length)
from lbaudiodetective_torch.ops.kernels import band_rows  # noqa: E402
from tests._torch_common import (  # noqa: E402
    H100_SMEM_BYTES, band_rows_layout, brown_noise, jax_config)

FRACTIONAL = {
    "oracle_mode": dict(integer_hop=False),
    "rate_8000": dict(processing_sample_rate=8000.0, integer_hop=False),
    "pitch_16": dict(pitch_step_count=16, integer_hop=False),
    "rows_256": dict(rows_per_frame=256, integer_hop=False),
}
GEOMETRIES = {"pitch_16": dict(pitch_step_count=16), "rows_256": dict(rows_per_frame=256)}


def _inputs(kw, seed, frames=2, batch=2):
    cfg = FingerprintConfig(**kw)
    n_rows = frames * cfg.rows_per_frame
    return cfg, n_rows, brown_noise(seed, batch, required_padded_length(cfg, n_rows))


def _assert_close(got, exp):
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-6 * float(np.abs(exp).max()))


@pytest.mark.parametrize("name", sorted(FRACTIONAL))
def test_rows_match_jax_fused_band_rows(name):
    import jax.numpy as jnp

    from lbaudiodetective_tpu.ops.pallas.fused_rows import fused_band_rows as jax_rows

    cfg, n_rows, audio = _inputs(FRACTIONAL[name], 61)
    assert not cfg.has_integer_hop
    got = band_rows.band_rows(torch.from_numpy(audio), cfg, n_rows)
    assert got.shape == (2, n_rows, cfg.pitch_step_count) and got.dtype == torch.float32
    exp = np.asarray(jax_rows(jnp.asarray(audio), jax_config(cfg), n_rows, interpret=True))
    _assert_close(got.numpy(), exp)


@pytest.mark.parametrize("fuse_haar", [False, True])
def test_v2_matches_jax_at_hop_8(fuse_haar):
    import jax.numpy as jnp

    from lbaudiodetective_tpu.ops.pallas.fused_rows_v2 import fused_band_rows_v2 as jax_v2

    cfg, n_rows, audio = _inputs({}, 62)
    assert cfg.hop_in_processing_samples == 8
    got = band_rows.band_rows(torch.from_numpy(audio), cfg, n_rows, coeffs=fuse_haar)
    exp = np.asarray(jax_v2(jnp.asarray(audio), jax_config(cfg), n_rows, interpret=True,
                            fuse_haar=fuse_haar))
    _assert_close(got.numpy(), exp)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_v3_coefficients_match_jax_at_other_geometries(name):
    import jax.numpy as jnp

    from lbaudiodetective_tpu.ops.pallas.fused_rows_v2 import fused_band_rows_v3 as jax_v3

    cfg, n_rows, audio = _inputs(GEOMETRIES[name], 63)
    got = band_rows.band_rows(torch.from_numpy(audio), cfg, n_rows, coeffs=True)
    exp = np.asarray(jax_v3(jnp.asarray(audio), jax_config(cfg), n_rows, interpret=True,
                            fuse_haar=True))
    _assert_close(got.numpy(), exp)


def test_wrappers_raise_where_the_jax_kernels_do():
    """Window 1024 with a fractional hop fails inside the JAX package's
    kernel; the port raises ValueError.  The configs the reference's v3 rule
    refuses (a fractional hop, a hop that does not divide 128, window 1024,
    frames of fewer rows than 128 / hop) do not route to the band-rows
    kernel's coefficients on CUDA."""
    cfg = FingerprintConfig(window_size=1024, integer_hop=False)
    x = torch.zeros((1, 8192))
    with pytest.raises(ValueError, match="window_size == 2048"):
        band_rows.band_rows(x, cfg, 128)
    cuda = torch.device("cuda")
    for kw, route in ((dict(integer_hop=False), "band_rows"),
                      (dict(hop_domain="proc", analysis_stride=96), "conv"),
                      (dict(window_size=1024), "conv"),
                      (dict(rows_per_frame=8), "conv")):
        assert extraction_route(FingerprintConfig(**kw), cuda) == route, kw
    with pytest.raises(ValueError, match="multiple of rows_per_frame"):
        band_rows.band_rows(x, FingerprintConfig(integer_hop=False), 100)


def test_constants_equal_the_jax_arrays():
    """The kernel's constants derive from the JAX package's: its twiddles
    split into TF32 in fragment order, its projection in passes of 48
    slots, its Haar matrices."""
    from lbaudiodetective_tpu.ops import haar
    from lbaudiodetective_tpu.ops.pallas.fused_rows import _kernel_constants

    for kw in (*FRACTIONAL.values(), *GEOMETRIES.values(), {}):
        cfg = FingerprintConfig(**kw)
        c16, s16, t_re, t_im, proj_perm, k_max = _kernel_constants(jax_config(cfg))
        expected = {"c16": c16, "s16": s16, "t2_frag": port.stage2_fragments(t_re, t_im),
                    "proj_pass": port.projection_passes(proj_perm, k_max),
                    "h_rows": haar.haar_matrix(cfg.rows_per_frame),
                    "h_cols_t": haar.haar_matrix(cfg.pitch_step_count).T}
        arrays = band_rows.band_rows_arrays(cfg, haar=True)
        assert sorted(arrays) == sorted(expected)
        for k, a in arrays.items():
            assert a.dtype == expected[k].dtype and np.array_equal(a, expected[k]), k
    assert port.kernel_constants(FingerprintConfig(integer_hop=False))[5] == 43
    rate_8000 = FingerprintConfig(processing_sample_rate=8000.0, integer_hop=False)
    assert port.kernel_constants(rate_8000)[5] == 31


def test_plain_version_in_float64_within_the_bar_of_jax():
    """The plain version runs in float64 on float64 audio (the evaluation
    the CUDA kernel is held to) and stays within the kernel's bar (rtol
    5e-4, atol 3e-6 * max) of the JAX package's fused_band_rows in interpret
    mode at the oracle-mode fractional hop."""
    import jax.numpy as jnp

    from lbaudiodetective_tpu.ops.pallas.fused_rows import fused_band_rows as jax_rows

    cfg, n_rows, audio = _inputs(FRACTIONAL["oracle_mode"], 64)
    got = band_rows.band_rows_plain(torch.from_numpy(audio).double(), cfg, n_rows)
    assert got.dtype == torch.float64 and got.shape == (2, n_rows, cfg.pitch_step_count)
    exp = np.asarray(jax_rows(jnp.asarray(audio), jax_config(cfg), n_rows, interpret=True))
    np.testing.assert_allclose(got.numpy(), exp, rtol=5e-4, atol=3e-6 * float(np.abs(exp).max()))
    coeffs = band_rows.band_rows_plain(torch.from_numpy(audio).double(), cfg, n_rows, True)
    assert coeffs.dtype == torch.float64


def test_tile_plan_splits_large_spans_and_names_the_limit():
    """A sub-tile's audio span must fit in shared memory: 128 windows at the
    parity hop do; at a 512-sample hop the windows split into sub-tiles of
    64; a frame of 4096 x 32 rows cannot fit with even one window.  The
    layout is the kernel's, as on an H100."""
    def plan(cfg, n_rows, coeffs):
        return band_rows.tile_plan(cfg, n_rows, coeffs, band_rows_layout, H100_SMEM_BYTES)

    got = plan(FingerprintConfig(integer_hop=False), 7168, coeffs=False)
    assert got["sub"] == got["tile_rows"] == 128 and got["smem"] <= H100_SMEM_BYTES
    big_hop = FingerprintConfig(hop_domain="proc", analysis_stride=512)
    got = plan(big_hop, 1024, coeffs=False)
    assert got["sub"] == 64 and got["span_pad"] == 63 * 512 + 2048
    got = plan(FingerprintConfig(rows_per_frame=256), 512, coeffs=True)
    assert got["sub"] == 128 and got["tile_rows"] == 256
    with pytest.raises(ValueError, match=f"{H100_SMEM_BYTES} bytes of shared memory"):
        plan(FingerprintConfig(rows_per_frame=4096), 4096, coeffs=True)
