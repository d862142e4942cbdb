"""Band rows + 2-D Haar (+ select) of the port vs the JAX package: the plain
version against the Pallas v3 kernel in interpret mode and against the XLA
conv rows + Haar, at hop 8, 64 and 128.  Tolerance rtol 5e-4, atol
3e-6 * max|coeff|, the reference's own (tests/test_fused_rows.py): f32
summation order differs between the formulations.  The CUDA kernel's own
test is in tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.ops.constants import constants_to_tensors  # noqa: E402
from lbaudiodetective_torch.ops.extract import required_padded_length  # noqa: E402
from lbaudiodetective_torch.ops.kernels.fused_rows import (  # noqa: E402
    fused_band_rows, fused_band_rows_plain, kernel_eligible, rows_arrays)
from lbaudiodetective_torch.ops.kernels.select_signs import (  # noqa: E402
    select_sign_classes_plain)
from tests._torch_common import brown_noise, jax_config, non_finite_audio  # noqa: E402

HOPS = {8: dict(), 64: dict(hop_domain="proc"),
        128: dict(hop_domain="proc", analysis_stride=128)}
N_ROWS = 256


def _inputs(hop, n_rows=N_ROWS, batch=2, seed=51):
    cfg = FingerprintConfig(**HOPS[hop])
    assert int(cfg.hop_in_processing_samples) == hop and kernel_eligible(cfg)
    audio = brown_noise(seed, batch, required_padded_length(cfg, n_rows))
    return cfg, audio, constants_to_tensors(rows_arrays(cfg), "cpu")


def _assert_coeffs_close(got, exp):
    np.testing.assert_allclose(got, exp, rtol=5e-4, atol=3e-6 * float(np.abs(exp).max()))


@pytest.mark.parametrize("hop", sorted(HOPS))
def test_plain_rows_match_jax_v3_and_conv(hop):
    import jax.numpy as jnp

    from lbaudiodetective_tpu.ops import spectral
    from lbaudiodetective_tpu.ops.haar import haar_2d
    from lbaudiodetective_tpu.ops.pallas.fused_rows_v2 import fused_band_rows_v3

    cfg, audio, consts = _inputs(hop)
    got = fused_band_rows(torch.from_numpy(audio), cfg, N_ROWS, consts, emit="coeffs")
    assert got.shape == (2, N_ROWS, 32) and got.dtype == torch.float32
    got = got.numpy()
    jcfg = jax_config(cfg)
    v3 = np.asarray(fused_band_rows_v3(jnp.asarray(audio), jcfg, N_ROWS,
                                       interpret=True, fuse_haar=True))
    _assert_coeffs_close(got, v3)
    rows = spectral.conv_band_rows(jnp.asarray(audio), jcfg, N_ROWS)
    conv = np.asarray(haar_2d(rows.reshape(2, N_ROWS // 128, 128, 32),
                              precision=jcfg.precision)).reshape(2, N_ROWS, 32)
    _assert_coeffs_close(got, conv)


@pytest.mark.parametrize("hop", sorted(HOPS))
def test_plain_rows_with_non_finite_samples_match_jax_v3(hop):
    import jax.numpy as jnp

    from lbaudiodetective_tpu.ops.pallas.fused_rows_v2 import fused_band_rows_v3

    cfg, audio, consts = _inputs(hop, seed=53)
    audio = non_finite_audio(audio, hop)
    got = fused_band_rows(torch.from_numpy(audio), cfg, N_ROWS, consts, emit="coeffs").numpy()
    assert np.isfinite(got).all()
    v3 = np.asarray(fused_band_rows_v3(jnp.asarray(audio), jax_config(cfg), N_ROWS,
                                       interpret=True, fuse_haar=True))
    _assert_coeffs_close(got, v3)
    clean = fused_band_rows(torch.from_numpy(_inputs(hop, seed=53)[1]), cfg, N_ROWS, consts,
                            emit="coeffs").numpy()
    assert not np.allclose(got, clean)


@pytest.mark.parametrize("hop", sorted(HOPS))
def test_plain_classes_agree_with_jax_two_stage(hop):
    """Classes of the port vs the reference's two-stage path (v3 rows, then
    the standalone select), which tests/test_fused_rows.py proves
    element-exact against its pipe_select kernel.  Ties within one ulp of
    f32 may swap, hence 99.9 %."""
    import jax.numpy as jnp

    from lbaudiodetective_tpu.ops.pallas.fused_rows_v2 import fused_band_rows_v3
    from lbaudiodetective_tpu.ops.pallas.select_signs import select_sign_classes as jax_sel

    n_rows = 1024
    cfg, audio, consts = _inputs(hop, n_rows=n_rows, seed=52)
    cls = fused_band_rows(torch.from_numpy(audio), cfg, n_rows, consts).numpy()
    assert cls.shape == (2, n_rows // 128, 128) and cls.dtype == np.int32
    coeffs = fused_band_rows_v3(jnp.asarray(audio), jax_config(cfg), n_rows, interpret=True,
                                fuse_haar=True)
    ref = np.asarray(jax_sel(coeffs.reshape(-1, 4096), f_blk=8, interpret=True))
    assert (cls.reshape(-1, 128) == ref).mean() >= 0.999
    # Classes mode is the select of the coefficients mode, exactly.
    own = fused_band_rows(torch.from_numpy(audio), cfg, n_rows, consts, emit="coeffs")
    np.testing.assert_array_equal(
        cls.reshape(-1, 128), select_sign_classes_plain(own.reshape(-1, 4096)).numpy())


def test_rows_wrapper_rejects_unsupported_configs():
    cfg = FingerprintConfig(integer_hop=False)
    assert not kernel_eligible(cfg)
    with pytest.raises(ValueError):
        fused_band_rows(torch.zeros((1, 4096)), cfg, 128, {})
