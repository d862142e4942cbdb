"""The port's device-side resampler (``lbaudiodetective_torch/io/
resample.py::resample_rational_torch``) against the JAX package's
``resample_rational_jax`` and the host polyphase path, single and batched,
on the CPU: within 2e-6, the bar tests/test_resample_jax.py sets between
the JAX resampler and the host path (the same plan; the dots sum in
another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lbaudiodetective_tpu.io.resample import resample_rational_jax  # noqa: E402
from lbaudiodetective_torch.io.resample import (  # noqa: E402
    design_polyphase_bank, polyphase_plan, resample_rational_torch)


def _host(x, up, down):
    bank = design_polyphase_bank(up, down)
    taps = bank.shape[1]
    _, base, phase = polyphase_plan(len(x), up, down, bank)
    xp = np.concatenate([np.zeros(taps, np.float32), x, np.zeros(taps, np.float32)])
    idx = (base + taps)[:, None] + np.arange(taps)[None, :]
    return np.einsum("nt,nt->n", xp[idx], bank[phase]).astype(np.float32)


@pytest.mark.parametrize("fs_in, fs_out, up, down", [(44100.0, 5512.0, 1378, 11025),
                                                     (48000.0, 5512.0, 689, 6000)])
def test_torch_resampler_equals_jax_single(fs_in, fs_out, up, down):
    rng = np.random.default_rng(93)
    x = (rng.standard_normal(22050) * 0.3).astype(np.float32)
    got = resample_rational_torch(torch.from_numpy(x), fs_in, fs_out)
    assert got.dtype == torch.float32
    ref = np.asarray(resample_rational_jax(jnp.asarray(x), fs_in, fs_out))
    assert got.shape == ref.shape == ((22050 * up) // down,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got.numpy(), _host(x, up, down), rtol=0, atol=2e-6)


def test_torch_resampler_batched_and_plan_length():
    rng = np.random.default_rng(94)
    x = (rng.standard_normal((3, 11025)) * 0.3).astype(np.float32)
    got = resample_rational_torch(torch.from_numpy(x), 44100.0, 5512.0)
    ref = np.asarray(resample_rational_jax(jnp.asarray(x), 44100.0, 5512.0))
    assert got.shape == ref.shape == (3, 1378)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6)
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(), _host(x[i], 1378, 11025), rtol=0,
                                   atol=2e-6)
    short = resample_rational_torch(torch.from_numpy(x), 44100.0, 5512.0, n_in=8000)
    ref = np.asarray(resample_rational_jax(jnp.asarray(x), 44100.0, 5512.0, n_in=8000))
    np.testing.assert_allclose(short.numpy(), ref, rtol=0, atol=2e-6)
    same = torch.from_numpy(x)
    assert resample_rational_torch(same, 5512.0, 5512.0) is same
