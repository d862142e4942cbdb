"""Spectral stage: windowing, vDSP-semantics real FFT and log-spaced band
energies (port of the JAX package's ``ops/spectral.py``).

vDSP semantics kept (quirk Q5): spectrum values carry fft_zrip's 2x scale,
the packed DC/Nyquist slots live at bin 0 (real) and 0 (imag), and only
*positive* components are divided by (window/2)/2.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from lbaudiodetective_torch.config import FingerprintConfig
from lbaudiodetective_torch.ops.constants import (
    STAGE1, band_projection_matrix, bands_in_interior, conv_constants)
from lbaudiodetective_torch.ops.dft import rdft_bins


@contextlib.contextmanager
def full_fp32_convolutions():
    """cuDNN runs float32 convolutions in TF32 by default (about three
    decimal digits), which moves fingerprint bits: switch it off around a
    convolution and restore the caller's setting."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _q5_energy(re: torch.Tensor, im: torch.Tensor, div: float) -> torch.Tensor:
    """Quirk Q5 scaling of positive components, then |X|^2 with non-finite
    energies zeroed."""
    re = torch.where(re > 0.0, re / div, re)
    im = torch.where(im > 0.0, im / div, im)
    v = re * re + im * im
    return torch.where(torch.isfinite(v), v, torch.zeros_like(v))


def packed_spectrum(windows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Real FFT with vDSP packed-format scaling: ``[..., n] -> (re, im)``
    each ``[..., n/2]``, 2x the DFT, re[0] = 2*DC and im[0] = 2*Nyquist."""
    n = windows.shape[-1]
    spec = torch.fft.rfft(windows)
    re = 2.0 * spec.real
    im = (2.0 * spec.imag).clone()
    im[..., 0] = 2.0 * spec[..., n // 2].real
    return re[..., : n // 2], im[..., : n // 2]


def band_energies(windows: torch.Tensor, config: FingerprintConfig) -> torch.Tensor:
    """``[..., window] -> [..., bands]`` band energies.

    Bins strictly inside (0, window/2) come from the two-stage matrix DFT
    (``rdft_bins``); otherwise from the full packed rfft.  Runs in the
    windows' float type."""
    ranges = config.band_bin_ranges
    lo, hi = int(ranges[:, 0].min()), int(ranges[:, 1].max())
    n = windows.shape[-1]
    interior = 1 <= lo and hi <= n // 2 and n % STAGE1 == 0
    if interior:
        re, im = rdft_bins(windows, lo, hi)
    else:
        re, im = packed_spectrum(windows)
    v = _q5_energy(re, im, config.spectrum_scale_divisor)
    return torch.matmul(v, _projection(config, interior, str(windows.device)).to(v.dtype))


@lru_cache(maxsize=16)
def _projection(config: FingerprintConfig, interior: bool, device: str) -> torch.Tensor:
    """The band projection on ``device`` (rows [lo, hi) for the two-stage
    DFT's bins), copied there once."""
    proj = band_projection_matrix(config)
    if interior:
        ranges = config.band_bin_ranges
        proj = proj[int(ranges[:, 0].min()):int(ranges[:, 1].max())]
    return torch.from_numpy(np.ascontiguousarray(proj)).to(device)


def window_starts(config: FingerprintConfig, n_rows: int) -> np.ndarray:
    """Per-row window start positions (processing samples)."""
    return config.row_starts(n_rows)


def frame_windows(audio: torch.Tensor, starts: np.ndarray, window: int) -> torch.Tensor:
    """Gather overlapping windows: ``[..., T] -> [..., n_rows, window]``.
    ``audio`` must be padded so ``starts[-1] + window <= T``."""
    idx = torch.from_numpy(starts[:, None] + np.arange(window)[None, :])
    return audio[..., idx.to(audio.device)]


def conv_band_rows(audio: torch.Tensor, config: FingerprintConfig, n_rows: int,
                   consts: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
    """``[B, T] audio -> [B, n_rows, bands]`` via two strided convolutions.

    A dense 16-tap convolution of dilation window/16 computes the stage-1
    DFT at every sample; a grouped (16 groups) window/16-tap convolution of
    stride ``hop`` applies the per-residue twiddles.  ``consts`` holds the
    ``conv_w1``/``conv_w2``/``proj_perm`` tensors (``conv_constants``) on
    ``audio``'s device; built here when omitted.  Requires an integer hop
    and band bins strictly inside (0, window/2)."""
    if not config.has_integer_hop:
        raise ValueError("conv_band_rows requires an integer hop")
    if not bands_in_interior(config):
        raise ValueError(
            "conv_band_rows requires band bins strictly inside (0, window/2); "
            "use the packed-rfft rows path for this config")
    hop = int(config.hop_in_processing_samples)
    if consts is None:
        w1, w2, proj_perm, _ = conv_constants(config)
        consts = {"conv_w1": torch.from_numpy(w1), "conv_w2": torch.from_numpy(w2),
                  "proj_perm": torch.from_numpy(proj_perm)}
        consts = {k: v.to(audio.device) for k, v in consts.items()}
    k_max = consts["conv_w2"].shape[0] // (2 * STAGE1)
    b = audio.shape[0]
    need = (n_rows - 1) * hop + config.window_size
    if audio.shape[1] < need:
        audio = F.pad(audio, (0, need - audio.shape[1]))
    with full_fp32_convolutions():
        p = F.conv1d(audio[:, None, :], consts["conv_w1"],
                     dilation=config.window_size // STAGE1)       # [B, 32, T']
        x = F.conv1d(p, consts["conv_w2"], stride=hop, groups=STAGE1)  # [B, 32k, R']
    x = x[:, :, :n_rows]
    if x.shape[2] < n_rows:
        x = F.pad(x, (0, n_rows - x.shape[2]))
    x = x.reshape(b, STAGE1, 2, k_max, x.shape[-1])
    v = _q5_energy(x[:, :, 0], x[:, :, 1], config.spectrum_scale_divisor)
    v = v.reshape(b, STAGE1 * k_max, v.shape[-1]).transpose(1, 2)  # [B, R, 16k]
    return torch.matmul(v, consts["proj_perm"])
