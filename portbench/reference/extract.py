"""Plain PyTorch fingerprint extraction, the yardstick the port's extraction
is held to: band energies of every window by a float64 FFT, the frame's
2-D Haar transform, the top |coefficients| in rank order (ties to the lower
flat index) and their signs (``LBAudioDetective.m:208-408``,
``LBAudioDetectiveFrame.m:113-191``).

``precision="tf32"`` is the control: the same stages with the DFT, the band
projection and the Haar products as float32 matrix products on TF32 tensor
cores, the step below the float32 the configuration states."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference.geometry import Geometry, haar_matrix


@contextlib.contextmanager
def _tf32(on: bool):
    keep = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


def _projection(geom: Geometry, dtype, device) -> torch.Tensor:
    """``[window/2, bands]`` band sums with the 1/width normalisation."""
    half = geom.window_size // 2
    proj = np.zeros((half, geom.pitch_step_count))
    widths = geom.band_widths()
    for i, (lo, hi) in enumerate(geom.band_ranges()):
        if hi > lo and widths[i] > 0:
            proj[lo:hi, i] = 1.0 / widths[i]
    return torch.from_numpy(proj).to(device, dtype)


def _packed_spectrum_f64(windows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """vDSP's packed real FFT: slot k >= 1 holds 2 X_k, slot 0 holds 2 X_0
    (re) and 2 X_{n/2} (im)."""
    n = windows.shape[-1]
    spec = torch.fft.rfft(windows, dim=-1)
    re = 2.0 * spec.real[..., :n // 2].clone()
    im = 2.0 * spec.imag[..., :n // 2].clone()
    re[..., 0] = 2.0 * spec.real[..., 0]
    im[..., 0] = 2.0 * spec.real[..., n // 2]
    return re, im


def _packed_spectrum_tf32(windows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    n = windows.shape[-1]
    t = torch.arange(n, dtype=torch.float64, device=windows.device)
    k = torch.arange(n // 2, dtype=torch.float64, device=windows.device)
    theta = 2.0 * torch.pi * t[:, None] * k[None, :] / n
    cos, sin = torch.cos(theta).float(), torch.sin(theta).float()
    cos[:, 0] = 1.0                                   # slot 0: DC in re
    sin[:, 0] = -torch.cos(torch.pi * t).float()      # and -Nyquist, negated below
    re = 2.0 * windows @ cos
    im = -2.0 * windows @ sin
    return re, im


def band_rows(windows: torch.Tensor, geom: Geometry, precision: str) -> torch.Tensor:
    """``[..., window]`` samples -> ``[..., bands]`` band energies."""
    if precision == "float64":
        re, im = _packed_spectrum_f64(windows.double())
        dtype = torch.float64
    else:
        re, im = _packed_spectrum_tf32(windows.float())
        dtype = torch.float32
    div = geom.divisor
    re = torch.where(re > 0, re / div, re)
    im = torch.where(im > 0, im / div, im)
    v = re * re + im * im
    v = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
    return v @ _projection(geom, dtype, windows.device)


def frames_to_planes(rows: torch.Tensor, geom: Geometry) -> tuple[torch.Tensor, torch.Tensor]:
    """``[..., n_frames * rows_per_frame, bands]`` rows -> (pos, neg) uint8
    ``[..., n_frames, pairs]``: 2-D Haar a frame, then the signs of its top
    ``pairs`` |coefficients| in rank order."""
    *lead, n_rows, bands = rows.shape
    rpf = geom.rows_per_frame
    frames = rows.reshape(*lead, n_rows // rpf, rpf, bands)
    h_r = torch.from_numpy(haar_matrix(rpf)).to(rows.device, rows.dtype)
    h_c = torch.from_numpy(haar_matrix(bands)).to(rows.device, rows.dtype)
    coeffs = (h_r @ frames @ h_c.T).reshape(*lead, n_rows // rpf, rpf * bands)
    order = torch.sort(coeffs.abs(), dim=-1, descending=True, stable=True).indices
    top = torch.gather(coeffs, -1, order[..., :geom.pairs])
    return (top > 0).to(torch.uint8), (top < 0).to(torch.uint8)


def fingerprints(audio: torch.Tensor, n_frames: int, geom: Geometry,
                 precision: str = "float64", block: int = 4
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``[B, T]`` samples at the processing rate (zero beyond ``T``) ->
    (pos, neg) uint8 ``[B, n_frames, pairs]`` on ``audio``'s device, the
    first ``n_frames`` frames of each clip, ``block`` clips at a time."""
    if precision not in ("float64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    n_rows = n_frames * geom.rows_per_frame
    starts = geom.row_starts(n_rows)
    need = int(starts[-1]) + geom.window_size
    x = torch.nn.functional.pad(audio, (0, max(0, need - audio.shape[1])))
    idx = (torch.from_numpy(starts).to(audio.device)[:, None]
           + torch.arange(geom.window_size, device=audio.device)[None, :])
    pos, neg = [], []
    with _tf32(precision == "tf32"):
        for b in range(0, audio.shape[0], block):
            rows = band_rows(x[b:b + block][:, idx], geom, precision)
            p, q = frames_to_planes(rows, geom)
            pos.append(p)
            neg.append(q)
    return torch.cat(pos), torch.cat(neg)


def pairs_off(pos: torch.Tensor, neg: torch.Tensor, ref_pos: torch.Tensor,
              ref_neg: torch.Tensor) -> torch.Tensor:
    """``[B]`` share of sign pairs that differ from the reference, 1 where
    the shapes differ."""
    if pos.shape != ref_pos.shape:
        return torch.ones(ref_pos.shape[0], dtype=torch.float64)
    off = (pos != ref_pos) | (neg != ref_neg)
    return off.reshape(off.shape[0], -1).double().mean(1).cpu()
