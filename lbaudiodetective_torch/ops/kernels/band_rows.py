"""Band rows (or per-frame 2-D Haar coefficients) for windows at host-computed
starts: ``[B, T] f32 audio -> [B, n_rows, bands] f32``.

One hand-written kernel, ``csrc/band_rows.cu``, ports three TPU kernels of
``lbaudiodetective_tpu/ops/pallas/``: ``fused_rows.py::fused_band_rows``
(fractional hop, rows), ``fused_rows_v2.py::_rows_kernel_v2`` (integer
hop, rows or with ``fuse_haar`` the coefficients) and
``fused_rows_v2.py::_rows_kernel_v3`` with ``fuse_haar`` at the frame
geometries ``csrc/fused_rows.cu`` does not take.  One wrapper,
:func:`band_rows`, launches it in rows or coefficients mode; which configs
reach it is decided by ``ops/extract.py::extraction_route``.

The kernel runs stage 2 on the tensor cores in 3xTF32 (``csrc/dft_stage2.cuh``,
as ``csrc/fused_rows.cu`` does) with the signal's level taken out of residue
0; it is held to the plain version evaluated in float64.  Window starts are
``FingerprintConfig.row_starts`` (a float64 floor on the host), sent to the
device as an int32 table.  On a CUDA tensor the wrapper launches the kernel
or raises; on a CPU tensor it runs the plain version
(:func:`band_rows_plain`: window gather + matrix DFT band energies, + Haar
products), which nothing on a CUDA path calls.  ``band_rows.launches``
counts the launches (``ops.kernels.launch_counts``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from lbaudiodetective_torch.config import FingerprintConfig
from lbaudiodetective_torch.ops import spectral
from lbaudiodetective_torch.ops.constants import (
    constants_to_tensors, haar_matrix, kernel_constants, projection_passes, stage2_fragments)
from lbaudiodetective_torch.ops.haar import haar_2d

#: The one window the TPU kernels run at: 16 rows of 128 lanes.
WINDOW = 2048


def band_rows_arrays(config: FingerprintConfig, haar: bool) -> dict[str, np.ndarray]:
    """NumPy constants of the kernel, from ``kernel_constants``: the stage-1
    matrices, the stage-2 twiddles split into TF32 in fragment order
    (``t2_frag``, ``stage2_fragments``), the permuted band projection in
    passes of 48 slots (``proj_pass``, ``projection_passes``), and with
    ``haar`` the frame's Haar matrices (``h_rows`` ``[rpf, rpf]``,
    ``h_cols_t`` = H_bands transposed)."""
    c16, s16, t_re, t_im, proj_perm, k_max = kernel_constants(config)
    arrays = {"c16": c16, "s16": s16, "t2_frag": stage2_fragments(t_re, t_im),
              "proj_pass": projection_passes(proj_perm, k_max)}
    if haar:
        arrays["h_rows"] = haar_matrix(config.rows_per_frame)
        arrays["h_cols_t"] = np.ascontiguousarray(haar_matrix(config.pitch_step_count).T)
    return arrays


@lru_cache(maxsize=32)
def _device_constants(config: FingerprintConfig, haar: bool, device: str):
    return constants_to_tensors(band_rows_arrays(config, haar), device)


@lru_cache(maxsize=32)
def _device_starts(config: FingerprintConfig, n_rows: int, device: str) -> torch.Tensor:
    starts = config.row_starts(n_rows)
    if starts[-1] >= 2 ** 31:
        raise ValueError("window starts past 2^31 samples do not fit the int32 table")
    return torch.from_numpy(starts.astype(np.int32)).to(device)


def tile_plan(config: FingerprintConfig, n_rows: int, coeffs: bool, smem_bytes,
              smem_limit: int) -> dict[str, int]:
    """How the kernel cuts ``n_rows`` windows: ``sub`` windows a sub-tile
    (the largest power of two whose audio span fits in shared memory beside
    the other regions), ``tile_rows`` rows a CTA (a frame in coefficients
    mode, ``sub`` in rows mode), the padded span and the shared memory in
    bytes.  ``smem_bytes(sub, bands, span_pad, frame_floats)`` is the
    kernel's layout (``lbad_band_rows_smem_bytes``, negative for a sub-tile
    it does not take) and ``smem_limit`` the bytes a block may use.  Raises
    ``ValueError`` naming the limit when one window (with the frame, in
    coefficients mode) does not fit."""
    if n_rows <= 0:
        raise ValueError("n_rows must be positive")
    rpf, bands = config.rows_per_frame, config.pitch_step_count
    starts = config.row_starts(n_rows)
    frame_floats = rpf * bands if coeffs else 0
    sub = 1 << ((min(n_rows, rpf) if coeffs else n_rows).bit_length() - 1)
    while sub >= 1:
        first = np.arange(0, n_rows, sub)
        last = np.minimum(first + sub, n_rows) - 1
        span = int(np.max(starts[last] - starts[first])) + WINDOW
        span_pad = -(-span // 4) * 4
        smem = smem_bytes(sub, bands, span_pad, frame_floats)
        if 0 <= smem <= smem_limit:
            return {"sub": sub, "tile_rows": rpf if coeffs else sub,
                    "span_pad": span_pad, "smem": smem}
        sub //= 2
    what = (f"one window of {WINDOW} samples and a frame of {rpf} x {bands} rows"
            if coeffs else f"one window of {WINDOW} samples")
    raise ValueError(f"band_rows: {what} do not fit in the {smem_limit} bytes of "
                     "shared memory a block may use")


@lru_cache(maxsize=64)
def _device_plan(config: FingerprintConfig, n_rows: int, coeffs: bool,
                 device: str) -> dict[str, int]:
    """``tile_plan`` with the kernel's own layout and the card's limit."""
    from lbaudiodetective_torch.ops.kernels._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        limit = lib.lbad_band_rows_smem_limit()
    if limit < 0:
        raise RuntimeError(f"band_rows: CUDA error {-limit} reading the shared-memory limit")
    return tile_plan(config, n_rows, coeffs, lib.lbad_band_rows_smem_bytes, limit)


def _check(audio: torch.Tensor, config: FingerprintConfig, n_rows: int) -> None:
    if config.window_size != WINDOW:
        raise ValueError(
            f"band_rows needs window_size == {WINDOW}: the window is read as 16 rows "
            "of 128 lanes (lbaudiodetective_tpu/ops/pallas/fused_rows.py::fused_band_rows "
            f"fails at window {config.window_size} too)")
    if audio.dim() != 2 or audio.dtype != torch.float32:
        raise ValueError("band_rows takes [B, T] float32 audio")
    if n_rows % config.rows_per_frame:
        raise ValueError("n_rows must be a multiple of rows_per_frame")
    kernel_constants(config)        # raises for band bins outside (0, window/2)


def band_rows_plain(audio: torch.Tensor, config: FingerprintConfig, n_rows: int,
                    coeffs: bool = False) -> torch.Tensor:
    """Plain version: gather the windows at ``config.row_starts`` (zero past
    T), two-stage matrix DFT band energies (``spectral.band_energies``) and,
    with ``coeffs``, the per-frame 2-D Haar products, all in ``audio``'s
    float type: float64 audio gives the exact evaluation the kernel is held
    to."""
    b = audio.shape[0]
    rpf, bands = config.rows_per_frame, config.pitch_step_count
    starts = config.row_starts(n_rows)
    need = int(starts[-1]) + config.window_size
    if audio.shape[1] < need:
        audio = F.pad(audio, (0, need - audio.shape[1]))
    rows = spectral.band_energies(
        spectral.frame_windows(audio, starts, config.window_size), config)
    if not coeffs:
        return rows
    return haar_2d(rows.reshape(b, n_rows // rpf, rpf, bands)).reshape(b, n_rows, bands)


def band_rows(audio: torch.Tensor, config: FingerprintConfig, n_rows: int,
              coeffs: bool = False, consts: dict[str, torch.Tensor] | None = None
              ) -> torch.Tensor:
    """Band rows ``[B, n_rows, bands]`` at the windows of
    ``config.row_starts``, or with ``coeffs`` each frame's 2-D Haar
    coefficients.  ``consts`` holds ``band_rows_arrays(config, coeffs)`` on
    ``audio``'s device (built when omitted).  A CUDA tensor launches
    ``csrc/band_rows.cu``; a CPU tensor runs :func:`band_rows_plain`."""
    _check(audio, config, n_rows)
    if audio.device.type == "cpu":
        return band_rows_plain(audio, config, n_rows, coeffs)
    if audio.device.type != "cuda":
        raise NotImplementedError(f"no band-rows kernel for device {audio.device}")
    x = audio.contiguous()
    if consts is None:
        consts = _device_constants(config, coeffs, str(x.device))
    return launch(x, config, n_rows, coeffs, consts, kernel_constants(config)[5])


def launch(x: torch.Tensor, config: FingerprintConfig, n_rows: int, coeffs: bool,
           consts: dict[str, torch.Tensor], k_max: int) -> torch.Tensor:
    """One launch of ``csrc/band_rows.cu`` on the contiguous CUDA audio ``x``
    with the constant tensors ``consts`` (``band_rows_arrays``: stage 2 and
    the projection in passes of 48 of ``k_max`` slots a residue), counted
    in ``band_rows.launches``."""
    from lbaudiodetective_torch.ops.kernels._build import check, load_library

    lib = load_library()
    keys = ("c16", "s16", "t2_frag", "proj_pass") + (
        ("h_rows", "h_cols_t") if coeffs else ())
    for k in keys:
        t = consts[k]
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"constant {k!r} must be contiguous float32 on {x.device}")
    plan = _device_plan(config, n_rows, coeffs, str(x.device))
    starts = _device_starts(config, n_rows, str(x.device))
    batch, bands = x.shape[0], config.pitch_step_count
    out = torch.empty((batch, n_rows, bands), dtype=torch.float32, device=x.device)
    if batch == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        check(lib.lbad_band_rows(
            x.data_ptr(), batch, x.shape[1], starts.data_ptr(), n_rows,
            plan["tile_rows"], plan["sub"], bands, k_max, plan["span_pad"],
            consts["c16"].data_ptr(), consts["s16"].data_ptr(),
            consts["t2_frag"].data_ptr(), consts["proj_pass"].data_ptr(),
            consts["h_rows"].data_ptr() if coeffs else None,
            consts["h_cols_t"].data_ptr() if coeffs else None,
            1.0 / config.spectrum_scale_divisor, out.data_ptr(), stream), "band_rows")
    band_rows.launches += 1
    return out


band_rows.launches = 0
