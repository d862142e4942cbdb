"""Fused band rows + 2-D Haar (+ top-128 select) for an integer hop.

Port of ``lbaudiodetective_tpu/ops/pallas/fused_rows_v2.py ::
_rows_kernel_v3`` with ``fuse_haar=True`` (coefficients) and
``pipe_select=True`` (classes).  On a CUDA tensor the hand-written kernel
``csrc/fused_rows.cu`` runs; on a CPU tensor the plain version below
(strided-convolution rows, Haar products, plain select).
"""

from __future__ import annotations

import numpy as np
import torch

from lbaudiodetective_torch.config import FingerprintConfig
from lbaudiodetective_torch.ops.constants import (
    STAGE1, bands_in_interior, conv_constants, haar_matrix, kernel_constants,
    stage2_fragments, v2_constants)
from lbaudiodetective_torch.ops.haar import haar_2d
from lbaudiodetective_torch.ops.kernels.select_signs import (
    TOP, select_sign_classes_plain)
from lbaudiodetective_torch.ops.spectral import conv_band_rows

_LANE = 128
#: Constant tensors the kernel reads (its plain version reads the others).
KERNEL_KEYS = ("c16", "s16", "t2_frag", "proj_r", "perm", "h_cols_t")


def reaches_v3(config: FingerprintConfig) -> bool:
    """True where the reference's accelerator path takes the v3 rows kernel
    (the JAX package's ``ops/extract.py:114-120``): integer hop dividing
    128, window 2048."""
    if not (bands_in_interior(config) and config.has_integer_hop):
        return False
    hop = int(config.hop_in_processing_samples)
    return (hop > 0 and _LANE % hop == 0 and config.window_size == STAGE1 * _LANE
            and config.rows_per_frame % (_LANE // hop) == 0
            and (config.rows_per_frame * hop) % _LANE == 0)


def kernel_eligible(config: FingerprintConfig) -> bool:
    """True where this kernel serves the config: the v3 path at the
    128-row x 32-band frame geometry with k <= 128
    (the JAX package's ``ops/extract.py:169-171``)."""
    return (reaches_v3(config) and config.rows_per_frame == 128
            and config.pitch_step_count == 32
            and config.num_wavelet_pairs <= TOP)


def rows_arrays(config: FingerprintConfig) -> dict[str, np.ndarray]:
    """NumPy constants of the kernel and of its plain version; ``t2_frag``
    holds the stage-2 twiddles split into TF32 hi and lo in the kernel's
    fragment order (``stage2_fragments``)."""
    c16, s16, _t2a, _t2b, proj_r, _, perm, h_cols_t = v2_constants(config, True)
    _, _, t_re, t_im, _, _ = kernel_constants(config)
    w1, w2, proj_perm, _ = conv_constants(config)
    return {"c16": c16, "s16": s16, "t2_frag": stage2_fragments(t_re, t_im),
            "proj_r": proj_r, "perm": perm,
            "h_cols_t": h_cols_t, "conv_w1": w1, "conv_w2": w2,
            "proj_perm": proj_perm,
            "h_rows": haar_matrix(config.rows_per_frame),
            "h_cols": haar_matrix(config.pitch_step_count)}


def fused_band_rows_plain(audio: torch.Tensor, config: FingerprintConfig,
                          n_rows: int, consts: dict[str, torch.Tensor],
                          emit: str = "classes") -> torch.Tensor:
    """Plain version: ``conv_band_rows`` + ``haar_2d`` (+ plain select)."""
    b = audio.shape[0]
    rpf, bands = config.rows_per_frame, config.pitch_step_count
    rows = conv_band_rows(audio, config, n_rows, consts)
    coeffs = haar_2d(rows.reshape(b, n_rows // rpf, rpf, bands),
                     consts["h_rows"], consts["h_cols"]).reshape(b, n_rows, bands)
    if emit == "coeffs":
        return coeffs
    cls = select_sign_classes_plain(coeffs.reshape(-1, rpf * bands))
    return cls.reshape(b, n_rows // rpf, TOP)


def fused_band_rows(audio: torch.Tensor, config: FingerprintConfig, n_rows: int,
                    consts: dict[str, torch.Tensor],
                    emit: str = "classes") -> torch.Tensor:
    """``[B, T] f32 audio ->`` Haar coefficients ``[B, n_rows, 32]``
    (``emit="coeffs"``) or rank-ordered classes ``[B, n_rows / 128, 128]``
    int32 (``emit="classes"``).

    ``consts`` holds ``rows_arrays(config)`` as tensors on ``audio``'s
    device.  ``audio`` is zero-padded as needed.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (``fused_band_rows.launches``
    counts the launches)."""
    if emit not in ("coeffs", "classes"):
        raise ValueError("emit must be 'coeffs' or 'classes'")
    if not kernel_eligible(config):
        raise ValueError("fused_band_rows needs an integer hop dividing 128, "
                         "window 2048 and 128 x 32 frames")
    if audio.dim() != 2 or audio.dtype != torch.float32:
        raise ValueError("fused_band_rows takes [B, T] float32 audio")
    if n_rows % config.rows_per_frame:
        raise ValueError("n_rows must be a multiple of rows_per_frame")
    if audio.device.type == "cpu":
        return fused_band_rows_plain(audio, config, n_rows, consts, emit)
    if audio.device.type != "cuda":
        raise NotImplementedError(f"no rows kernel for device {audio.device}")
    from lbaudiodetective_torch.ops.kernels._build import check, load_library

    lib = load_library()
    x = audio.contiguous()
    c = {k: consts[k] for k in KERNEL_KEYS}
    for k, t in c.items():
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"constant {k!r} must be contiguous float32 on {x.device}")
    batch = x.shape[0]
    n_tiles = n_rows // config.rows_per_frame
    if emit == "coeffs":
        out = torch.empty((batch, n_rows, config.pitch_step_count),
                          dtype=torch.float32, device=x.device)
        coeffs_ptr, cls_ptr = out.data_ptr(), None
    else:
        out = torch.empty((batch, n_tiles, TOP), dtype=torch.int32, device=x.device)
        coeffs_ptr, cls_ptr = None, out.data_ptr()
    if batch == 0 or n_tiles == 0:
        return out
    k_max = kernel_constants(config)[5]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        check(lib.lbad_fused_rows(
            x.data_ptr(), batch, x.shape[1], n_tiles,
            int(config.hop_in_processing_samples),
            c["c16"].data_ptr(), c["s16"].data_ptr(), c["t2_frag"].data_ptr(),
            c["proj_r"].data_ptr(), k_max, c["perm"].data_ptr(),
            c["h_cols_t"].data_ptr(), 1.0 / config.spectrum_scale_divisor,
            coeffs_ptr, cls_ptr, stream), "fused_band_rows")
    fused_band_rows.launches += 1
    return out


fused_band_rows.launches = 0
