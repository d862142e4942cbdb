"""Constant matrices of the extraction path, built in NumPy, and their
conversion to device tensors.

These builders are copies of the NumPy constant builders of the JAX package
(the JAX package's ``ops.{haar,dft,spectral}`` and
``ops.pallas.{fused_rows,fused_rows_v2}``), which live in modules that import
JAX.  They must stay bit-equal to those (``tests/test_torch_constants.py``):
they are the "weights" of a system that has no model.  ``tf32_split``,
``stage2_fragments`` and ``projection_passes`` have no JAX counterpart: they
lay the twiddles and the projection out for the port's tensor-core stage 2.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from lbaudiodetective_torch.config import FingerprintConfig

#: Stage-1 DFT length: a window of n samples is read as n = a * (n / A) + b.
STAGE1 = 16
_LANE = 128


@lru_cache(maxsize=8)
def haar_matrix(n: int) -> np.ndarray:
    """Dense ``[n, n]`` float32 matrix of the reference's 1-D Haar transform
    (copy of ``ops/haar.py::haar_matrix``)."""
    if n & (n - 1):
        raise ValueError(f"Haar length must be a power of two, got {n}")
    m = np.eye(n, dtype=np.float64) / np.sqrt(n)
    size = n
    while size > 1:
        size //= 2
        even = m[0:2 * size:2]
        odd = m[1:2 * size:2]
        lo = (even + odd) / np.sqrt(2.0)
        hi = (even - odd) / np.sqrt(2.0)
        m[:size] = lo
        m[size:2 * size] = hi
    return m.astype(np.float32)


@lru_cache(maxsize=8)
def dft_constants(window_size: int, bin_lo: int, bin_hi: int):
    """Two-stage DFT matrices for bins [bin_lo, bin_hi) (copy of
    ``ops/dft.py::_dft_constants``): ``(c1, s1, t_re, t_im, perm)``."""
    a_len, b_len = STAGE1, window_size // STAGE1
    n = window_size
    ks = np.arange(bin_lo, bin_hi)
    n_bins = len(ks)

    aa, rr = np.meshgrid(np.arange(a_len), np.arange(a_len), indexing="ij")
    theta1 = 2.0 * np.pi * aa * rr / a_len
    c1 = np.cos(theta1).astype(np.float32)
    s1 = (-np.sin(theta1)).astype(np.float32)

    classes = [ks[ks % a_len == r] for r in range(a_len)]
    k_max = max(len(c) for c in classes)
    t_re = np.zeros((a_len, b_len, k_max), np.float32)
    t_im = np.zeros((a_len, b_len, k_max), np.float32)
    perm = np.zeros(n_bins, np.int64)
    b = np.arange(b_len)
    for r, cls in enumerate(classes):
        for slot, k in enumerate(cls):
            theta = 2.0 * np.pi * k * b / n
            # 2x fold: vDSP fft_zrip packed output is twice the DFT value.
            t_re[r, :, slot] = 2.0 * np.cos(theta)
            t_im[r, :, slot] = -2.0 * np.sin(theta)
            perm[np.searchsorted(ks, k)] = r * k_max + slot
    return c1, s1, t_re, t_im, perm


def bands_in_interior(config: FingerprintConfig) -> bool:
    """True when every consumed FFT bin lies strictly inside (0, window/2)
    (copy of ``ops/spectral.py::bands_in_interior``).  Only the packed-rfft
    path handles bin 0 (the vDSP DC/Nyquist slot) and the -1 edge."""
    ranges = config.band_bin_ranges
    n_over_2 = config.window_size // 2
    return bool(ranges[:, 0].min() >= 1 and ranges[:, 1].max() <= n_over_2)


@lru_cache(maxsize=8)
def band_projection_matrix(config: FingerprintConfig) -> np.ndarray:
    """``[window/2, bands]`` band-sum matrix with the 1/width normalisation
    folded in (copy of ``ops/spectral.py::band_projection_matrix``)."""
    n_over_2 = config.window_size // 2
    mat = np.zeros((n_over_2, config.pitch_step_count), dtype=np.float32)
    ranges = config.band_bin_ranges
    widths = config.band_widths
    for i in range(config.pitch_step_count):
        lo = min(max(int(ranges[i, 0]), 0), n_over_2)
        hi = min(max(int(ranges[i, 1]), 0), n_over_2)
        if hi > lo and widths[i] > 0:   # zero-width band -> energy 0 (0/0 UB)
            mat[lo:hi, i] = np.float32(1.0) / widths[i]
    return mat


@lru_cache(maxsize=8)
def kernel_constants(config: FingerprintConfig):
    """Stage matrices with the band projection pre-permuted into (residue,
    slot) order (copy of ``ops/pallas/fused_rows.py::_kernel_constants``):
    ``(c16, s16, t_re, t_im, proj_perm, k_max)``."""
    if not bands_in_interior(config):
        raise ValueError(
            "fused rows kernels require band bins strictly inside "
            "(0, window/2); use the xla rows path for this config")
    n = config.window_size
    b_len = n // STAGE1
    ranges = config.band_bin_ranges
    lo, hi = int(ranges[:, 0].min()), int(ranges[:, 1].max())
    ks = np.arange(lo, hi)

    a = np.arange(STAGE1)
    theta1 = 2.0 * np.pi * np.outer(a, np.arange(STAGE1)) / STAGE1
    c16 = np.cos(theta1).astype(np.float32)          # [a, r]
    s16 = (-np.sin(theta1)).astype(np.float32)

    classes = [ks[ks % STAGE1 == r] for r in range(STAGE1)]
    k_max = max(len(c) for c in classes)
    t_re = np.zeros((STAGE1, b_len, k_max), np.float32)
    t_im = np.zeros((STAGE1, b_len, k_max), np.float32)
    proj = band_projection_matrix(config)            # [n/2, bands]
    proj_perm = np.zeros((STAGE1 * k_max, config.pitch_step_count), np.float32)
    bb = np.arange(b_len)
    for r, cls in enumerate(classes):
        for slot, k in enumerate(cls):
            theta = 2.0 * np.pi * k * bb / n
            t_re[r, :, slot] = 2.0 * np.cos(theta)   # vDSP 2x scale folded in
            t_im[r, :, slot] = -2.0 * np.sin(theta)
            proj_perm[r * k_max + slot] = proj[k]
    return c16, s16, t_re, t_im, proj_perm, k_max


@lru_cache(maxsize=8)
def v2_constants(config: FingerprintConfig, fuse_haar: bool = False):
    """Integer-hop rows-kernel constants (copy of
    ``ops/pallas/fused_rows_v2.py::_v2_constants``):
    ``(c16, s16, t2a, t2b, proj_r, k_max, perm, h_cols_t)``.

    ``t2a[r, b]`` holds ``t_re`` in lanes [0, k_max) and ``t_im`` in lanes
    [64, 64 + k_max); ``proj_r[r]`` is residue r's band projection; ``perm``
    maps the kernel's window order p = v * wper + w (window j = vper * w + v)
    back to natural order, times H128 when ``fuse_haar``; ``h_cols_t`` is
    H32 transposed (identity without ``fuse_haar``)."""
    hop = int(config.hop_in_processing_samples)
    c16, s16, t_re, t_im, proj_perm, k_max = kernel_constants(config)
    half = 64
    assert k_max <= half
    b_len = t_re.shape[1]
    t2a = np.zeros((STAGE1, b_len, 2 * half), np.float32)
    t2b = np.zeros((STAGE1, b_len, 2 * half), np.float32)
    t2a[:, :, :k_max] = t_re
    t2a[:, :, half:half + k_max] = t_im
    t2b[:, :, :k_max] = -t_im
    t2b[:, :, half:half + k_max] = t_re
    proj_r = np.zeros((STAGE1, half, config.pitch_step_count), np.float32)
    for r in range(STAGE1):
        proj_r[r, :k_max] = proj_perm[r * k_max:(r + 1) * k_max]
    rpf = config.rows_per_frame
    vper = _LANE // hop                                 # windows per 128 flat
    wper = rpf // vper
    perm = np.zeros((rpf, rpf), np.float32)             # out[j] = rows[(v,w)]
    for j in range(rpf):
        w, v = divmod(j, vper)
        perm[j, v * wper + w] = 1.0
    if fuse_haar:
        perm = haar_matrix(rpf).astype(np.float32) @ perm
        h_cols_t = haar_matrix(config.pitch_step_count).astype(np.float32).T
    else:
        h_cols_t = np.eye(config.pitch_step_count, dtype=np.float32)
    return c16, s16, t2a, t2b, proj_r, k_max, perm, h_cols_t


def tf32_split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``x`` (float32) as ``hi + lo``, each a TF32 value: ``hi`` is ``x``
    rounded to 10 explicit mantissa bits (nearest, ties away from zero, as
    ``cvt.rna.tf32.f32``), ``lo`` the rest rounded the same way.  ``hi + lo``
    is ``x`` within 2^-22 relative."""
    def rna(v):
        bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
        return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)

    x = np.asarray(x, np.float32)
    hi = rna(x)
    return hi, rna(x - hi)


#: Stage-2 tile of ``csrc/dft_stage2.cuh``: b values a chunk, k-steps of 8
#: b a chunk, tiles of 8 slots (48 slots).
S2_CHUNK, S2_KSTEPS, S2_SLOT_TILES = 32, 4, 6


def stage2_passes(k_max: int) -> int:
    """Passes of 48 slots that stage 2 runs for ``k_max`` slots a residue."""
    return -(-k_max // (8 * S2_SLOT_TILES))


def stage2_fragments(t_re: np.ndarray, t_im: np.ndarray) -> np.ndarray:
    """The stage-2 twiddles ``t_re``/``t_im`` (``[residue, b, k_max]``, as
    ``kernel_constants`` builds them) split into TF32 hi and lo and laid out
    in ``mma.m16n8k8`` B-fragment order for ``csrc/dft_stage2.cuh``, in passes
    of 48 slots: ``[residue, pass, chunk, k-step, slot tile, part (re, im),
    lane, 4]`` float32, where lane ``(g, t) = (lane >> 2, lane & 3)`` holds
    ``{hi(T[b]), hi(T[b + 4]), lo(T[b]), lo(T[b + 4])}`` for b = 32 chunk +
    8 k-step + t and slot 48 pass + 8 tile + g; slots from k_max on are
    zero.  At k_max <= 48 there is one pass."""
    n_res, b_len, k_max = t_re.shape
    if b_len % S2_CHUNK:
        raise ValueError(f"stage 2 takes b a multiple of {S2_CHUNK}")
    passes = stage2_passes(k_max)
    slots = 8 * S2_SLOT_TILES
    t = np.zeros((2, n_res, b_len, passes * slots), np.float32)      # (re, im)
    t[0, :, :, :k_max] = t_re
    t[1, :, :, :k_max] = t_im
    hi, lo = tf32_split(t)
    lane = np.arange(32)
    g, tig = lane >> 2, lane & 3
    chunks = b_len // S2_CHUNK
    pa = np.arange(passes)[:, None, None, None, None]
    c = np.arange(chunks)[None, :, None, None, None]
    ks = np.arange(S2_KSTEPS)[None, None, :, None, None]
    tile = np.arange(S2_SLOT_TILES)[None, None, None, :, None]
    b = S2_CHUNK * c + 8 * ks + tig                       # [1, c, ks, 1, lane]
    slot = slots * pa + 8 * tile + g                      # [pass, 1, 1, tile, lane]
    out = np.empty((n_res, passes, chunks, S2_KSTEPS, S2_SLOT_TILES, 2, 32, 4), np.float32)
    for part in range(2):
        for k, (plane, dk) in enumerate(((hi, 0), (hi, 4), (lo, 0), (lo, 4))):
            out[..., part, :, k] = plane[part][:, b + dk, slot]
    return out


def projection_passes(proj_perm: np.ndarray, k_max: int) -> np.ndarray:
    """The permuted band projection (rows ``r * k_max + slot``) as
    ``[residue, pass, 48, bands]`` float32 in stage 2's passes of 48 slots,
    zero past k_max."""
    bands = proj_perm.shape[1]
    n_res = proj_perm.shape[0] // k_max
    slots = 8 * S2_SLOT_TILES
    out = np.zeros((n_res, stage2_passes(k_max) * slots, bands), np.float32)
    out[:, :k_max] = proj_perm.reshape(n_res, k_max, bands)
    return out.reshape(n_res, -1, slots, bands)


@lru_cache(maxsize=8)
def conv_constants(config: FingerprintConfig):
    """Filter banks of the strided-convolution rows path (copy of
    ``ops/spectral.py::_conv_constants``): ``(w1, w2, proj_perm, k_max)``.

    w1: ``[32, 1, 16]`` dilation-(window/16) filters, the stage-1 DFT at
    every sample; w2: ``[16 * 2 * k_max, 2, window/16]`` grouped filters, the
    per-residue stage-2 twiddles."""
    c16, s16, t_re, t_im, proj_perm, k_max = kernel_constants(config)
    b_len = config.window_size // STAGE1
    w1 = np.zeros((2 * STAGE1, 1, STAGE1), np.float32)       # [out, in, taps]
    for r in range(STAGE1):
        w1[2 * r, 0, :] = c16[:, r]
        w1[2 * r + 1, 0, :] = s16[:, r]
    w2 = np.zeros((STAGE1 * 2 * k_max, 2, b_len), np.float32)  # 16 groups
    for r in range(STAGE1):
        for slot in range(k_max):
            oc_re = r * 2 * k_max + slot
            oc_im = r * 2 * k_max + k_max + slot
            w2[oc_re, 0, :] = t_re[r, :, slot]
            w2[oc_re, 1, :] = -t_im[r, :, slot]
            w2[oc_im, 0, :] = t_im[r, :, slot]
            w2[oc_im, 1, :] = t_re[r, :, slot]
    return w1, w2, proj_perm, k_max


def constants_to_tensors(arrays: dict[str, np.ndarray],
                         device: torch.device | str) -> dict[str, torch.Tensor]:
    """NumPy constant arrays -> contiguous tensors on ``device`` (float32
    stays float32, integers become int64).  Arrays built by the JAX package
    and by this module give the same tensors."""
    out = {}
    for name, arr in arrays.items():
        a = np.ascontiguousarray(arr)
        if np.issubdtype(a.dtype, np.integer):
            a = a.astype(np.int64)
        out[name] = torch.from_numpy(a.copy()).to(device)
    return out
