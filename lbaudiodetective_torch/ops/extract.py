"""Fingerprint extraction: audio -> binary subfingerprints (port of
``lbaudiodetective_tpu/ops/extract.py``).

    band rows -> 128-row frames -> 2-D Haar -> |coeff| top-k in rank order
    -> sign classes -> (pos, neg) {0,1} planes [n_sub, pairs]

Clips are padded to a bucket length; the number of valid subfingerprints
travels beside them and trailing subfingerprints are zeroed.

Rows implementation, as the reference chooses it on an accelerator
(``lbaudiodetective_tpu/ops/extract.py:96-122``), with this port's devices:

- "v3": integer hop dividing 128, window 2048, 128 x 32 frames, k <= 128.
  CUDA runs the fused rows kernel (``ops.kernels.fused_rows``); CPU its
  plain version.  A single clip that fits one 8-tile step takes the
  coefficients and the standalone select kernel, as the reference does
  (``lbaudiodetective_tpu/ops/extract.py:60-70``).
- "conv": other integer hops; strided convolutions, then Haar and select.
- "xla": window gather + matrix DFT (fractional hop, CPU only) or packed
  rfft (bins touching 0 or window/2, any device).
- A config whose reference path reaches a TPU kernel that has no CUDA port
  yet raises ``NotImplementedError`` on CUDA; it never runs plain torch
  there instead.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from lbaudiodetective_tpu.config import FingerprintConfig
from lbaudiodetective_tpu.io.decode import DecodedAudio
from lbaudiodetective_torch.ops import spectral
from lbaudiodetective_torch.ops.constants import (
    bands_in_interior, constants_to_tensors, conv_constants, haar_matrix)
from lbaudiodetective_torch.ops.haar import haar_2d
from lbaudiodetective_torch.ops.kernels.fused_rows import (
    fused_band_rows, kernel_eligible, reaches_v3, rows_arrays)
from lbaudiodetective_torch.ops.kernels.select_signs import (
    FRAME, TOP, select_sign_classes, select_sign_classes_plain)


def rows_impl(config: FingerprintConfig, device: torch.device) -> str:
    """The rows implementation for ``config`` on ``device`` (see the module
    docstring); raises ``NotImplementedError`` for unported CUDA kernels."""
    cuda = device.type == "cuda"
    if not bands_in_interior(config):
        return "xla"          # bin 0 / negative band edges: packed rfft only
    if kernel_eligible(config):
        return "v3"
    if reaches_v3(config):
        if cuda:
            raise NotImplementedError(
                "lbaudiodetective_tpu/ops/pallas/fused_rows_v2.py::"
                f"fused_band_rows_v3 at rows_per_frame={config.rows_per_frame}, "
                f"pitch_step_count={config.pitch_step_count} has no CUDA port")
        return "conv"
    if config.has_integer_hop:
        return "conv"
    if cuda:
        raise NotImplementedError(
            "lbaudiodetective_tpu/ops/pallas/fused_rows.py::fused_band_rows "
            "(fractional hop) has no CUDA port")
    return "xla"


def extractor_arrays(config: FingerprintConfig, impl: str) -> dict[str, np.ndarray]:
    """NumPy constants that the ``impl`` rows path reads."""
    if impl == "v3":
        return rows_arrays(config)
    arrays = {"h_rows": haar_matrix(config.rows_per_frame),
              "h_cols": haar_matrix(config.pitch_step_count)}
    if impl == "conv":
        w1, w2, proj_perm, _ = conv_constants(config)
        arrays.update(conv_w1=w1, conv_w2=w2, proj_perm=proj_perm)
    return arrays


def _single_step(n_tiles: int) -> bool:
    """The reference's rule for a dispatch that fits one grid step of its
    rows kernel (``lbaudiodetective_tpu/ops/pallas/fused_rows_v2.py:667``):
    tiles per step is the largest of 8, 4, 2, 1 dividing the tile count."""
    tps = next(t for t in (8, 4, 2, 1) if n_tiles % t == 0)
    return n_tiles // tps == 1


def subfingerprints_from_rows(rows: torch.Tensor, config: FingerprintConfig,
                              consts: dict[str, torch.Tensor],
                              rows_are_coeffs: bool = False
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``[..., n_rows, bands] -> (pos, neg)`` uint8 ``[..., n_sub, pairs]``
    in rank order (the j-th largest |coefficient|, ties toward the lower
    flat index).  ``rows_are_coeffs``: the input is already per-frame 2-D
    Haar coefficients."""
    *lead, n_rows, bands = rows.shape
    rpf = config.rows_per_frame
    n_sub = n_rows // rpf
    frames = rows.reshape(*lead, n_sub, rpf, bands)
    coeffs = frames if rows_are_coeffs else haar_2d(frames, consts["h_rows"],
                                                    consts["h_cols"])
    n = rpf * bands
    flat = coeffs.reshape(*lead, n_sub, n)
    k = config.num_wavelet_pairs
    if n == FRAME and k <= TOP:
        topcls = select_sign_classes(flat.reshape(-1, n)).reshape(
            *lead, n_sub, TOP)[..., :k]
    else:
        topcls = select_sign_classes_plain(flat, k)
    return (topcls == 1).to(torch.uint8), (topcls == 2).to(torch.uint8)


class FingerprintExtractor(nn.Module):
    """Extraction for one config on one device.  Holds the constant
    matrices of the chosen rows path as buffers; ``arrays`` replaces the
    NumPy constants (for example with the JAX package's own)."""

    def __init__(self, config: FingerprintConfig | None = None,
                 device: torch.device | str = "cpu",
                 arrays: dict[str, np.ndarray] | None = None):
        super().__init__()
        self.config = config or FingerprintConfig()
        device = torch.device(device)
        self.impl = rows_impl(self.config, device)
        if arrays is None:
            arrays = extractor_arrays(self.config, self.impl)
        for name, t in constants_to_tensors(arrays, device).items():
            self.register_buffer(name, t, persistent=False)

    @property
    def consts(self) -> dict[str, torch.Tensor]:
        return dict(self.named_buffers())

    def forward(self, audio: torch.Tensor, n_valid_sub: torch.Tensor,
                n_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
        """audio ``[B, T]`` or ``[T]`` float32, padded so the last window
        fits; n_valid_sub ``[B]`` or scalar.  Returns (pos, neg) uint8
        ``[..., n_rows / rows_per_frame, pairs]``, invalid subfingerprints
        zeroed."""
        cfg = self.config
        if n_rows % cfg.rows_per_frame:
            raise ValueError("n_rows must be a multiple of rows_per_frame")
        batched = audio if audio.dim() == 2 else audio[None]
        consts = self.consts
        n_sub = n_rows // cfg.rows_per_frame
        k = cfg.num_wavelet_pairs
        if self.impl == "v3":
            if batched.shape[0] == 1 and _single_step(n_sub):
                coeffs = fused_band_rows(batched, cfg, n_rows, consts, emit="coeffs")
                pos, neg = subfingerprints_from_rows(coeffs, cfg, consts,
                                                     rows_are_coeffs=True)
            else:
                topcls = fused_band_rows(batched, cfg, n_rows, consts)[..., :k]
                pos = (topcls == 1).to(torch.uint8)
                neg = (topcls == 2).to(torch.uint8)
        else:
            if self.impl == "conv":
                rows = spectral.conv_band_rows(batched, cfg, n_rows, consts)
            else:
                starts = spectral.window_starts(cfg, n_rows)
                windows = spectral.frame_windows(batched, starts, cfg.window_size)
                rows = spectral.band_energies(windows, cfg)
            pos, neg = subfingerprints_from_rows(rows, cfg, consts)
        n_valid = torch.as_tensor(n_valid_sub, device=pos.device).reshape(-1)
        valid = (torch.arange(n_sub, device=pos.device)[None, :]
                 < n_valid[:, None]).to(torch.uint8)[..., None]
        pos, neg = pos * valid, neg * valid
        return (pos, neg) if audio.dim() == 2 else (pos[0], neg[0])


@lru_cache(maxsize=8)
def get_extractor(config: FingerprintConfig, device: str = "cpu") -> FingerprintExtractor:
    """Shared extractor per (config, device)."""
    return FingerprintExtractor(config, device)


def extract_fingerprint_padded(audio: torch.Tensor, n_valid_sub: torch.Tensor,
                               config: FingerprintConfig, n_rows: int,
                               extractor: FingerprintExtractor | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Extraction over padded audio already on its device (see
    :meth:`FingerprintExtractor.forward`)."""
    if extractor is None:
        extractor = get_extractor(config, str(audio.device))
    return extractor(audio, n_valid_sub, n_rows)


def required_padded_length(config: FingerprintConfig, n_rows: int) -> int:
    """Minimum audio length (processing samples) for a static row count."""
    if n_rows <= 0:
        return config.window_size
    starts = config.row_starts(n_rows)
    return int(starts[-1]) + config.window_size


def rows_for_subfingerprints(config: FingerprintConfig, n_sub: int) -> int:
    return n_sub * config.rows_per_frame


def bucket_subfingerprints(n_sub: int, granularity: int = 8) -> int:
    """Round a subfingerprint count up to a multiple of ``granularity``."""
    if n_sub <= 0:
        return 0
    return ((n_sub + granularity - 1) // granularity) * granularity


def extract_fingerprint(audio: DecodedAudio, config: FingerprintConfig | None = None,
                        n_sub_max: int | None = None,
                        device: torch.device | str = "cpu"
                        ) -> tuple[np.ndarray, np.ndarray, int]:
    """Single-clip extraction on ``device``: decoded audio -> NumPy uint8
    (pos, neg) trimmed to the valid length, and that length."""
    config = config or FingerprintConfig()
    n_sub = config.num_subfingerprints(audio.file_frames, audio.proc_frames)
    bucket = n_sub_max if n_sub_max is not None else bucket_subfingerprints(n_sub)
    if bucket == 0:
        pairs = config.num_wavelet_pairs
        return (np.zeros((0, pairs), np.uint8), np.zeros((0, pairs), np.uint8), 0)
    n_rows = rows_for_subfingerprints(config, bucket)
    t_pad = required_padded_length(config, n_rows)
    x = np.zeros(t_pad, np.float32)
    t = min(audio.samples.shape[0], t_pad)
    x[:t] = audio.samples[:t]
    device = torch.device(device)
    pos, neg = extract_fingerprint_padded(
        torch.from_numpy(x).to(device), torch.tensor(n_sub), config, n_rows)
    return pos.cpu().numpy()[:n_sub], neg.cpu().numpy()[:n_sub], n_sub


def extract_fingerprint_batch(clips: list[DecodedAudio],
                              config: FingerprintConfig | None = None,
                              pad_batch_to: int = 0, n_sub_cap: int = 0,
                              device: torch.device | str = "cpu"
                              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All clips in one padded dispatch on ``device``.  Returns (pos, neg,
    n_sub) with shapes ``[B, S_max, pairs]`` / ``[B]``; invalid
    subfingerprints are zeroed.  ``pad_batch_to``/``n_sub_cap`` pin the
    shapes as in the reference."""
    config = config or FingerprintConfig()
    n_subs = np.array([config.num_subfingerprints(c.file_frames, c.proc_frames)
                       for c in clips], dtype=np.int32)
    if n_sub_cap:
        n_subs = np.minimum(n_subs, n_sub_cap)
        s_max = bucket_subfingerprints(n_sub_cap)
    else:
        s_max = bucket_subfingerprints(int(n_subs.max(initial=0)))
    b_out = len(clips)
    b_pad = max(b_out, pad_batch_to)
    if s_max == 0:
        pairs = config.num_wavelet_pairs
        return (np.zeros((b_out, 0, pairs), np.uint8),
                np.zeros((b_out, 0, pairs), np.uint8), n_subs)
    n_rows = rows_for_subfingerprints(config, s_max)
    t_pad = required_padded_length(config, n_rows)
    batch = np.zeros((b_pad, t_pad), dtype=np.float32)
    for i, c in enumerate(clips):
        t = min(c.samples.shape[0], t_pad)
        batch[i, :t] = c.samples[:t]
    n_subs_pad = np.zeros(b_pad, np.int32)
    n_subs_pad[:b_out] = n_subs
    device = torch.device(device)
    pos, neg = extract_fingerprint_padded(
        torch.from_numpy(batch).to(device), torch.from_numpy(n_subs_pad), config,
        n_rows)
    return pos.cpu().numpy()[:b_out], neg.cpu().numpy()[:b_out], n_subs
