"""Fingerprint extraction: audio -> binary subfingerprints (port of
the JAX package's ``ops/extract.py``).

    band rows -> 128-row frames -> 2-D Haar -> |coeff| top-k in rank order
    -> sign classes -> (pos, neg) {0,1} planes [n_sub, pairs]

Clips are padded to a bucket length; the number of valid subfingerprints
travels beside them and trailing subfingerprints are zeroed.

Rows implementation, under the reference's names and as the reference picks
it (the JAX package's ``ops/extract.py:96-122``, CUDA standing for its
accelerator):

- "fused_v3": integer hop dividing 128, window 2048.  On CUDA the fused
  rows kernel (``ops.kernels.fused_rows``, 128 x 32 frames, k <= 128) or the
  band-rows kernel's coefficients (``ops.kernels.band_rows``, every other
  frame geometry), then the select.  On the CPU only at 128 x 32, as the
  plain version of the fused rows kernel.
- "fused": fractional hop on CUDA: the band-rows kernel's rows at the
  host-computed window starts, then Haar and select.
- "fused_v2": only when asked for (``rows_impl="fused_v2"``): the band-rows
  kernel's coefficients at an integer hop dividing 128.
- "conv": other integer hops; strided convolutions, then Haar and select.
- "xla": window gather + matrix DFT (fractional hop on the CPU) or packed
  rfft (bins touching 0 or window/2, any device).

A config the reference's kernels refuse (window 1024 with a fractional hop)
raises ``ValueError`` on CUDA, as the reference does on its accelerator; no
CUDA path runs the plain versions of the kernels.

``extract_fingerprint`` and ``extract_fingerprint_batch`` record the spans
``extract.pad`` (``clips``, ``samples_valid``, ``samples_padded``),
``extract.h2d`` (``bytes``), ``extract.launch`` (the kernels' enqueue) and
``extract.d2h`` (the copy back, which waits for the device) inside
``utils.profiling.recording()``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from lbaudiodetective_torch.config import FingerprintConfig
from lbaudiodetective_torch.device import DEFAULT_DEVICE, resolve_device
from lbaudiodetective_torch.io.decode import DecodedAudio
from lbaudiodetective_torch.ops import spectral
from lbaudiodetective_torch.ops.constants import (
    bands_in_interior, constants_to_tensors, conv_constants, haar_matrix)
from lbaudiodetective_torch.ops.haar import haar_2d
from lbaudiodetective_torch.ops.kernels import band_rows
from lbaudiodetective_torch.ops.kernels.fused_rows import (
    fused_band_rows, kernel_eligible, reaches_v3, rows_arrays)
from lbaudiodetective_torch.ops.kernels.select_signs import (
    FRAME, TOP, select_sign_classes, select_sign_classes_plain)
from lbaudiodetective_torch.utils import profiling


def rows_impl(config: FingerprintConfig, device: torch.device) -> str:
    """The rows implementation for ``config`` on ``device`` (see the module
    docstring)."""
    cuda = device.type == "cuda"
    if not bands_in_interior(config):
        return "xla"          # bin 0 / negative band edges: packed rfft only
    if config.has_integer_hop:
        if reaches_v3(config) and (cuda or kernel_eligible(config)):
            return "fused_v3"
        return "conv"
    return "fused" if cuda else "xla"


def extractor_arrays(config: FingerprintConfig, impl: str) -> dict[str, np.ndarray]:
    """NumPy constants that the ``impl`` rows path reads."""
    if impl == "fused_v3" and kernel_eligible(config):
        return rows_arrays(config)
    if impl in ("fused_v3", "fused_v2"):
        return band_rows.band_rows_arrays(config, haar=True)
    arrays = {"h_rows": haar_matrix(config.rows_per_frame),
              "h_cols": haar_matrix(config.pitch_step_count)}
    if impl == "fused":
        arrays.update(band_rows.band_rows_arrays(config, haar=False))
    elif impl == "conv":
        w1, w2, proj_perm, _ = conv_constants(config)
        arrays.update(conv_w1=w1, conv_w2=w2, proj_perm=proj_perm)
    elif impl != "xla":
        raise ValueError(f"unknown rows_impl {impl!r}")
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
        # The reference runs its select kernel only for 4096-wide frames and
        # k <= 128; other frames take its XLA stable sort, whose port is this
        # sort on every device (not a stand-in for a kernel).
        topcls = select_sign_classes_plain(flat, k)
    return (topcls == 1).to(torch.uint8), (topcls == 2).to(torch.uint8)


class FingerprintExtractor(nn.Module):
    """Extraction for one config on one device.  Holds the constant
    matrices of the chosen rows path as buffers (and those of another path
    once a call asks for it); ``arrays`` replaces the NumPy constants of the
    chosen path (for example with the JAX package's own)."""

    def __init__(self, config: FingerprintConfig | None = None,
                 device: torch.device | str = DEFAULT_DEVICE,
                 arrays: dict[str, np.ndarray] | None = None):
        super().__init__()
        self.config = config or FingerprintConfig()
        self.device = resolve_device(device, "FingerprintExtractor")
        self.impl = rows_impl(self.config, self.device)
        if arrays is None:
            arrays = extractor_arrays(self.config, self.impl)
        for name, t in constants_to_tensors(arrays, self.device).items():
            self.register_buffer(name, t, persistent=False)
        self._other_consts: dict[str, dict[str, torch.Tensor]] = {}

    @property
    def consts(self) -> dict[str, torch.Tensor]:
        return dict(self.named_buffers())

    def consts_for(self, impl: str) -> dict[str, torch.Tensor]:
        """The constant tensors of the ``impl`` rows path."""
        if impl == self.impl:
            return self.consts
        if impl not in self._other_consts:
            self._other_consts[impl] = constants_to_tensors(
                extractor_arrays(self.config, impl), self.device)
        return self._other_consts[impl]

    def forward(self, audio: torch.Tensor, n_valid_sub: torch.Tensor,
                n_rows: int, rows_impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
        """audio ``[B, T]`` or ``[T]`` float32, padded so the last window
        fits; n_valid_sub ``[B]`` or scalar.  ``rows_impl`` is "auto" (the
        extractor's own choice) or one of "fused_v3", "fused_v2", "fused",
        "conv", "xla".  Returns (pos, neg) uint8 ``[..., n_rows /
        rows_per_frame, pairs]``, invalid subfingerprints zeroed."""
        cfg = self.config
        if n_rows % cfg.rows_per_frame:
            raise ValueError("n_rows must be a multiple of rows_per_frame")
        impl = self.impl if rows_impl == "auto" else rows_impl
        batched = audio if audio.dim() == 2 else audio[None]
        consts = self.consts_for(impl)
        n_sub = n_rows // cfg.rows_per_frame
        k = cfg.num_wavelet_pairs
        fused_128x32 = impl == "fused_v3" and kernel_eligible(cfg)
        if fused_128x32 and not (batched.shape[0] == 1 and _single_step(n_sub)):
            # The kernel selects in place; a single clip that fits one 8-tile
            # step takes coefficients + the standalone select, as the
            # reference does (the JAX package's ops/extract.py:60-70).
            topcls = fused_band_rows(batched, cfg, n_rows, consts)[..., :k]
            pos = (topcls == 1).to(torch.uint8)
            neg = (topcls == 2).to(torch.uint8)
        else:
            if fused_128x32:
                rows = fused_band_rows(batched, cfg, n_rows, consts, emit="coeffs")
            elif impl == "fused_v3":
                rows = band_rows.fused_band_rows_v3(batched, cfg, n_rows, consts,
                                                    fuse_haar=True)
            elif impl == "fused_v2":
                rows = band_rows.fused_band_rows_v2(batched, cfg, n_rows, consts,
                                                    fuse_haar=True)
            elif impl == "fused":
                rows = band_rows.fused_band_rows(batched, cfg, n_rows, consts)
            elif impl == "conv":
                rows = spectral.conv_band_rows(batched, cfg, n_rows, consts)
            else:
                starts = spectral.window_starts(cfg, n_rows)
                windows = spectral.frame_windows(batched, starts, cfg.window_size)
                rows = spectral.band_energies(windows, cfg)
            pos, neg = subfingerprints_from_rows(
                rows, cfg, consts, rows_are_coeffs=impl in ("fused_v3", "fused_v2"))
        n_valid = torch.as_tensor(n_valid_sub, device=pos.device).reshape(-1)
        valid = (torch.arange(n_sub, device=pos.device)[None, :]
                 < n_valid[:, None]).to(torch.uint8)[..., None]
        pos, neg = pos * valid, neg * valid
        return (pos, neg) if audio.dim() == 2 else (pos[0], neg[0])


@lru_cache(maxsize=8)
def get_extractor(config: FingerprintConfig,
                  device: str = DEFAULT_DEVICE) -> FingerprintExtractor:
    """Shared extractor per (config, device)."""
    return FingerprintExtractor(config, device)


def extract_fingerprint_padded(audio: torch.Tensor, n_valid_sub: torch.Tensor,
                               config: FingerprintConfig, n_rows: int,
                               rows_impl: str = "auto",
                               extractor: FingerprintExtractor | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Extraction over padded audio already on its device (see
    :meth:`FingerprintExtractor.forward`)."""
    if extractor is None:
        extractor = get_extractor(config, str(audio.device))
    return extractor(audio, n_valid_sub, n_rows, rows_impl)


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
                        device: torch.device | str = DEFAULT_DEVICE
                        ) -> tuple[np.ndarray, np.ndarray, int]:
    """Single-clip extraction on ``device``: decoded audio -> NumPy uint8
    (pos, neg) trimmed to the valid length, and that length."""
    config = config or FingerprintConfig()
    device = resolve_device(device, "extract_fingerprint")
    n_sub = config.num_subfingerprints(audio.file_frames, audio.proc_frames)
    bucket = n_sub_max if n_sub_max is not None else bucket_subfingerprints(n_sub)
    if bucket == 0:
        pairs = config.num_wavelet_pairs
        return (np.zeros((0, pairs), np.uint8), np.zeros((0, pairs), np.uint8), 0)
    n_rows = rows_for_subfingerprints(config, bucket)
    t_pad = required_padded_length(config, n_rows)
    with profiling.stage("extract.pad", clips=1, samples_padded=t_pad) as span:
        x = np.zeros(t_pad, np.float32)
        t = min(audio.samples.shape[0], t_pad)
        x[:t] = audio.samples[:t]
        span.set(samples_valid=t)
    pos, neg = _extract_host(x, torch.tensor(n_sub), config, n_rows, device)
    return pos[:n_sub], neg[:n_sub], n_sub


def extract_fingerprint_batch(clips: list[DecodedAudio],
                              config: FingerprintConfig | None = None,
                              pad_batch_to: int = 0, n_sub_cap: int = 0,
                              device: torch.device | str = DEFAULT_DEVICE
                              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All clips in one padded dispatch on ``device``.  Returns (pos, neg,
    n_sub) with shapes ``[B, S_max, pairs]`` / ``[B]``; invalid
    subfingerprints are zeroed.  ``pad_batch_to``/``n_sub_cap`` pin the
    shapes as in the reference."""
    config = config or FingerprintConfig()
    device = resolve_device(device, "extract_fingerprint_batch")
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
    with profiling.stage("extract.pad", clips=b_out, samples_padded=b_pad * t_pad) as span:
        batch = np.zeros((b_pad, t_pad), dtype=np.float32)
        valid = 0
        for i, c in enumerate(clips):
            t = min(c.samples.shape[0], t_pad)
            batch[i, :t] = c.samples[:t]
            valid += t
        span.set(samples_valid=valid)
    n_subs_pad = np.zeros(b_pad, np.int32)
    n_subs_pad[:b_out] = n_subs
    pos, neg = _extract_host(batch, torch.from_numpy(n_subs_pad), config, n_rows, device)
    return pos[:b_out], neg[:b_out], n_subs


def _extract_host(audio: np.ndarray, n_valid_sub: torch.Tensor, config: FingerprintConfig,
                  n_rows: int, device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """:func:`extract_fingerprint_padded` on padded host audio: the copy to
    ``device``, the launch and the copy back, a span each."""
    with profiling.stage("extract.h2d", bytes=audio.nbytes):
        x = torch.from_numpy(audio).to(device)
    with profiling.stage("extract.launch"):
        pos, neg = extract_fingerprint_padded(x, n_valid_sub, config, n_rows)
    with profiling.stage("extract.d2h"):
        return pos.cpu().numpy(), neg.cpu().numpy()
