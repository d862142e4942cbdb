"""Fingerprint extraction: audio -> binary subfingerprints (port of
the JAX package's ``ops/extract.py``).

    band rows -> 128-row frames -> 2-D Haar -> |coeff| top-k in rank order
    -> sign classes -> (pos, neg) {0,1} planes [n_sub, pairs]

Clips are padded to a bucket length; the number of valid subfingerprints
travels beside them and trailing subfingerprints are zeroed.

Routes, named for what runs on the card; :func:`extraction_route` is the one
place that picks one, once an extractor.  On CUDA it takes the kernels
wherever the reference takes its Pallas kernels on its accelerator (the JAX
package's ``ops/extract.py:96-122``):

- "fused_rows": ``csrc/fused_rows.cu`` (``ops.kernels.fused_rows``), the
  sign classes selected in the kernel.  CUDA, integer hop dividing 128,
  window 2048, 128 x 32 frames, k <= 128.
- "band_rows_coeffs": ``csrc/band_rows.cu`` (``ops.kernels.band_rows``) in
  coefficients mode, then the select.  CUDA, the other frame geometries at
  an integer hop dividing 128 and window 2048.
- "band_rows": ``csrc/band_rows.cu`` rows at the host-computed window
  starts, then Haar and the select.  CUDA, fractional hop.
- "conv": strided convolutions, then Haar and the select.  Every other
  integer hop on CUDA, every integer hop on the CPU.
- "gather": window gather + matrix DFT (fractional hop on the CPU) or packed
  rfft (bins touching 0 or window/2, any device).

A config the kernels refuse (window 1024 with a fractional hop) raises
``ValueError`` on CUDA, as the reference does on its accelerator; no CUDA
route runs the plain versions of the kernels.

Host audio reaches the device in chunks of clips
(:meth:`FingerprintExtractor.extract_clips`): the host pads chunk c + 1
into a page-locked staging slot while chunk c's copy and kernels run, and
waits for the device only at the one copy back.  Where the fused rows
kernel runs, a chunk fills whole waves of its grid (:func:`chunk_bounds`);
every other route, and the CPU, takes the batch in one chunk.

``extract_fingerprint`` and ``extract_fingerprint_batch`` record, a chunk
each, the spans ``extract.pad`` (``clips``, ``samples_valid``,
``samples_padded``), ``extract.h2d`` (``bytes``, ``pinned``) and
``extract.launch`` (the kernels' enqueue), each with ``chunk`` and
``chunks``, and once a batch ``extract.d2h`` (the copy back, which waits
for the device) inside ``utils.profiling.recording()``.
"""

from __future__ import annotations

import contextlib
import math
import threading
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from lbaudiodetective_torch.config import FingerprintConfig
from lbaudiodetective_torch.device import DEFAULT_DEVICE, resolve_device, to_device
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


def extraction_route(config: FingerprintConfig, device: torch.device) -> str:
    """The route that extracts ``config`` on ``device`` (see the module
    docstring)."""
    if not bands_in_interior(config):
        return "gather"       # bin 0 / negative band edges: packed rfft only
    cuda = device.type == "cuda"
    if not config.has_integer_hop:
        return "band_rows" if cuda else "gather"
    if not (cuda and reaches_v3(config)):
        return "conv"
    return "fused_rows" if kernel_eligible(config) else "band_rows_coeffs"


def route_arrays(config: FingerprintConfig, route: str) -> dict[str, np.ndarray]:
    """NumPy constants that ``route`` reads."""
    if route == "fused_rows":
        return rows_arrays(config)
    if route == "band_rows_coeffs":
        return band_rows.band_rows_arrays(config, haar=True)
    arrays = {"h_rows": haar_matrix(config.rows_per_frame),
              "h_cols": haar_matrix(config.pitch_step_count)}
    if route == "band_rows":
        arrays.update(band_rows.band_rows_arrays(config, haar=False))
    elif route == "conv":
        w1, w2, proj_perm, _ = conv_constants(config)
        arrays.update(conv_w1=w1, conv_w2=w2, proj_perm=proj_perm)
    return arrays


def _wave_clips(route: str, n_tiles: int, device: torch.device) -> int:
    """Clips of a chunk that fills whole waves of the fused rows kernel on
    ``device`` where ``route`` runs it, else 0 (one chunk).  The kernel's
    grid is (tiles, clips) with one CTA an SM (512 threads at up to 128
    registers take an SM's register file), so ``n_sm / gcd(tiles, n_sm)``
    clips fill whole waves: 33 at 56 tiles on 132 SMs."""
    if route != "fused_rows":
        return 0
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return n_sm // math.gcd(n_tiles, n_sm)


def chunk_bounds(batch: int, step: int) -> list[tuple[int, int]]:
    """Row ranges of ``batch`` clips in chunks of ``step`` and the rest: one
    chunk where ``step`` is 0 or the batch holds fewer than two such chunks,
    which would leave nothing to overlap.  Chunks of whole waves followed by
    the rest take the waves of one launch."""
    if step <= 0 or batch < 2 * step:
        return [(0, batch)]
    return [(a, min(a + step, batch)) for a in range(0, batch, step)]


class _Staging:
    """Two host slots that chunks are padded into before their copy to the
    device: page-locked on CUDA, where each copy is queued on the ring's
    own stream and the event recorded after it guards the slot, which is
    written again only once that copy has completed.  A slot grows only
    when a larger chunk arrives."""

    def __init__(self, device: torch.device):
        self.pinned = device.type == "cuda"
        self.slots: list[torch.Tensor | None] = [None, None]
        if self.pinned:
            self.stream = torch.cuda.Stream(device)
            self.copied = [torch.cuda.Event(), torch.cuda.Event()]

    def slot(self, i: int, rows: int, t_len: int) -> torch.Tensor:
        """Slot ``i`` as ``[rows, t_len]`` float32, once its last copy has
        completed; its contents are stale."""
        if self.pinned:
            self.copied[i].synchronize()
        n = rows * t_len
        if self.slots[i] is None or self.slots[i].numel() < n:
            self.slots[i] = torch.empty(n, dtype=torch.float32, pin_memory=self.pinned)
        return self.slots[i][:n].view(rows, t_len)

    def copy(self, i: int, dst: torch.Tensor, src: torch.Tensor) -> None:
        """Copy slot ``i``'s ``src`` into ``dst``; on CUDA without a host
        wait, the current stream waiting for the copy on the device."""
        if not self.pinned:
            dst.copy_(src)
            return
        with torch.cuda.stream(self.stream):
            dst.copy_(src, non_blocking=True)
            self.copied[i].record(self.stream)
        torch.cuda.current_stream(dst.device).wait_event(self.copied[i])


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


def route_planes(route: str, audio: torch.Tensor, config: FingerprintConfig, n_rows: int,
                 consts: dict[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """``[B, T]`` audio -> (pos, neg) uint8 ``[B, n_rows / rows_per_frame,
    pairs]`` through ``route`` with its constant tensors ``consts``
    (:func:`route_arrays`), every subfingerprint kept.  On a CPU tensor
    each kernel wrapper runs its plain version."""
    if route == "fused_rows":
        topcls = fused_band_rows(audio, config, n_rows, consts)[..., :config.num_wavelet_pairs]
        return (topcls == 1).to(torch.uint8), (topcls == 2).to(torch.uint8)
    if route in ("band_rows", "band_rows_coeffs"):
        rows = band_rows.band_rows(audio, config, n_rows, coeffs=route == "band_rows_coeffs",
                                   consts=consts)
    elif route == "conv":
        rows = spectral.conv_band_rows(audio, config, n_rows, consts)
    else:
        starts = spectral.window_starts(config, n_rows)
        windows = spectral.frame_windows(audio, starts, config.window_size)
        rows = spectral.band_energies(windows, config)
    return subfingerprints_from_rows(rows, config, consts,
                                     rows_are_coeffs=route == "band_rows_coeffs")


class FingerprintExtractor(nn.Module):
    """Extraction for one config on one device.  Holds the constant
    matrices of its route (:func:`extraction_route`) as buffers; ``arrays``
    replaces the route's NumPy constants (for example with the JAX
    package's own)."""

    def __init__(self, config: FingerprintConfig | None = None,
                 device: torch.device | str = DEFAULT_DEVICE,
                 arrays: dict[str, np.ndarray] | None = None):
        super().__init__()
        self.config = config or FingerprintConfig()
        self.device = resolve_device(device, "FingerprintExtractor")
        self.route = extraction_route(self.config, self.device)
        if arrays is None:
            arrays = route_arrays(self.config, self.route)
        for name, t in constants_to_tensors(arrays, self.device).items():
            self.register_buffer(name, t, persistent=False)
        self._rings: list[_Staging] = []        # idle staging rings
        self._rings_lock = threading.Lock()

    @property
    def consts(self) -> dict[str, torch.Tensor]:
        return dict(self.named_buffers())

    def forward(self, audio: torch.Tensor, n_valid_sub: torch.Tensor,
                n_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
        """audio ``[B, T]`` or ``[T]`` float32, padded so the last window
        fits; n_valid_sub ``[B]`` or scalar (a host value goes to the
        device through pinned memory before the kernels are queued, so that
        no copy waits for them).  Returns (pos, neg) uint8 ``[...,
        n_rows / rows_per_frame, pairs]``, invalid subfingerprints
        zeroed."""
        cfg = self.config
        if n_rows % cfg.rows_per_frame:
            raise ValueError("n_rows must be a multiple of rows_per_frame")
        batched = audio if audio.dim() == 2 else audio[None]
        n_valid = to_device(torch.as_tensor(n_valid_sub), batched.device).reshape(-1)
        pos, neg = route_planes(self.route, batched, cfg, n_rows, self.consts)
        n_sub = n_rows // cfg.rows_per_frame
        valid = (torch.arange(n_sub, device=pos.device)[None, :]
                 < n_valid[:, None]).to(torch.uint8)[..., None]
        pos, neg = pos * valid, neg * valid
        return (pos, neg) if audio.dim() == 2 else (pos[0], neg[0])

    @contextlib.contextmanager
    def _staging(self):
        """A staging ring no other caller holds while this one does."""
        with self._rings_lock:
            ring = self._rings.pop() if self._rings else _Staging(self.device)
        try:
            yield ring
        finally:
            with self._rings_lock:
                self._rings.append(ring)

    def extract_clips(self, samples: list[np.ndarray], n_valid_sub: np.ndarray,
                      n_rows: int, t_pad: int) -> tuple[np.ndarray, np.ndarray]:
        """Host clips -> host (pos, neg) ``[B, n_rows / rows_per_frame,
        pairs]``, B = ``len(n_valid_sub)``: clip i's ``samples`` (cut to
        ``t_pad``) zero-padded to ``t_pad``, rows past ``samples`` all zero.
        The batch goes in chunks (:func:`chunk_bounds`, whole waves where the
        fused rows kernel runs, else one chunk): each chunk is padded into a
        staging slot, copied and launched, and the host waits for the device
        only at the one copy back of the whole batch."""
        cfg = self.config
        b_pad, n_sub = len(n_valid_sub), n_rows // cfg.rows_per_frame
        bounds = chunk_bounds(b_pad, _wave_clips(self.route, n_sub, self.device))
        n_valid = to_device(np.asarray(n_valid_sub, np.int32), self.device)
        x = torch.empty((b_pad, t_pad), dtype=torch.float32, device=self.device)
        out = torch.empty((2, b_pad, n_sub, cfg.num_wavelet_pairs), dtype=torch.uint8,
                          device=self.device)
        with self._staging() as ring:
            if ring.pinned:         # queued work may still read x's memory
                ring.stream.wait_stream(torch.cuda.current_stream(self.device))
            for c, (a, b) in enumerate(bounds):
                at = {"chunk": c, "chunks": len(bounds)}
                with profiling.stage("extract.pad", clips=max(0, min(b, len(samples)) - a),
                                     samples_padded=(b - a) * t_pad, **at) as span:
                    slot = ring.slot(c % 2, b - a, t_pad)
                    rows, valid = slot.numpy(), 0
                    for i, row in enumerate(rows, a):
                        clip = samples[i][:t_pad] if i < len(samples) else ()
                        row[:len(clip)] = clip
                        row[len(clip):] = 0      # the slot holds an earlier chunk
                        valid += len(clip)
                    span.set(samples_valid=valid)
                with profiling.stage("extract.h2d", bytes=slot.nbytes, pinned=ring.pinned, **at):
                    ring.copy(c % 2, x[a:b], slot)
                with profiling.stage("extract.launch", **at):
                    pos, neg = self(x[a:b], n_valid[a:b], n_rows)
                    out[0, a:b] = pos
                    out[1, a:b] = neg
        with profiling.stage("extract.d2h"):
            planes = out.cpu().numpy()
        return planes[0], planes[1]


@lru_cache(maxsize=8)
def get_extractor(config: FingerprintConfig,
                  device: str = DEFAULT_DEVICE) -> FingerprintExtractor:
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
    pos, neg = get_extractor(config, str(device)).extract_clips(
        [audio.samples], np.array([n_sub], np.int32), n_rows, t_pad)
    return pos[0, :n_sub], neg[0, :n_sub], n_sub


def extract_fingerprint_batch(clips: list[DecodedAudio],
                              config: FingerprintConfig | None = None,
                              pad_batch_to: int = 0, n_sub_cap: int = 0,
                              device: torch.device | str = DEFAULT_DEVICE
                              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All clips in one padded batch on ``device``, launched in chunks
    (:meth:`FingerprintExtractor.extract_clips`).  Returns (pos, neg, n_sub)
    with shapes ``[B, S_max, pairs]`` / ``[B]``; invalid subfingerprints
    are zeroed.  ``pad_batch_to``/``n_sub_cap`` pin the shapes as in the
    reference."""
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
    n_subs_pad = np.zeros(b_pad, np.int32)
    n_subs_pad[:b_out] = n_subs
    pos, neg = get_extractor(config, str(device)).extract_clips(
        [c.samples for c in clips], n_subs_pad, n_rows, t_pad)
    return pos[:b_out], neg[:b_out], n_subs
