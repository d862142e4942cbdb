"""Streaming (incremental) fingerprint extraction for B lockstep streams
(port of the JAX package's ``streaming/runtime.py``).

Every stream receives a chunk of the same size per step, so the row and
frame bookkeeping is one host computation per step (the same float64
arithmetic as the offline row starts), and the device only sees data.  Three
step paths, as in the reference:

- aligned (integer hop, chunk == rows_per_frame * hop): shift a linear
  buffer and extract one frame per stream with ``extract_fingerprint_padded``
  (on CUDA the fused rows kernel, or the band-rows kernel at other frame
  geometries);
- conv (other integer-hop chunks that keep the hop grid): a linear buffer,
  one segment on the hop grid, ``conv_band_rows`` under full FP32;
- gather (fractional hop): a mod-``l_buf`` audio ring, the step's windows
  gathered from it and ``band_energies`` (plain torch, as the reference's
  step is XLA there).

Rows go into a rows ring; completed frames go through
``subfingerprints_from_rows`` (Haar, then on CUDA the select kernel).
Incremental output is bit-identical to the offline extractor over the
concatenated stream where both run the same rows code.  int16 chunks convert
on the device; with ``collect_host=False`` no step waits for the device.
With a ``mesh``, the stream axis splits over the slots of ``mesh_axis``
and each slot steps its own streams with the same kernels (every step is
elementwise across streams, so no collective is needed).
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from lbaudiodetective_torch.config import FingerprintConfig
from lbaudiodetective_torch.device import DEFAULT_DEVICE, resolve_device, to_device
from lbaudiodetective_torch.models.fingerprint import Fingerprint
from lbaudiodetective_torch.ops import spectral
from lbaudiodetective_torch.ops.constants import (
    bands_in_interior, constants_to_tensors, conv_constants, haar_matrix)
from lbaudiodetective_torch.ops.extract import (
    extract_fingerprint_padded, get_extractor, subfingerprints_from_rows)


def _rows_ring_size(rows_per_frame: int, r_max: int) -> int:
    """Row-ring capacity: the power of two holding every row still needed
    (a completing frame reaches ``rows_per_frame - 1`` rows behind the
    newest, and up to ``r_max`` rows arrive before frames are harvested)."""
    return 1 << int(np.ceil(np.log2(rows_per_frame + r_max)))


def _to_f32(chunk: torch.Tensor) -> torch.Tensor:
    """float passthrough; int16 PCM scales by 1/32768 (exact in f32)."""
    if chunk.dtype == torch.int16:
        return chunk.to(torch.float32) * (1.0 / 32768.0)
    return chunk.to(torch.float32)


def _put_ring(ring: torch.Tensor, start: int, values: torch.Tensor) -> None:
    """Write ``values`` ``[B, n, ...]`` into ``ring`` ``[B, size, ...]`` at
    slots ``start, start + 1, ...`` modulo the size, in place."""
    size, n = ring.shape[1], values.shape[1]
    first = min(n, size - start)
    ring[:, start:start + first] = values[:, :first]
    if n > first:
        ring[:, :n - first] = values[:, first:]


@dataclasses.dataclass
class StreamingExtractor:
    """Incremental extractor for B lockstep streams on ``device``.

    Feed ``[batch, chunk_size]`` chunks with :meth:`feed`; completed
    subfingerprints are returned per call and accumulated on
    :attr:`collected`.  With ``collect_host=False`` they stay on the device
    until :meth:`harvest`."""

    batch: int
    chunk_size: int = 1024
    config: FingerprintConfig = dataclasses.field(default_factory=FingerprintConfig)
    device: torch.device | str = DEFAULT_DEVICE
    collect_host: bool = True
    #: Optional ``parallel.mesh.Mesh``: the stream axis splits over the
    #: slots of ``mesh_axis`` (every slot in this process, on ``device``'s
    #: type), each slot stepping ``batch / n`` streams of its own.
    mesh: object = None
    mesh_axis: str = "data"

    def __post_init__(self):
        cfg = self.config
        self.device = resolve_device(self.device, "StreamingExtractor")
        self._parts = None
        if self.mesh is not None:
            self._split_over_mesh()
            return
        self.hop = cfg.hop_in_processing_samples
        self.r_max = int(np.ceil(self.chunk_size / self.hop)) + 1
        self.f_max = max(1, (self.r_max + cfg.rows_per_frame - 1) // cfg.rows_per_frame + 1)
        self.ring_size = _rows_ring_size(cfg.rows_per_frame, self.r_max)
        self.l_buf = 1 << int(np.ceil(np.log2(cfg.window_size + self.chunk_size)))
        # One chunk is exactly one frame of windows: every step has the same
        # window grid, so a step is a buffer shift + the offline extractor.
        self.aligned = (cfg.has_integer_hop
                        and self.chunk_size == cfg.rows_per_frame * int(self.hop))
        # Other integer-hop chunks that keep the hop grid: strided convs over
        # one segment of a linear buffer, no window gather.
        self.use_conv = (cfg.has_integer_hop and not self.aligned
                         and int(self.hop) > 0
                         and self.chunk_size % int(self.hop) == 0
                         and bands_in_interior(cfg))
        self.span = ((self.r_max - 1) * int(self.hop) + cfg.window_size
                     if self.use_conv else 0)
        arrays = {"h_rows": haar_matrix(cfg.rows_per_frame),
                  "h_cols": haar_matrix(cfg.pitch_step_count)}
        if self.use_conv:
            w1, w2, proj_perm, _ = conv_constants(cfg)
            arrays.update(conv_w1=w1, conv_w2=w2, proj_perm=proj_perm)
        self.consts = constants_to_tensors(arrays, self.device)
        self.reset()

    def _split_over_mesh(self) -> None:
        """One extractor a slot of ``mesh_axis``, each over ``batch / n``
        streams on the slot's device."""
        slots = self.mesh.require_local(self.mesh_axis, "a sharded StreamingExtractor")
        if self.batch % len(slots):
            raise ValueError("batch must divide the mesh data axis")
        for slot in slots:
            if slot.device.type != self.device.type:
                raise ValueError(f"StreamingExtractor: a mesh slot is on {slot.device}, "
                                 f"not on {self.device}")
        self._parts = [StreamingExtractor(self.batch // len(slots), self.chunk_size,
                                          self.config, slot.device, self.collect_host)
                       for slot in slots]
        for name in ("hop", "r_max", "f_max", "ring_size", "l_buf", "aligned", "use_conv",
                     "span"):
            setattr(self, name, getattr(self._parts[0], name))
        self.reset()

    def reset(self, keep_collected: bool = False) -> None:
        """Clear stream state (the essay's LBAudioDetectiveReset)."""
        cfg, dev = self.config, self.device
        if self._parts is not None:
            for part in self._parts:
                part.reset()
            self.total_samples = self.rows_done = 0
            if not keep_collected:
                self.collected = []
            return
        # The conv path keeps a linear sliding buffer, the gather path a
        # mod-l_buf ring: the same array, indexed differently.
        self.audio_ring = torch.zeros((self.batch, self.l_buf), dtype=torch.float32,
                                      device=dev)
        self.rows_ring = torch.zeros((self.batch, self.ring_size, cfg.pitch_step_count),
                                     dtype=torch.float32, device=dev)
        if self.aligned:
            # The trailing `lag` chunks: the span one frame of windows needs.
            span = (cfg.rows_per_frame - 1) * int(self.hop) + cfg.window_size
            self.lag = -(-span // self.chunk_size)
            self.lin_buf = torch.zeros((self.batch, self.lag * self.chunk_size),
                                       dtype=torch.float32, device=dev)
            self._one_valid = torch.ones(self.batch, dtype=torch.int32, device=dev)
        self.total_samples = 0
        self.rows_done = 0
        if not keep_collected:
            self.collected: list[tuple] = []

    def _row_start(self, r: int) -> int:
        """Absolute window start of row r: the offline float64 floor."""
        return int(np.floor(np.float64(r) * np.float64(self.hop)))

    def feed_pcm16(self, chunk_i16: np.ndarray):
        """Feed ``[B, chunk_size]`` int16 PCM (the reference's recording
        format): half the bytes of :meth:`feed` cross to the device, and the
        conversion to float runs there."""
        if chunk_i16.dtype != np.int16:
            raise ValueError("feed_pcm16 requires int16 samples")
        return self.feed(chunk_i16)

    def feed(self, chunk):
        """Feed ``[B, chunk_size]`` samples (NumPy or tensor; float, or int16
        PCM); returns (pos, neg, n_completed) with pos/neg
        ``[B, n_completed, pairs]`` for the frames completed in this step
        (NumPy, or device tensors with ``collect_host=False``)."""
        cfg = self.config
        if tuple(chunk.shape) != (self.batch, self.chunk_size):
            raise ValueError(f"chunk must be [{self.batch}, {self.chunk_size}]")
        if self._parts is not None:
            return self._feed_parts(chunk)
        x = _to_f32(to_device(chunk, self.device))
        new_total = self.total_samples + self.chunk_size
        if self.aligned:
            return self._feed_aligned(x, new_total)

        # Rows whose window now fits entirely in the received samples.
        r0 = r_end = self.rows_done
        while (self._row_start(r_end) + cfg.window_size <= new_total
               and r_end - r0 < self.r_max):
            r_end += 1
        n_new = r_end - r0

        if self.use_conv:
            c = self.chunk_size
            self.audio_ring = torch.cat([self.audio_ring[:, c:], x], dim=1)
            rel0 = self._row_start(r0) - (new_total - self.l_buf)
            if n_new:
                assert 0 <= rel0 <= self.l_buf - cfg.window_size, (
                    f"stream fell behind the audio buffer (rel0={rel0}); "
                    "increase chunk_size")
            rel0 = int(np.clip(rel0, 0, self.l_buf - cfg.window_size))
            if n_new:
                # Conv row j of the segment is row r0 + j; rows past the
                # received samples read the zero tail and are dropped.
                padded = torch.nn.functional.pad(self.audio_ring,
                                                 (0, self.span - cfg.window_size))
                seg = padded[:, rel0:rel0 + self.span]
                rows = spectral.conv_band_rows(seg, cfg, self.r_max, self.consts)
                _put_ring(self.rows_ring, r0 % self.ring_size, rows[:, :n_new])
        else:
            _put_ring(self.audio_ring, self.total_samples % self.l_buf, x)
            if n_new:
                starts = np.array([self._row_start(r) % self.l_buf
                                   for r in range(r0, r_end)], np.int64)
                idx = (to_device(starts, self.device)[:, None]
                       + torch.arange(cfg.window_size, device=self.device)) % self.l_buf
                rows = spectral.band_energies(self.audio_ring[:, idx], cfg)
                _put_ring(self.rows_ring, r0 % self.ring_size, rows)

        # Frames completed by these rows (a frame never wraps the ring:
        # both sizes are powers of two and the ring is the larger).
        rpf = cfg.rows_per_frame
        frames = range(r0 // rpf, min(r_end // rpf, r0 // rpf + self.f_max))
        self.total_samples = new_total
        self.rows_done = r_end
        n_completed = len(frames)
        if not n_completed:
            pairs = cfg.num_wavelet_pairs
            empty = np.zeros((self.batch, 0, pairs), np.uint8)
            return empty, empty, 0
        first = [(f * rpf) % self.ring_size for f in frames]
        rows = torch.cat([self.rows_ring[:, s:s + rpf] for s in first], dim=1)
        pos, neg = subfingerprints_from_rows(rows, cfg, self.consts)
        return self._emit(pos, neg, n_completed)

    def _feed_aligned(self, x: torch.Tensor, new_total: int):
        """Shift the linear buffer and, once it holds a whole frame of
        windows, extract that frame (one subfingerprint per stream)."""
        cfg = self.config
        self.total_samples = new_total
        self.lin_buf = torch.cat([self.lin_buf[:, self.chunk_size:], x], dim=1)
        frame = new_total // self.chunk_size - self.lag
        if frame < 0 or frame < self.rows_done // cfg.rows_per_frame:
            pairs = cfg.num_wavelet_pairs
            empty = np.zeros((self.batch, 0, pairs), np.uint8)
            return empty, empty, 0
        pos, neg = extract_fingerprint_padded(
            self.lin_buf, self._one_valid, cfg, cfg.rows_per_frame,
            extractor=get_extractor(cfg, str(self.device)))
        self.rows_done = (frame + 1) * cfg.rows_per_frame
        return self._emit(pos, neg, 1)

    def _feed_parts(self, chunk):
        """Feed each slot its streams' rows of ``chunk`` and join what they
        completed (lockstep: every slot completes the same frames), on the
        host or on the first slot's device."""
        b = self.batch // len(self._parts)
        outs = []
        for i, part in enumerate(self._parts):
            outs.append(part.feed(chunk[i * b:(i + 1) * b]))
            part.collected.clear()           # the parent keeps the joined output
        n_completed = outs[0][2]
        self.total_samples = self._parts[0].total_samples
        self.rows_done = self._parts[0].rows_done
        if not n_completed:
            empty = np.zeros((self.batch, 0, self.config.num_wavelet_pairs), np.uint8)
            return empty, empty, 0
        if self.collect_host:
            pos, neg = (np.concatenate([o[k] for o in outs]) for k in (0, 1))
        else:
            dev = self._parts[0].device
            pos, neg = (torch.cat([o[k].to(dev, non_blocking=True) for o in outs])
                        for k in (0, 1))
        self.collected.append((pos, neg))
        return pos, neg, n_completed

    def _emit(self, pos: torch.Tensor, neg: torch.Tensor, n_completed: int):
        if self.collect_host:
            pos, neg = pos.cpu().numpy(), neg.cpu().numpy()
        self.collected.append((pos, neg))
        return pos, neg, n_completed

    def harvest(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Fetch every collected subfingerprint to the host (with
        ``collect_host=False`` this is where the host waits)."""
        self.collected = [(np.asarray(p.cpu()) if isinstance(p, torch.Tensor) else p,
                           np.asarray(n.cpu()) if isinstance(n, torch.Tensor) else n)
                          for p, n in self.collected]
        return self.collected

    def fingerprints(self) -> list[Fingerprint]:
        """One Fingerprint per stream from all collected subfingerprints."""
        self.harvest()
        length = self.config.subfingerprint_length
        if not self.collected:
            empty = np.zeros((0, self.config.num_wavelet_pairs), np.uint8)
            return [Fingerprint.from_planes(empty, empty, length)
                    for _ in range(self.batch)]
        pos = np.concatenate([p for p, _ in self.collected], axis=1)
        neg = np.concatenate([n for _, n in self.collected], axis=1)
        return [Fingerprint.from_planes(pos[i], neg[i], length) for i in range(self.batch)]


class StreamingDetective:
    """The essay's single-stream API: Start/Stop/Pause/Resume + completion
    callback.  ``process_samples`` may be called from a capture thread while
    the lifecycle methods run elsewhere; a lock orders them."""

    def __init__(self, config: FingerprintConfig | None = None,
                 chunk_size: int = 1024, device: torch.device | str = DEFAULT_DEVICE):
        self.config = config or FingerprintConfig()
        self.chunk_size = chunk_size
        self.device = resolve_device(device, "StreamingDetective")
        self._extractor: StreamingExtractor | None = None
        self._callback = None
        self._max_subfingerprints = 0
        self._running = False
        self._pending = np.zeros(0, np.float32)
        self._lock = threading.RLock()

    # -- lifecycle ----------------------------------------------------------

    def start_processing(self, max_subfingerprints: int, callback) -> None:
        with self._lock:
            self._extractor = StreamingExtractor(batch=1, chunk_size=self.chunk_size,
                                                 config=self.config, device=self.device)
            self._callback = callback
            self._max_subfingerprints = max_subfingerprints
            self._running = True
            self._pending = np.zeros(0, np.float32)

    def pause_processing(self) -> None:
        with self._lock:
            self._running = False

    def resume_processing(self) -> None:
        with self._lock:
            if self._extractor is None:
                raise RuntimeError("start_processing first")
            self._running = True

    def stop_processing(self) -> Fingerprint:
        """The fingerprint of everything processed so far."""
        with self._lock:
            self._running = False
            if self._extractor is None:
                raise RuntimeError("start_processing first")
            return self._extractor.fingerprints()[0]

    # -- data ingestion (the render-callback analogue) ----------------------

    def process_samples(self, samples: np.ndarray) -> None:
        """Feed mono float32 samples at the processing rate; calls the
        completion callback once ``max_subfingerprints`` frames are done."""
        with self._lock:
            if not self._running:
                return
            ext = self._extractor
            self._pending = np.concatenate([self._pending, np.asarray(samples, np.float32)])
            while self._running and self._pending.shape[0] >= self.chunk_size:
                chunk = self._pending[None, :self.chunk_size]
                self._pending = self._pending[self.chunk_size:]
                ext.feed(chunk)
                if sum(p.shape[1] for p, _ in ext.collected) >= self._max_subfingerprints:
                    self._running = False
                    if self._callback is not None:
                        self._callback(self.stop_processing())
                    break
