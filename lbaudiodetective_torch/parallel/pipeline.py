"""Pipeline parallelism: overlapped decode -> extract -> match batches (port
of the JAX package's ``parallel/pipeline.py``).

PyTorch enqueues CUDA work without waiting for it, so a host-side software
pipeline overlaps the stages: while batch k extracts and matches on the
card, the host pads batch k + 1, and batch k - 1's scores come back.  Two
things would make it serial on one stream: a pageable host-to-device copy
(the host waits for the stream to drain) and a ``.cpu()`` of the previous
scores issued after the current batch (it waits for the current batch
too).  So a batch is staged through pinned memory with a non-blocking copy,
each batch's scores go into a pinned buffer right after its match with an
event recorded behind the copy, and ``submit`` waits on the previous
batch's event only.  Every match is a call of the packed matcher (the
match kernel on CUDA) on the library packed once on its device; scores
equal ``ops.match.match_one_vs_many_padded``'s.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from lbaudiodetective_torch.config import FingerprintConfig
from lbaudiodetective_torch.device import DEFAULT_DEVICE, resolve_device, to_device
from lbaudiodetective_torch.ops.extract import (
    bucket_subfingerprints, extract_fingerprint_padded, required_padded_length,
    rows_for_subfingerprints)
from lbaudiodetective_torch.ops.match_packed import match_one_vs_many_packed, pack_bits_device
from lbaudiodetective_torch.parallel.mesh import Slot, shard, submesh, unshard
from lbaudiodetective_torch.parallel.sharded_packed import match_many_library_sharded_packed


def _padded_batch(config: FingerprintConfig, audio_batch: np.ndarray, n_subs: np.ndarray
                  ) -> tuple[np.ndarray, int]:
    """The batch zero-padded (or cut) to its row bucket's length, and the
    bucket's row count."""
    bucket = bucket_subfingerprints(int(n_subs.max(initial=1)))
    n_rows = rows_for_subfingerprints(config, bucket)
    t_pad = required_padded_length(config, n_rows)
    batch = np.zeros((audio_batch.shape[0], t_pad), np.float32)
    t = min(audio_batch.shape[1], t_pad)
    batch[:, :t] = audio_batch[:, :t]
    return batch, n_rows


def _packed_library(library_pos, library_neg, library_counts, device: torch.device):
    """``[L, S, pairs]`` uint8 planes -> int32 words and counts on ``device``."""
    pos, neg = (pack_bits_device(to_device(np.asarray(x, np.uint8), device))
                for x in (library_pos, library_neg))
    return pos, neg, to_device(np.asarray(library_counts, np.int32), device)


class _Pending:
    """A batch's scores in flight: a pinned host buffer being filled behind
    an event (or, on the CPU, the scores themselves).  The result is a copy:
    a pinned buffer the caller kept would be lost to the caching host
    allocator, and allocating a new one synchronises the device."""

    def __init__(self, scores: torch.Tensor):
        if scores.device.type == "cuda":
            self.host = torch.empty(scores.shape, dtype=scores.dtype, pin_memory=True)
            self.host.copy_(scores, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(scores.device))
        else:
            self.host, self.event = scores, None

    def result(self) -> np.ndarray:
        if self.event is None:
            return self.host.numpy()
        self.event.synchronize()
        return self.host.numpy().copy()


class PipelinedIdentifier:
    """Identify a stream of decoded clip batches against a library with
    decode / extract / match overlap.

    ``library_*``: padded uint8 planes ``[L, S, pairs]`` and ``[L]``
    counts, packed once on ``device`` (the card by default).  Feed batches
    with :meth:`submit`; each returns the previous batch's ``[B, L]``
    scores (a two-deep software pipeline); :meth:`drain` flushes."""

    def __init__(self, library_pos, library_neg, library_counts,
                 config: FingerprintConfig | None = None,
                 comparison_range: int = 0,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.config = config or FingerprintConfig()
        self.device = resolve_device(device, "PipelinedIdentifier")
        self.pairs = int(np.shape(library_pos)[-1])
        self.lib_pos, self.lib_neg, self.lib_counts = _packed_library(
            library_pos, library_neg, library_counts, self.device)
        self.comparison_range = comparison_range
        self._pending: _Pending | None = None

    def _extract(self, audio_batch: np.ndarray, n_subs: np.ndarray):
        batch, n_rows = _padded_batch(self.config, audio_batch, n_subs)
        return extract_fingerprint_padded(
            to_device(batch, self.device), to_device(n_subs.astype(np.int32), self.device),
            self.config, n_rows)

    def _match(self, pos: torch.Tensor, neg: torch.Tensor, n_subs) -> torch.Tensor:
        """``[B, L]`` scores of the extracted planes: one call of the packed
        matcher for the batch."""
        return match_one_vs_many_packed(
            pack_bits_device(pos), pack_bits_device(neg),
            to_device(np.asarray(n_subs, np.int32), self.device), self.lib_pos, self.lib_neg,
            self.lib_counts, self.pairs, self.comparison_range,
            self.config.subfingerprint_length)

    def submit(self, audio_batch: np.ndarray, n_subs: np.ndarray):
        """Enqueue one batch; returns the previous batch's scores (or
        None).  Waits only for the previous batch's scores."""
        pos, neg = self._extract(audio_batch, n_subs)
        out, self._pending = self._pending, _Pending(self._match(pos, neg, n_subs))
        return None if out is None else out.result()

    def drain(self):
        """Flush the last in-flight batch."""
        out, self._pending = self._pending, None
        return None if out is None else out.result()

    def run(self, batches: Iterable[tuple[np.ndarray, np.ndarray]]) -> Iterator[np.ndarray]:
        for audio, n_subs in batches:
            out = self.submit(audio, n_subs)
            if out is not None:
                yield out
        tail = self.drain()
        if tail is not None:
            yield tail


class DeviceSplitPipeline(PipelinedIdentifier):
    """Pipeline with the stages on disjoint slots: extraction data-parallel
    on ``extract_slots``, matching library-sharded on ``match_slots``
    (``Slot`` objects of one mesh, e.g. ``mesh.slots.flat[:2]`` and
    ``[2:]``).  The extracted planes hand over to the match slots with a
    device copy (none where the slots share a device).  Slots of one card
    share it: the stages then overlap only as asynchronous enqueue does."""

    def __init__(self, library_pos, library_neg, library_counts,
                 extract_slots, match_slots,
                 config: FingerprintConfig | None = None,
                 comparison_range: int = 0):
        extract_slots, match_slots = list(extract_slots), list(match_slots)
        if not all(isinstance(s, Slot) for s in extract_slots + match_slots):
            raise TypeError("extract_slots and match_slots take a mesh's Slot objects")
        if {s.index for s in extract_slots} & {s.index for s in match_slots}:
            raise ValueError("extract/match slot sets must be disjoint")
        if len(library_pos) % len(match_slots):
            raise ValueError("library size must divide the match submesh")
        self.mesh_x = submesh(extract_slots, "data")
        self.mesh_m = submesh(match_slots, "library")
        self.mesh_x.require_local("data", "DeviceSplitPipeline")
        self.mesh_m.require_local("library", "DeviceSplitPipeline")
        super().__init__(library_pos, library_neg, library_counts, config, comparison_range,
                         device=match_slots[0].device)
        self.lib_shards = [shard(x, self.mesh_m, "library")
                           for x in (self.lib_pos, self.lib_neg, self.lib_counts)]

    def _extract(self, audio_batch: np.ndarray, n_subs: np.ndarray):
        """Per-slot ``(pos, neg)`` shards of the batch, each extracted on
        its slot."""
        batch, n_rows = _padded_batch(self.config, audio_batch, n_subs)
        first = self.mesh_x.axis_slots("data")[0].device
        out = [extract_fingerprint_padded(a, n, self.config, n_rows) for a, n in zip(
            shard(to_device(batch, first), self.mesh_x, "data"),
            shard(to_device(n_subs.astype(np.int32), first), self.mesh_x, "data"))]
        return [p for p, _ in out], [q for _, q in out]

    def _match(self, pos: list, neg: list, n_subs) -> torch.Tensor:
        """Hand the planes to the match slots (replicated) and match every
        shard there; ``[B, L]`` on the first match slot's device."""
        b = len(n_subs)
        qp, qn = (pack_bits_device(unshard([x.to(self.device) for x in planes])[:b])
                  for planes in (pos, neg))
        scores = match_many_library_sharded_packed(
            qp, qn, to_device(np.asarray(n_subs, np.int32), self.device), *self.lib_shards,
            self.pairs, self.mesh_m, self.comparison_range, self.config.subfingerprint_length)
        return unshard(scores, dim=1)
