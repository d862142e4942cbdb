"""Continuous multi-stream identification (port of the JAX package's
``streaming/identify.py``): the essay's Whistles loop (record ->
fingerprint -> identify against the server DB, PDF §3.2.4-3.2.5) for B
concurrent streams.

The lockstep :class:`~lbaudiodetective_torch.streaming.runtime.
StreamingExtractor` extracts each stream's subfingerprints on the device;
every ``match_every`` of them the accumulated fingerprints are matched
against a packed :class:`~lbaudiodetective_torch.models.library.
FingerprintLibrary` and each stream's best candidate updates.  The running
fingerprint is the whole accumulated sequence, so the scores converge to
the offline identification of the whole stream.

Two rematch modes, as in the reference:

- ``"full"`` re-matches every stream's whole fingerprint a tick: one call
  of the packed matcher for all B streams (the match kernel on CUDA, one
  launch), whose scores equal the reference's unpacked
  ``match_one_vs_many_padded`` bit for bit;
- ``"incremental"`` folds only the new subfingerprints into running
  diagonal sums (``streaming/incremental.py``), with the same scores.

The winner is the highest score, ties to the lowest library index, in both.
A :class:`~lbaudiodetective_torch.parallel.sharded_library.
ShardedFingerprintLibrary` is matched through its own ``match_many`` in
full mode (one matcher call a library slot, each query clamped to the
entries' rows, as the reference does) and split over its slots in
incremental mode.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from lbaudiodetective_torch.config import FingerprintConfig
from lbaudiodetective_torch.device import DEFAULT_DEVICE, library_device
from lbaudiodetective_torch.models.fingerprint import Fingerprint
from lbaudiodetective_torch.models.library import FingerprintLibrary
from lbaudiodetective_torch.ops.extract import bucket_subfingerprints
from lbaudiodetective_torch.ops.match_packed import match_one_vs_many_packed, pack_bits_device
from lbaudiodetective_torch.streaming.incremental import IncrementalLibraryMatcher
from lbaudiodetective_torch.streaming.runtime import StreamingExtractor


@dataclasses.dataclass
class StreamMatch:
    """Current best candidate of one stream."""

    track: int                 # library index (-1 before any match)
    score: float
    n_subfingerprints: int


class StreamingIdentifier:
    """Identify ``batch`` concurrent audio streams against a library on
    ``device`` (the library's).

    Feed fixed-size chunks with :meth:`feed` / :meth:`feed_pcm16`; every
    ``match_every`` newly completed subfingerprints the accumulated
    fingerprints are matched against the library.  :meth:`best` returns
    the running per-stream winners; :meth:`finalize` forces a last match
    and returns them.  ``match_stream_group`` > 0 folds the incremental
    mode's streams in groups of that many (it must divide ``batch``; the
    ``[G, k, L, S]`` hit transient is what it bounds); ``n_cap`` is the
    incremental state's initial diagonal capacity (it doubles as needed).
    """

    def __init__(self, library: FingerprintLibrary, batch: int,
                 chunk_size: int = 1024,
                 config: FingerprintConfig | None = None,
                 match_every: int = 4, match_stream_group: int = 0,
                 rematch: str = "full", n_cap: int = 256,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.device = library_device(library, device, "StreamingIdentifier")
        self.library = library
        self.config = config or FingerprintConfig()
        if match_stream_group and batch % match_stream_group:
            raise ValueError("match_stream_group must divide batch")
        if rematch not in ("full", "incremental"):
            raise ValueError(f"unknown rematch mode {rematch!r}")
        self.extractor = StreamingExtractor(batch=batch, chunk_size=chunk_size,
                                            config=self.config, device=self.device,
                                            collect_host=False)
        self.match_stream_group = match_stream_group
        self.rematch = rematch
        # Built here, not at the first tick: unpacking the library's planes
        # and allocating the state is the matcher's one large cost.
        self._inc = (IncrementalLibraryMatcher(library, batch, n_cap=n_cap,
                                               config=self.config,
                                               stream_group=match_stream_group,
                                               device=self.device)
                     if rematch == "incremental" else None)
        self._consumed = 0
        self.match_every = match_every
        self.batch = batch
        self._since_match = 0
        self._results = [StreamMatch(-1, 0.0, 0) for _ in range(batch)]

    # -- ingestion ------------------------------------------------------------

    def feed(self, chunk) -> int:
        _, _, n_done = self.extractor.feed(chunk)
        return self._maybe_match(n_done)

    def feed_pcm16(self, chunk_i16: np.ndarray) -> int:
        _, _, n_done = self.extractor.feed_pcm16(chunk_i16)
        return self._maybe_match(n_done)

    def _maybe_match(self, n_done: int) -> int:
        self._since_match += n_done
        if self._since_match >= self.match_every:
            self._since_match = 0
            self._match_now()
        return n_done

    # -- matching -------------------------------------------------------------

    def _accumulated(self) -> tuple[torch.Tensor, torch.Tensor, int]:
        """(pos, neg) ``[batch, n_sub, pairs]`` uint8 on the device: every
        stream's subfingerprints so far, and ``n_sub``."""
        parts = [(torch.as_tensor(p, device=self.device), torch.as_tensor(q, device=self.device))
                 for p, q in self.extractor.collected]
        if not parts:
            return None, None, 0
        pos = torch.cat([p for p, _ in parts], dim=1)
        return pos, torch.cat([q for _, q in parts], dim=1), pos.shape[1]

    def _set_results(self, scores, best, n_sub: int) -> None:
        """Each stream's winner from ``[batch]`` arrays or host tensors."""
        for b, (i, s) in enumerate(zip(best.tolist(), scores.tolist())):
            self._results[b] = StreamMatch(int(i), float(s), n_sub)

    def _full_scores(self, pos: torch.Tensor, neg: torch.Tensor, n_sub: int) -> torch.Tensor:
        """``[batch, L]`` scores of the accumulated planes: one call of the
        packed matcher (one kernel launch on CUDA)."""
        pad = (0, 0, 0, bucket_subfingerprints(n_sub) - n_sub)   # bounded launch shapes
        return match_one_vs_many_packed(
            pack_bits_device(F.pad(pos, pad)), pack_bits_device(F.pad(neg, pad)),
            torch.full((self.batch,), n_sub, dtype=torch.int32, device=self.device),
            self.library.pos_words, self.library.neg_words, self.library.counts,
            self.library.pairs, 0, self.config.subfingerprint_length)

    def _match_now(self) -> None:
        pos, neg, n_sub = self._accumulated()
        if n_sub == 0:
            return
        if self._inc is not None:
            if n_sub > self._consumed:
                self._inc.update_bucketed(pos[:, self._consumed:], neg[:, self._consumed:])
                self._consumed = n_sub
            sc, ix = self._inc.top_k(1)
            self._set_results(sc[:, 0], ix[:, 0], n_sub)
            return
        if hasattr(self.library, "mesh"):
            pos, neg = pos.cpu().numpy(), neg.cpu().numpy()
            length = self.config.subfingerprint_length
            scores = torch.from_numpy(self.library.match_many(
                [Fingerprint.from_planes(pos[b], neg[b], length) for b in range(self.batch)]))
        else:
            scores = self._full_scores(pos, neg, n_sub)
        best = scores.argmax(1)                      # the first maximum: ties to the lowest index
        self._set_results(torch.gather(scores, 1, best[:, None])[:, 0].cpu(),
                          best.cpu(), n_sub)

    # -- results --------------------------------------------------------------

    def best(self) -> list[StreamMatch]:
        return list(self._results)

    def finalize(self) -> list[StreamMatch]:
        self._match_now()
        return self.best()
