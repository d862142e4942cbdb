"""FingerprintLibrary: a device-resident, packed fingerprint database (port
of the JAX package's ``models/library.py``).

Entries live packed on one torch device (two planes of uint32 bit patterns,
held as int32), every match runs the packed matcher
(``ops.match_packed``: the Hopper popcount kernel on CUDA), and the
database round-trips through the reference's npz format, byte-compatible
with the JAX package's ``FingerprintLibrary.save``/``load``.

The JAX library calls ``config.warn_if_unvalidated_for_identification()``
on every identify entry point; the port's config has no such check: its
kernels compute at one precision whatever ``matmul_precision`` says, as the
reference's exempt CPU backend does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lbaudiodetective_torch.config import FingerprintConfig
from lbaudiodetective_torch.device import DEFAULT_DEVICE, resolve_device
from lbaudiodetective_torch.models.fingerprint import Fingerprint
from lbaudiodetective_torch.utils import packing, serialize
from lbaudiodetective_torch.ops.extract import bucket_subfingerprints
from lbaudiodetective_torch.ops.match_packed import (
    entries_per_call, match_one_vs_many_packed, pack_bits_device,
    phase_strided_query_planes, two_stage_search_packed)

#: Library entries per call of the plain matcher (bounds its hit planes).
CHUNK = 65536


def stack_query_planes(queries: list[Fingerprint], s: int
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack query fingerprints into zero-padded ``[B, s, pairs]`` uint8
    planes + ``[B]`` counts (clamped to ``s``)."""
    b = len(queries)
    pairs = queries[0].pairs
    qp = np.zeros((b, s, pairs), np.uint8)
    qn = np.zeros_like(qp)
    nq = np.zeros(b, np.int32)
    for i, q in enumerate(queries):
        n = min(q.num_subfingerprints, s)
        nq[i] = n
        qp[i, :n] = q.pos[:n]
        qn[i, :n] = q.neg[:n]
    return qp, qn, nq


def pack_fingerprints(fps: list[Fingerprint], s: int, w: int
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``[len(fps), s, w]`` uint32 planes + int32 counts."""
    pos = np.zeros((len(fps), s, w), np.uint32)
    neg = np.zeros_like(pos)
    counts = np.zeros(len(fps), np.int32)
    for i, f in enumerate(fps):
        pw, nw = f.packed()
        counts[i] = f.num_subfingerprints
        pos[i, :pw.shape[0]] = pw
        neg[i, :nw.shape[0]] = nw
    return pos, neg, counts


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A tensor over ``a`` (copied only when ``a`` is read-only or strided)."""
    return torch.from_numpy(np.require(a, requirements=["C", "W"]))


def _words(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in (np.uint32, np.int32):
        raise TypeError(f"packed words must be uint32 or int32, got {a.dtype}")
    return _host_tensor(a.view(np.int32)).to(device)


class FingerprintLibrary:
    def __init__(self, pos_words: torch.Tensor, neg_words: torch.Tensor,
                 counts: torch.Tensor, pairs: int,
                 config: FingerprintConfig | None = None):
        """Adopt device-resident state: ``[L, S, W]`` int32 words (uint32
        bit patterns) and ``[L]`` int32 counts, all on one device.  Host
        arrays enter through :meth:`from_arrays`."""
        if pos_words.dtype != torch.int32 or neg_words.dtype != torch.int32 \
                or counts.dtype != torch.int32:
            raise TypeError("FingerprintLibrary holds int32 words and counts")
        if pos_words.dim() != 3 or neg_words.shape != pos_words.shape \
                or counts.shape != pos_words.shape[:1]:
            raise ValueError("words must be [L, S, W] (pos and neg alike), counts [L]")
        if pos_words.shape[2] != packing.words_per_plane(pairs):
            raise ValueError(f"{pairs} pairs need {packing.words_per_plane(pairs)} "
                             f"words per row, got {pos_words.shape[2]}")
        if len({pos_words.device, neg_words.device, counts.device}) != 1:
            raise ValueError("words and counts must share one device")
        if len(counts) and not 0 <= int(counts.min()) <= int(counts.max()) <= pos_words.shape[1]:
            raise ValueError(f"counts must lie in [0, {pos_words.shape[1]}]")
        self.config = config or FingerprintConfig()
        self.pos_words = pos_words
        self.neg_words = neg_words
        self.counts = counts
        self.pairs = pairs
        self.device = pos_words.device
        self._coarse_cache: dict = {}                # (stride, chunk) -> planes

    # -- construction --------------------------------------------------------

    @classmethod
    def from_arrays(cls, pos_words: np.ndarray, neg_words: np.ndarray,
                    counts: np.ndarray, pairs: int,
                    config: FingerprintConfig | None = None,
                    device: torch.device | str = DEFAULT_DEVICE) -> "FingerprintLibrary":
        """A library on ``device`` from host state: ``[L, S, W]`` uint32 (or
        int32) words and ``[L]`` counts, e.g. a JAX library's
        ``np.asarray(lib.pos_words)``, ``neg_words``, ``counts``."""
        device = resolve_device(device, "FingerprintLibrary")
        return cls(_words(pos_words, device), _words(neg_words, device),
                   _host_tensor(np.asarray(counts, np.int32)).to(device),
                   pairs, config)

    @classmethod
    def from_fingerprints(cls, fps: list[Fingerprint],
                          config: FingerprintConfig | None = None,
                          device: torch.device | str = DEFAULT_DEVICE) -> "FingerprintLibrary":
        if not fps:
            raise ValueError("empty library")
        pairs = fps[0].pairs
        s_max = bucket_subfingerprints(max(f.num_subfingerprints for f in fps))
        pos, neg, counts = pack_fingerprints(fps, s_max, packing.words_per_plane(pairs))
        return cls.from_arrays(pos, neg, counts, pairs, config, device)

    def __len__(self) -> int:
        return int(self.pos_words.shape[0])

    def extend(self, fps: list[Fingerprint]) -> "FingerprintLibrary":
        """A new library with ``fps`` appended (incremental enrollment).
        Existing entries are copied on the device; only the new fingerprints
        are packed, and the subfingerprint axis re-pads to the larger bucket
        when a new entry is longer."""
        if not fps:
            return self
        if any(f.pairs != self.pairs for f in fps):
            raise ValueError("fingerprint pair count mismatch")
        l, s_old, w = self.pos_words.shape
        s_max = max(s_old, bucket_subfingerprints(max(f.num_subfingerprints for f in fps)))
        new = pack_fingerprints(fps, s_max, w)
        planes = []
        for old, add in zip((self.pos_words, self.neg_words), new[:2]):
            grown = torch.zeros((l + len(fps), s_max, w), dtype=torch.int32,
                                device=self.device)
            grown[:l, :s_old] = old
            grown[l:] = _words(add, self.device)
            planes.append(grown)
        counts = torch.cat([self.counts, torch.from_numpy(new[2]).to(self.device)])
        return FingerprintLibrary(*planes, counts, self.pairs, self.config)

    # -- matching -------------------------------------------------------------

    def _coarse_planes(self, coarse_stride: int, chunk: int):
        """Strided + chunk-padded library planes for the coarse pass, cached
        per (stride, chunk).  Returns ``(lp_c, ln_c, cnt_c, chunk)`` with
        ``chunk`` clamped so tiny libraries are not padded up."""
        chunk = min(chunk, len(self))
        key = (coarse_stride, chunk)
        if key not in self._coarse_cache:
            pad = (-len(self)) % chunk
            self._coarse_cache[key] = (
                F.pad(self.pos_words[:, ::coarse_stride], (0, 0, 0, 0, 0, pad)),
                F.pad(self.neg_words[:, ::coarse_stride], (0, 0, 0, 0, 0, pad)),
                F.pad((self.counts + coarse_stride - 1) // coarse_stride, (0, pad)))
        return (*self._coarse_cache[key], chunk)

    def _query_words(self, qp: np.ndarray, qn: np.ndarray
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        return (pack_bits_device(torch.from_numpy(qp).to(self.device)),
                pack_bits_device(torch.from_numpy(qn).to(self.device)))

    def _scores(self, queries: list[Fingerprint], comparison_range: int,
                chunk: int) -> np.ndarray:
        """``[B, L]`` scores: ``chunk`` entries per call of the plain
        version, one kernel launch on CUDA (``entries_per_call``)."""
        qp, qn, nq = stack_query_planes(queries, int(self.pos_words.shape[1]))
        qpw, qnw = self._query_words(qp, qn)
        nq = torch.from_numpy(nq).to(self.device)
        step = entries_per_call(len(self), chunk, self.device)
        scores = torch.cat([
            match_one_vs_many_packed(
                qpw, qnw, nq, self.pos_words[s:s + step], self.neg_words[s:s + step],
                self.counts[s:s + step], self.pairs, comparison_range,
                self.config.subfingerprint_length)
            for s in range(0, len(self), step)], dim=1)
        return scores.cpu().numpy()

    def match(self, query: Fingerprint, comparison_range: int = 0,
              chunk: int = CHUNK) -> np.ndarray:
        """``[L]`` match scores of a query against every entry (``chunk``
        entries per call of the plain version; the kernel scans all in one
        launch)."""
        return self._scores([query], comparison_range, chunk)[0]

    def match_many(self, queries: list[Fingerprint],
                   comparison_range: int = 0) -> np.ndarray:
        """``[B, L]`` match scores of B queries against every entry (each
        matcher call serves all B queries)."""
        if not queries:
            return np.zeros((0, len(self)), np.float32)
        return self._scores(queries, comparison_range, CHUNK)

    def identify(self, query: Fingerprint, comparison_range: int = 0
                 ) -> tuple[int, float]:
        """(best entry index, score)."""
        scores = self.match(query, comparison_range)
        best = int(np.argmax(scores))
        return best, float(scores[best])

    def search(self, query: Fingerprint, top_k: int = 5,
               comparison_range: int = 0, shortlist: int = 1024,
               coarse_range: int = 64, coarse_stride: int = 4,
               chunk: int = CHUNK, coarse_phases: int | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """Two-stage library search: coarse shortlist, exact re-score.

        The coarse pass runs the packed matcher over every
        ``coarse_stride``-th subfingerprint with ``coarse_range`` booleans
        compared, over all ``coarse_stride`` phases of the strided query
        (``coarse_phases=None``; see ``phase_strided_query_planes``), and
        shortlists ``shortlist`` candidates that are re-scored exactly by
        the full matcher.  Returns ``(indices[top_k], scores[top_k])``
        sorted by descending exact score.  The scores are exact; the
        ranking is exact whenever the true top-k survive the shortlist.  A
        library of at most ``shortlist`` entries is sorted exactly.
        """
        idx, scores = self.search_many([query], top_k, comparison_range, shortlist,
                                       coarse_range, coarse_stride, chunk, coarse_phases)
        return idx[0], scores[0]

    def search_many(self, queries: list[Fingerprint], top_k: int = 5,
                    comparison_range: int = 0, shortlist: int = 1024,
                    coarse_range: int = 64, coarse_stride: int = 4,
                    chunk: int = CHUNK, coarse_phases: int | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched ``search``: ``(indices [B, top_k], exact scores
        [B, top_k])``."""
        if not queries:
            return (np.zeros((0, top_k), np.int64),
                    np.zeros((0, top_k), np.float32))
        l = len(self)
        if l <= shortlist:
            scores = self._scores(queries, comparison_range, chunk)
            idx = np.argsort(-scores, axis=1, kind="stable")[:, :top_k]
            return idx.astype(np.int64), np.take_along_axis(scores, idx, axis=1)
        top_k = min(top_k, l, shortlist)
        qp, qn, nq = stack_query_planes(queries, int(self.pos_words.shape[1]))
        lp_c, ln_c, cnt_c, chunk = self._coarse_planes(coarse_stride, chunk)
        qcp, qcn, nc = phase_strided_query_planes(qp, qn, nq, coarse_stride,
                                                  coarse_phases)
        idx, scores = two_stage_search_packed(
            *self._query_words(qp, qn), nq, *self._query_words(qcp, qcn), nc,
            self.pos_words, self.neg_words, self.counts, lp_c, ln_c, cnt_c,
            self.pairs, comparison_range, self.config.subfingerprint_length,
            coarse_range, chunk, shortlist, top_k)
        return idx.cpu().numpy().astype(np.int64), scores.cpu().numpy()

    # -- persistence ----------------------------------------------------------

    def save(self, path: str) -> None:
        """The JAX package's npz format: uint32 words, int32 counts and the
        configuration's parameter hash."""
        np.savez_compressed(
            path, version=np.int32(serialize.FORMAT_VERSION),
            pos=self.pos_words.cpu().numpy().view(np.uint32),
            neg=self.neg_words.cpu().numpy().view(np.uint32),
            counts=self.counts.cpu().numpy(), pairs=np.int32(self.pairs),
            subfingerprint_length=np.int32(self.config.subfingerprint_length),
            params_hash=np.bytes_(
                serialize.config_params_hash(self.config).encode()))

    @classmethod
    def load(cls, path: str, config: FingerprintConfig | None = None,
             device: torch.device | str = DEFAULT_DEVICE) -> "FingerprintLibrary":
        with np.load(path) as z:
            if config is not None:
                stored = bytes(z["params_hash"]).decode()
                if stored != serialize.config_params_hash(config):
                    raise ValueError("library parameter hash mismatch")
            else:
                # Without a caller config, honour the stored subfingerprint
                # length: a library built at a non-default length must not
                # match over the wrong pair count.
                stored_len = int(z["subfingerprint_length"])
                if stored_len != FingerprintConfig().subfingerprint_length:
                    config = FingerprintConfig(subfingerprint_length=stored_len)
            return cls.from_arrays(z["pos"], z["neg"], z["counts"], int(z["pairs"]),
                                   config, device)
