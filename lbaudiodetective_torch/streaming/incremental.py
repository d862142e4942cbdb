"""Incremental streaming library matching: O(new subfingerprints) per tick
(port of the JAX package's ``streaming/incremental.py``).

The quirk-Q10 offset-slide score (LBAudioDetectiveFingerprint.m:119-176) is
a max over banded-diagonal means, and each diagonal's sum is a running sum
over query subfingerprints: a new subfingerprint only appends terms.  This
module keeps those sums as device state:

  orientation A (entry is fp1, used while n <= n_lib):
      D_A[b, e, d] = sum_{i<n} hits[e, d+i, i] * inv_lib[e, d+i]
  orientation B (query is fp1, used once n > n_lib):
      D_B[b, e, d] = sum_{j<n_lib} hits[e, j, d+j] * inv_q[d+j]

so a tick costs O(k * S * L) for k new subfingerprints, whatever the
stream's age.  Scores are bitwise equal to ``match_one_vs_many_padded`` on
the accumulated planes, and so to the packed matcher (the match kernel on
CUDA): hit counts are exact integers, each term is rounded once as a
product and once as a sum, in that order (separate torch ops, never a fused
multiply-add), and terms arrive in ascending arrival order, the order of
``_both_orientation_scores``.

Slot updates (the session pool's) fold the posting slots alone with
``ops.kernels.slot_fold``, which counts hits from the library's packed
words: ``csrc/slot_fold.cu`` on CUDA, one launch a shard a flush.  For the
lockstep update the library planes are unpacked once, on the first
lockstep update (a pool never holds them), into one ``[L * S, 2 * pairs]``
matrix (pos | neg, masked to the compared pairs, rows past an entry's
count empty) that every clone shares.  It is
bf16, which holds every integer up to 256 exactly, at half float32's bytes
and on the tensor cores, whenever no hit count can pass 256: a count is at
most ``pairs`` (150 at subfingerprint_length 300) when no entry sets both
bits of a pair, as no extracted fingerprint does, and at most ``2 *
pairs`` when one does (``FingerprintLibrary.from_arrays`` and ``load``
accept such planes, and a posted query may hold them too).  Otherwise the
planes are float32.
The state is ``batch * L * (S + n_cap) * 4`` bytes (256 streams x 16,384
entries x (56 + 256) diagonals: 5.4 GB).  On a
``ShardedFingerprintLibrary`` the planes and the state split over the
library slots, each slot folding its own entries.
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np
import torch
import torch.nn.functional as F

from lbaudiodetective_torch.config import FingerprintConfig
from lbaudiodetective_torch.device import DEFAULT_DEVICE, library_device
from lbaudiodetective_torch.ops.kernels.match_packed import popcount32, prefix_mask_words
from lbaudiodetective_torch.ops.kernels.slot_fold import fold_arrival, inv_possible, slot_fold
from lbaudiodetective_torch.ops.match import _pair_mask
from lbaudiodetective_torch.ops.match_packed import _descending
from lbaudiodetective_torch.utils import packing

#: Largest hit count up to which bf16 holds every integer exactly.
BF16_EXACT_HITS = 256


def _unpack_words(words: torch.Tensor, pairs: int) -> torch.Tensor:
    """``[..., W]`` int32 words -> ``[..., pairs]`` {0, 1} uint8 bits
    (little-endian bit order, ``utils.packing.unpack_bits``)."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words[..., None] >> shifts) & 1                  # [..., W, 32]
    return bits.reshape(*words.shape[:-1], -1)[..., :pairs].to(torch.uint8)


def _scores_group(d_a: torch.Tensor, d_b: torch.Tensor, n_lib: torch.Tensor,
                  n: torch.Tensor) -> torch.Tensor:
    """``[G, L]`` scores from the accumulators (selection and masks as in
    ``ops.match._both_orientation_scores``).  ``n`` is the stream age:
    ``[1]`` for lockstep streams or ``[G]`` per slot."""
    s, d_cap = d_a.shape[-1], d_b.shape[-1]
    dev = d_a.device
    nn = n.reshape(-1, 1)                                    # [1, 1] or [G, 1]
    means_a = d_a / torch.clamp(nn, min=1).to(torch.float32)[..., None]
    valid_a = torch.arange(s, device=dev)[None, None, :] <= (n_lib[None, :] - nn)[..., None]
    score_a = torch.where(valid_a, means_a, torch.zeros_like(means_a)).amax(-1)
    score_a = torch.where(nn > 0, score_a, torch.zeros_like(score_a))
    means_b = d_b / torch.clamp(n_lib, min=1).to(torch.float32)[None, :, None]
    valid_b = torch.arange(d_cap, device=dev)[None, None, :] <= (nn - n_lib[None, :])[..., None]
    score_b = torch.where(valid_b, means_b, torch.zeros_like(means_b)).amax(-1)
    score_b = torch.where(n_lib[None, :] > 0, score_b, torch.zeros_like(score_b))
    return torch.where(n_lib[None, :] < nn, score_b, score_a)


def _top_k(scores: torch.Tensor, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Descending top-k of each row, ties to the lower index (``lax.top_k``;
    ``argmax`` returns the first maximum)."""
    idx = scores.argmax(1, keepdim=True) if k == 1 else _descending(scores)[:, :k]
    return (torch.gather(scores, 1, idx).cpu().numpy(), idx.cpu().numpy())


def _library_state_key(library, g: int, l: int, s: int, batch: int, pairs: int,
                       comparison_range: int, subfingerprint_length: int) -> str:
    """Library-content + geometry hash guarding checkpoint restores.  The
    words' bytes are the JAX package's (the same uint32 bit patterns, held
    as int32), so a checkpoint restores in either package."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(library.pos_words.cpu().numpy()).tobytes())
    h.update(np.ascontiguousarray(library.neg_words.cpu().numpy()).tobytes())
    h.update(np.ascontiguousarray(library.counts.cpu().numpy()).tobytes())
    h.update(f"{g},{l},{s},{batch},{pairs},{comparison_range},"
             f"{subfingerprint_length}".encode())
    return h.hexdigest()[:16]


def _planes(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.uint8, device=device)


class _Shard:
    """The library part one slot matches, on its device: its packed words
    ``[l, S, W]`` and counts ``[l]`` (the slot fold's), reciprocal possible
    hits ``[l, S]``, valid rows ``[l, S]``, whether a compared pair is set
    in both planes of a valid row (``overlap``), and the lockstep update's
    unpacked planes (:meth:`planes`).  Rows past an entry's count count as
    empty: no score reads a term of theirs."""

    def __init__(self, pos_words, neg_words, counts, pairs: int, mask: torch.Tensor):
        self.device = pos_words.device
        self.l, s, w = pos_words.shape
        self.pos_words, self.neg_words = pos_words, neg_words
        self.pairs = pairs
        valid = torch.arange(s, device=self.device)[None, :] < counts[:, None]
        self.mask = mask.to(self.device, torch.uint8)
        self.mask_pairs = int(mask.sum())               # a prefix of the pairs
        m = torch.from_numpy(prefix_mask_words(self.mask_pairs, w).view(np.int32))
        pw, nw = (torch.where(valid[..., None], x & m.to(self.device), 0)
                  for x in (pos_words, neg_words))
        self.n_lib = counts
        self.inv_lib = inv_possible((popcount32(pw) + popcount32(nw)).sum(-1)
                                    .to(torch.float32))
        self.overlap = bool((pw & nw).any())
        self.row_valid = valid.to(torch.float32)
        self._unpacked = None
        self._planes_lock = threading.Lock()

    def planes(self, dtype: torch.dtype) -> torch.Tensor:
        """The lockstep update's ``[l * S, 2 * pairs]`` planes (hits =
        planes @ [qp | qn].T, exact) in ``dtype``, unpacked on the first
        call and kept for every clone."""
        with self._planes_lock:
            if self._unpacked is None:
                valid = self.row_valid.to(torch.uint8)[..., None]
                lp, ln = (_unpack_words(x, self.pairs) * self.mask * valid
                          for x in (self.pos_words, self.neg_words))
                self._unpacked = torch.cat([lp, ln], dim=-1).reshape(
                    -1, 2 * self.pairs).to(dtype)
            return self._unpacked


class IncrementalLibraryMatcher:
    """Running Q10 scores of ``batch`` growing queries vs a library.

    ``update(new_pos, new_neg, k_valid)`` folds the next ``k_valid``
    subfingerprints of every stream in (arrays or tensors, which may be
    padded along the subfingerprint axis); ``scores()`` returns the
    ``[batch, L]`` scores of each stream's accumulated fingerprint, bitwise
    equal to ``match_one_vs_many_padded`` on those planes.

    ``n_cap`` is the initial orientation-B diagonal capacity; a stream that
    outgrows it doubles it (new diagonal slots are zeros, so this is exact;
    see :meth:`_grow`).  ``grow=False`` raises past ``n_cap`` instead.
    ``stream_group`` > 0 processes streams in groups of that size (bounding
    the ``[G, k, L, S]`` hit transient); the state is held per group.  The
    matcher runs on the library's device, which must be ``device``.

    A :class:`~lbaudiodetective_torch.parallel.sharded_library.
    ShardedFingerprintLibrary` is accepted too: each library slot then
    holds its shard's planes and its part of the diagonal state (no
    collective a tick), the entry axis carries the library's zero-count
    padding, and results are trimmed to the true entries.
    """

    def __init__(self, library, batch: int, n_cap: int = 256,
                 config: FingerprintConfig | None = None,
                 comparison_range: int = 0, stream_group: int = 0,
                 grow: bool = True, device: torch.device | str = DEFAULT_DEVICE):
        self.device = library_device(library, device, "IncrementalLibraryMatcher")
        self.config = config or FingerprintConfig()
        self.library = library
        self.batch = batch
        self.n_cap = n_cap
        self.grow = grow
        self.comparison_range = comparison_range
        g = stream_group or batch
        if batch % g:
            raise ValueError("stream_group must divide batch")
        self.group = g
        self.pairs = pairs = library.pairs
        sharded = getattr(library, "mesh", None) is not None
        parts = (zip(library.pos_shards, library.neg_shards, library.count_shards) if sharded
                 else [(library.pos_words, library.neg_words, library.counts)])
        mask = torch.from_numpy(_pair_mask(pairs, comparison_range,
                                           self.config.subfingerprint_length))
        self._shards = [_Shard(p, n, c, pairs, mask) for p, n, c in parts]
        self._true_l = len(library)
        # A hit count is lp . qp + ln . qn over the pairs: at most ``pairs``
        # while no entry sets both bits of a pair, whatever the query holds.
        overlap = any(sh.overlap for sh in self._shards)
        self._dtype = (torch.bfloat16 if (2 * pairs if overlap else pairs) <= BF16_EXACT_HITS
                       else torch.float32)
        s = int(library.pos_words.shape[1])
        self._geom = (g, sum(sh.l for sh in self._shards), s)
        self._state = [self._zero_state() for _ in range(batch // g)]
        self.n = 0

    def _zero_state(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """One group's ``(d_a, d_b)`` a shard."""
        g, _, s = self._geom
        return [(torch.zeros((g, sh.l, s), dtype=torch.float32, device=sh.device),
                 torch.zeros((g, sh.l, self.n_cap), dtype=torch.float32, device=sh.device))
                for sh in self._shards]

    def clone_empty(self) -> "IncrementalLibraryMatcher":
        """A fresh-state matcher sharing this one's device-resident library
        planes (the expensive part).  Serving keeps one template per
        library and mints per-session clones from it."""
        new = object.__new__(IncrementalLibraryMatcher)
        new.__dict__.update(self.__dict__)
        new._state = [new._zero_state() for _ in range(self.batch // self.group)]
        new.n = 0
        return new

    def _grow(self, needed: int, what: str) -> None:
        """Make room for stream age ``needed``.  Appending zero diagonal
        slots is exact: diagonal ``d`` receives terms only from arrivals
        ``i`` in ``[d, d + S)``, so every slot at ``d >= n`` is still zero
        at age ``n``."""
        if needed <= self.n_cap:
            return
        if not self.grow:
            raise ValueError(f"{what} {needed} exceeds n_cap={self.n_cap}")
        new_cap = max(self.n_cap * 2, needed)
        self._state = [[(d_a, F.pad(d_b, (0, new_cap - self.n_cap))) for d_a, d_b in group]
                       for group in self._state]
        self.n_cap = new_cap

    def _hits(self, sh: _Shard, qp: torch.Tensor, qn: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """``[G, k, pairs]`` query planes -> hit counts ``[G, k, l, S]``
        against shard ``sh`` in the planes' type (exact integers; each fold
        multiplies them in float32) and the queries' reciprocal possible
        hits ``[G, k]``."""
        g, k, pairs = qp.shape
        qp, qn = qp.to(sh.device), qn.to(sh.device)
        q = torch.cat([qp, qn], dim=-1).reshape(g * k, 2 * pairs).to(self._dtype)
        hits = torch.matmul(q, sh.planes(self._dtype).T).reshape(g, k, sh.l, -1)
        w_q = ((qp + qn) * sh.mask).sum(-1, dtype=torch.int32)
        return hits, inv_possible(w_q.to(torch.float32))

    def update(self, new_pos, new_neg, k_valid: int | None = None) -> None:
        """new_pos/new_neg: ``[batch, k, pairs]`` uint8 (zero-padded beyond
        ``k_valid``); every stream advances by ``k_valid`` (the lockstep
        extractor's contract)."""
        k = int(new_pos.shape[1])
        k_valid = k if k_valid is None else int(k_valid)
        self._grow(self.n + k_valid, "stream age")
        if k_valid:
            g = self.group
            qp_all = _planes(new_pos, self.device)[:, :k_valid]
            qn_all = _planes(new_neg, self.device)[:, :k_valid]
            for gi, group in enumerate(self._state):
                for sh, (d_a, d_b) in zip(self._shards, group):
                    hits, inv_q = self._hits(sh, qp_all[gi * g:(gi + 1) * g],
                                             qn_all[gi * g:(gi + 1) * g])
                    for t in range(k_valid):
                        fold_arrival(d_a, d_b, hits[:, t], sh.inv_lib, sh.row_valid,
                                     inv_q[:, t], slice(None), self.n + t)
        self.n += k_valid

    def update_bucketed(self, new_pos, new_neg) -> None:
        """The reference's update with ``k`` padded to a power of two, which
        bounds its jit shapes.  Nothing compiles per shape here, so this is
        :meth:`update` of all ``k`` columns."""
        self.update(new_pos, new_neg)

    def _scores(self, group: list, n: torch.Tensor) -> torch.Tensor:
        """``[G, L]`` scores of one group at ages ``n``, the shards' joined
        on the matcher's device and trimmed to the true entries."""
        parts = [_scores_group(d_a, d_b, sh.n_lib, n.to(sh.device)).to(self.device)
                 for sh, (d_a, d_b) in zip(self._shards, group)]
        return torch.cat(parts, dim=1)[:, :self._true_l]

    # -- slot (asynchronous-session) interface -------------------------------
    #
    # Each stream (slot) advances by its own count from its own age in one
    # batched call: the device-side primitive of pooled live sessions.  The
    # ages are the caller's: ``self.n`` is not used.

    def update_slots(self, new_pos, new_neg, k_valid, base, slots) -> int:
        """Fold ``k_valid[j]`` new subfingerprints (row ``j`` of the
        ``[G, k, pairs]`` uint8 arrays ``new_pos``/``new_neg``) of slot
        ``slots[j]`` (distinct), arriving at ages ``base[j]`` on.  Needs
        single-group state (``stream_group`` unset).  Only the rows with
        ``k_valid[j] > 0`` are folded: one ``ops.kernels.slot_fold`` call a
        shard (a kernel launch on CUDA), their words and slot table copied
        to each device in one page.  Returns the number of slots folded."""
        if len(self._state) != 1:
            raise ValueError("slot updates need single-group state "
                             "(stream_group=0)")
        k_valid = np.asarray(k_valid, np.int64)
        base = np.asarray(base, np.int64)
        slots = np.asarray(slots, np.int64)
        self._grow(int((base + k_valid).max()) if k_valid.size else 0, "slot age")
        live = np.flatnonzero(k_valid > 0)
        if not live.size:
            return 0
        k_max = int(k_valid[live].max())
        words = [packing.pack_bits(np.asarray(x, np.uint8)[live, :k_max]).view(np.int32)
                 for x in (new_pos, new_neg)]                     # [G', k_max, W]
        g, _, w = words[0].shape
        page = torch.from_numpy(np.concatenate(
            [np.stack([slots[live], base[live], k_valid[live]]).astype(np.int32).ravel(),
             words[0].ravel(), words[1].ravel()]))
        on: dict = {}
        for sh, (d_a, d_b) in zip(self._shards, self._state[0]):
            if sh.device not in on:
                on[sh.device] = (page if sh.device.type == "cpu" else
                                 page.pin_memory().to(sh.device, non_blocking=True))
            table, q = on[sh.device][:3 * g].view(3, g), on[sh.device][3 * g:].view(2, g, k_max, w)
            slot_fold(d_a, d_b, sh.pos_words, sh.neg_words, sh.n_lib, sh.inv_lib,
                      sh.mask_pairs, q[0], q[1], table[0], table[1], table[2])
        return int(g)

    def _slot_scores(self, ages, slots) -> torch.Tensor:
        """``[len(slots), L]`` scores of ``slots`` (every slot when None),
        rows in their order, at per-slot ages ``ages`` (``[batch]``).  A
        slot's scores read only its own accumulators and age, so only the
        rows asked for are scored: a view of one slot, an ``index_select``
        of several."""
        ages = np.asarray(ages, np.int64)
        group = self._state[0]
        if slots is not None:
            slots = np.asarray(slots, np.int64).reshape(-1)
            ages = ages[slots]
            if slots.size == 1:
                s = int(slots[0])
                group = [(d_a[s:s + 1], d_b[s:s + 1]) for d_a, d_b in group]
            else:
                idx = torch.from_numpy(slots)
                group = [tuple(x.index_select(0, idx.to(x.device)) for x in state)
                         for state in group]
        return self._scores(group, torch.as_tensor(ages, device=self.device))

    def scores_slots(self, ages, slots=None) -> np.ndarray:
        """``[len(slots), L]`` scores of the slots ``slots`` (``[batch, L]``
        when None) at per-slot ages ``ages`` (``[batch]``)."""
        return self._slot_scores(ages, slots).cpu().numpy()

    def top_k_slots(self, k: int, ages, slots=None) -> tuple[np.ndarray, np.ndarray]:
        """Device-side top-k (see :meth:`top_k`) of the slots ``slots``
        (every slot when None), rows in their order, at per-slot ages."""
        return _top_k(self._slot_scores(ages, slots), min(k, self._true_l))

    def reset_slot(self, slot: int) -> None:
        """Zero one slot's accumulators (slot freed for a new session)."""
        for d_a, d_b in self._state[0]:
            d_a[slot] = 0.0
            d_b[slot] = 0.0

    def slot_state(self, slot: int) -> tuple[np.ndarray, np.ndarray]:
        """One slot's accumulators ``([1, L, S], [1, L, n_cap])`` on the
        host, the shards joined along the entry axis."""
        return tuple(torch.cat([x[slot:slot + 1].cpu() for x in planes], dim=1).numpy()
                     for planes in zip(*self._state[0]))

    def set_slot_state(self, slot: int, d_a: np.ndarray, d_b: np.ndarray) -> None:
        """Write ``[L, S]`` and ``[L, <= n_cap]`` host accumulators into one
        slot (a shorter orientation-B state is zero-padded)."""
        lo = 0
        for sh, (sa, sb) in zip(self._shards, self._state[0]):
            sa[slot] = torch.from_numpy(d_a[lo:lo + sh.l]).to(sh.device)
            sb[slot] = 0.0
            sb[slot, :, :d_b.shape[-1]] = torch.from_numpy(d_b[lo:lo + sh.l]).to(sh.device)
            lo += sh.l

    # -- session persistence --------------------------------------------------
    #
    # The diagonal state fully determines the running scores and is small
    # next to the library planes, so it round-trips through one npz per
    # matcher, in the JAX package's format (the shards' state joined along
    # the padded entry axis).

    def _state_key(self) -> str:
        """Geometry + library identity a restored state must match
        (memoized; clones share it)."""
        cached = self.__dict__.get("_state_key_cache")
        if cached is None:
            g, l, s = self._geom
            cached = self._state_key_cache = _library_state_key(
                self.library, g, l, s, self.batch, self.pairs,
                self.comparison_range, self.config.subfingerprint_length)
        return cached

    def save_state(self, path: str) -> None:
        """Checkpoint the diagonal state (all stream groups) and the stream
        age; the library itself is not saved."""
        arrays = {}
        for gi, group in enumerate(self._state):
            arrays[f"da_{gi}"] = torch.cat([d_a.cpu() for d_a, _ in group], dim=1).numpy()
            arrays[f"db_{gi}"] = torch.cat([d_b.cpu() for _, d_b in group], dim=1).numpy()
        np.savez(path, n=np.int64(self.n), n_groups=np.int64(len(self._state)),
                 state_key=np.bytes_(self._state_key().encode()), **arrays)

    def restore_state(self, path: str) -> None:
        """Load a checkpoint of :meth:`save_state` (either package's) into
        this matcher.  Raises ``ValueError`` on a geometry or library
        mismatch; the orientation-B capacity becomes the checkpoint's."""
        with np.load(path) as z:
            if bytes(z["state_key"]).decode() != self._state_key():
                raise ValueError("session state was saved against a different library "
                                 "or stream geometry")
            n_groups = int(z["n_groups"])
            if n_groups != len(self._state):
                raise ValueError("stream group count mismatch")
            bounds = np.cumsum([0] + [sh.l for sh in self._shards])
            self._state = [[(torch.from_numpy(z[f"da_{gi}"][:, lo:hi]).to(sh.device),
                             torch.from_numpy(z[f"db_{gi}"][:, lo:hi]).to(sh.device))
                            for sh, lo, hi in zip(self._shards, bounds[:-1], bounds[1:])]
                           for gi in range(n_groups)]
            self.n_cap = int(self._state[0][0][1].shape[-1])
            self.n = int(z["n"])

    def scores(self) -> np.ndarray:
        """``[batch, L]`` running match scores."""
        n = torch.tensor([self.n], device=self.device)
        return torch.cat([self._scores(group, n) for group in self._state]).cpu().numpy()

    def top_k(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Device-side top-k: ``([batch, k] scores, [batch, k] indices)``,
        descending, ties to the lowest index; fetches ``k`` values a stream
        instead of the ``[batch, L]`` plane."""
        n = torch.tensor([self.n], device=self.device)
        scores = torch.cat([self._scores(group, n) for group in self._state])
        return _top_k(scores, min(k, self._true_l))


class StreamSessionPool:
    """N asynchronous live-recognition sessions sharing one slot-batched
    matcher.

    Posts are queued and all of them fold in one ``update_slots`` call per
    :meth:`flush`, over the slots of the posting sessions alone (one launch
    of ``csrc/slot_fold.cu`` a shard on CUDA); one ``top_k_slots`` then
    scores the slots of the sessions whose results are read (:meth:`top_k`
    with ``sids``), so the work of both follows the sessions that post and
    are answered, not the pool's size.  Each slot's
    scores are bitwise equal to a dedicated per-session matcher (its terms
    accumulate in its own ascending arrival order), whichever slots are
    scored with it.

    ``open(sid)`` binds a session to a free slot; ``post`` queues
    increments; ``flush`` folds them; ``top_k`` / ``scores_for`` read
    results; ``close`` frees and zeroes the slot.  Thread safety is the
    caller's (the serving edge serialises on its session lock).
    """

    def __init__(self, library, slots: int = 64, n_cap: int = 256,
                 config: FingerprintConfig | None = None,
                 comparison_range: int = 0, device: torch.device | str = DEFAULT_DEVICE):
        self._m = IncrementalLibraryMatcher(
            library, batch=slots, n_cap=n_cap, config=config,
            comparison_range=comparison_range, device=device)
        self.slots = slots
        self._free = list(range(slots - 1, -1, -1))
        self._slot: dict[str, int] = {}
        self._age = np.zeros(slots, np.int64)
        self._pending: dict[str, list[tuple[np.ndarray, np.ndarray]]] = {}
        #: The work of the latest :meth:`flush`: sessions folded, the most
        #: subfingerprints a session folded, subfingerprints folded, and the
        #: slots whose hits the fold counted (the posting sessions').
        self.last_flush = {"sessions": 0, "k_max": 0, "rows": 0, "slots_folded": 0}

    def __len__(self) -> int:
        return len(self._slot)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def open(self, sid: str) -> int:
        if sid in self._slot:
            raise ValueError(f"session {sid!r} already open")
        if not self._free:
            raise RuntimeError("no free session slots")
        slot = self._free.pop()
        self._slot[sid] = slot
        return slot

    def age(self, sid: str) -> int:
        """Folded subfingerprints of a session (pending posts excluded)."""
        return int(self._age[self._slot[sid]])

    def pending(self, sid: str) -> int:
        """Queued-but-unflushed subfingerprints of a session."""
        return sum(p.shape[0] for p, _ in self._pending.get(sid, ()))

    def post(self, sid: str, pos: np.ndarray, neg: np.ndarray) -> None:
        """Queue ``[k, pairs]`` new subfingerprints for a session."""
        if sid not in self._slot:
            raise KeyError(f"unknown session {sid!r}")
        if pos.shape[0]:
            self._pending.setdefault(sid, []).append(
                (np.asarray(pos, np.uint8), np.asarray(neg, np.uint8)))

    def flush(self) -> int:
        """Fold every queued post in one batched call over the posting
        sessions' slots; returns the number of sessions that advanced."""
        if not self._pending:
            self.last_flush = {"sessions": 0, "k_max": 0, "rows": 0, "slots_folded": 0}
            return 0
        merged = [(self._slot[sid], np.concatenate([p for p, _ in parts]),
                   np.concatenate([q for _, q in parts]))
                  for sid, parts in self._pending.items()]
        k_max = max(p.shape[0] for _, p, _ in merged)
        qp = np.zeros((len(merged), k_max, self._m.pairs), np.uint8)
        qn = np.zeros_like(qp)
        slots = np.array([g for g, _, _ in merged], np.int64)
        k_valid = np.array([p.shape[0] for _, p, _ in merged], np.int64)
        for j, (_, p, q) in enumerate(merged):
            qp[j, :p.shape[0]] = p
            qn[j, :q.shape[0]] = q
        folded = self._m.update_slots(qp, qn, k_valid, self._age[slots], slots)
        self._age[slots] += k_valid
        self._pending.clear()
        self.last_flush = {"sessions": len(merged), "k_max": k_max, "rows": int(k_valid.sum()),
                           "slots_folded": folded}
        return len(merged)

    def top_k(self, k: int, sids=None) -> tuple[np.ndarray, np.ndarray]:
        """``([n, k] scores, [n, k] indices)`` at the current ages of the
        sessions ``sids``, rows in their order, scoring only their slots;
        with ``sids`` None, every slot's (``n = slots``, rows by slot)."""
        slots = None if sids is None else [self._slot[sid] for sid in sids]
        return self._m.top_k_slots(k, self._age, slots)

    def scores_for(self, sid: str) -> np.ndarray:
        """``[L]`` scores of one session (flushed state), scoring its slot
        alone."""
        return self._m.scores_slots(self._age, [self._slot[sid]])[0]

    def close(self, sid: str) -> None:
        """Free a session's slot (dropping unflushed posts) and zero its
        state for reuse."""
        slot = self._slot.pop(sid)
        self._pending.pop(sid, None)
        self._age[slot] = 0
        self._m.reset_slot(slot)
        self._free.append(slot)

    # -- persistence (the per-session matcher's format) ------------------------

    def _session_key(self) -> str:
        cached = getattr(self, "_session_key_cache", None)
        if cached is None:
            _, l, s = self._m._geom
            cached = self._session_key_cache = _library_state_key(
                self._m.library, 1, l, s, 1, self._m.pairs,
                self._m.comparison_range, self._m.config.subfingerprint_length)
        return cached

    def save_session(self, sid: str, path: str) -> None:
        """Checkpoint one session's slot in the npz format a ``batch=1``
        :class:`IncrementalLibraryMatcher` writes, so pooled and
        per-session servers restore each other's checkpoints.  Flush
        first: unflushed posts are not device state."""
        if self._pending.get(sid):
            raise ValueError("flush before saving (pending posts)")
        slot = self._slot[sid]
        d_a, d_b = self._m.slot_state(slot)
        np.savez(path, n=np.int64(self._age[slot]), n_groups=np.int64(1),
                 state_key=np.bytes_(self._session_key().encode()), da_0=d_a, db_0=d_b)

    def restore_session(self, sid: str, path: str) -> None:
        """Restore a single-session checkpoint into an open session's slot
        (the pool grows to a larger checkpoint's capacity; a smaller one is
        zero-padded: both exact)."""
        slot = self._slot[sid]
        with np.load(path) as z:
            if bytes(z["state_key"]).decode() != self._session_key():
                raise ValueError("session state was saved against a different library "
                                 "or stream geometry")
            new_a, new_b = z["da_0"][0], z["db_0"][0]
            n = int(z["n"])
        self._m._grow(new_b.shape[-1], "checkpoint capacity")
        self._m.set_slot_state(slot, new_a, new_b)
        self._age[slot] = n
