"""The Fingerprint value type.

Mirrors the reference's LBAudioDetectiveFingerprint container
(LBAudioDetectiveFingerprint.{h,m}): a sequence of fixed-length binary
subfingerprints with copy/equality/compare semantics — but as an immutable
array-backed value instead of an opaque realloc-grown ref.  Bits are held as
two {0,1} uint8 planes (pos, neg) of shape ``[n_sub, pairs]`` in rank order;
``packed()`` yields the canonical uint32 storage form.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from lbaudiodetective_torch.utils import packing


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    pos: np.ndarray                    # [n_sub, pairs] uint8 in {0,1}
    neg: np.ndarray                    # [n_sub, pairs] uint8 in {0,1}
    subfingerprint_length: int = 200   # stored booleans per subfingerprint

    def __post_init__(self):
        if self.pos.shape != self.neg.shape:
            raise ValueError("pos/neg shape mismatch")

    # -- reference getter analogues (LBAudioDetectiveFingerprint.m:64-76) ---

    @property
    def num_subfingerprints(self) -> int:
        return int(self.pos.shape[0])

    @property
    def pairs(self) -> int:
        return int(self.pos.shape[1])

    def subfingerprint_booleans(self, index: int) -> np.ndarray:
        """The stored boolean array of one subfingerprint, in the reference's
        interleaved layout: bool[2j] = pos, bool[2j+1] = neg (quirk Q1)."""
        out = np.zeros(self.subfingerprint_length, dtype=np.uint8)
        out[0::2] = self.pos[index][: (self.subfingerprint_length + 1) // 2]
        out[1::2] = self.neg[index][: self.subfingerprint_length // 2]
        return out

    # -- value semantics (LBAudioDetectiveFingerprintCopy / EqualTo) --------

    def copy(self) -> "Fingerprint":
        return Fingerprint(self.pos.copy(), self.neg.copy(), self.subfingerprint_length)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Fingerprint):
            return NotImplemented
        return (self.subfingerprint_length == other.subfingerprint_length
                and self.pos.shape == other.pos.shape
                and bool(np.array_equal(self.pos, other.pos))
                and bool(np.array_equal(self.neg, other.neg)))

    def __hash__(self):
        return hash((self.subfingerprint_length, self.pos.tobytes(), self.neg.tobytes()))

    # -- packed storage form ------------------------------------------------

    def packed(self) -> tuple[np.ndarray, np.ndarray]:
        """(pos_words, neg_words) uint32 ``[n_sub, ceil(pairs/32)]``."""
        return packing.pack_bits(self.pos), packing.pack_bits(self.neg)

    @classmethod
    def from_packed(cls, pos_words: np.ndarray, neg_words: np.ndarray,
                    pairs: int, subfingerprint_length: int = 200) -> "Fingerprint":
        return cls(packing.unpack_bits(pos_words, pairs),
                   packing.unpack_bits(neg_words, pairs), subfingerprint_length)

    @classmethod
    def from_planes(cls, pos: np.ndarray, neg: np.ndarray,
                    subfingerprint_length: int = 200) -> "Fingerprint":
        return cls(np.ascontiguousarray(pos, np.uint8),
                   np.ascontiguousarray(neg, np.uint8), subfingerprint_length)

    # -- golden string form ---------------------------------------------------

    def to_string(self) -> str:
        """Human-readable golden form: per subfingerprint the stored booleans
        as a '0'/'1' digit string (interleaved Q1 layout), subfingerprints
        joined by '+'.  Matches the reference tests' stringFromFingerprint
        serializer (LBAudioDetectiveTests.m:22-37)."""
        return "+".join(
            "".join("1" if b else "0" for b in self.subfingerprint_booleans(i))
            for i in range(self.num_subfingerprints))

    @classmethod
    def from_string(cls, s: str, subfingerprint_length: int | None = None) -> "Fingerprint":
        """Inverse of :meth:`to_string` (the reference sketches only the
        forward direction)."""
        subs = s.split("+") if s else []
        if not subs:
            return cls(np.zeros((0, 0), np.uint8), np.zeros((0, 0), np.uint8),
                       subfingerprint_length or 200)
        length = len(subs[0])
        if subfingerprint_length is None:
            subfingerprint_length = length
        if any(len(x) != length for x in subs):
            raise ValueError("inconsistent subfingerprint lengths")
        bits = np.array([[c == "1" for c in x] for x in subs], dtype=np.uint8)
        pairs = (length + 1) // 2
        pos = np.zeros((len(subs), pairs), np.uint8)
        neg = np.zeros((len(subs), pairs), np.uint8)
        pos[:, : (length + 1) // 2] = bits[:, 0::2]
        neg[:, : length // 2] = bits[:, 1::2]
        return cls(pos, neg, subfingerprint_length)

    def compare(self, other: "Fingerprint", comparison_range: int = 0,
                device: str = "cuda") -> float:
        """Offset-sliding match score in [0, 1]
        (LBAudioDetectiveFingerprintCompareToFingerprint), computed on
        ``device`` (``match_fingerprints``)."""
        from lbaudiodetective_torch.ops.match import match_fingerprints

        return match_fingerprints((self.pos, self.neg), (other.pos, other.neg),
                                  comparison_range, self.subfingerprint_length, device)


class FingerprintBuilder:
    """Mutable reference-style incremental fingerprint builder.

    Mirrors the builder half of the reference container
    (LBAudioDetectiveFingerprintNew/SetSubfingerprintLength/AddSubfingerprint,
    LBAudioDetectiveFingerprint.m:18-26,81-100): subfingerprints are appended
    as interleaved boolean buffers; the length is settable only while the
    container is empty; each append copies exactly ``subfingerprint_length``
    booleans from the input buffer (so passing the 2x extraction buffer keeps
    only its first half — quirk Q1).  Exposes the same read surface as the
    immutable :class:`Fingerprint` (``pos``/``neg`` planes, booleans, string
    form) so every container-level compat function accepts either;
    :meth:`freeze` snapshots into the immutable value type.
    """

    def __init__(self, subfingerprint_length: int = 200):
        self._length = int(subfingerprint_length)
        self._subs: list[np.ndarray] = []       # interleaved {0,1} uint8 rows

    # -- builder surface ----------------------------------------------------

    @property
    def subfingerprint_length(self) -> int:
        return self._length

    def set_subfingerprint_length(self, length: int) -> tuple[bool, int]:
        """Returns ``(accepted, effective_length)``: the length is locked once
        any subfingerprint has been added (Fingerprint.m:81-89, where the
        in/out pointer is rewritten to the locked value on refusal)."""
        if self._subs:
            return False, self._length
        self._length = int(length)
        return True, self._length

    def add_subfingerprint(self, booleans: np.ndarray) -> None:
        """Append a subfingerprint, copying the first ``subfingerprint_length``
        booleans (zero-padded if the input is shorter, as the reference's
        calloc+memcpy of a short buffer would leave trailing zeros)."""
        buf = np.asarray(booleans).astype(bool).astype(np.uint8).ravel()
        row = np.zeros(self._length, np.uint8)
        n = min(self._length, buf.shape[0])
        row[:n] = buf[:n]
        self._subs.append(row)

    def clear(self) -> None:
        self._subs.clear()

    # -- Fingerprint-compatible read surface --------------------------------

    @property
    def num_subfingerprints(self) -> int:
        return len(self._subs)

    @property
    def pairs(self) -> int:
        return (self._length + 1) // 2

    @property
    def pos(self) -> np.ndarray:
        out = np.zeros((len(self._subs), self.pairs), np.uint8)
        for i, row in enumerate(self._subs):
            out[i, : (self._length + 1) // 2] = row[0::2]
        return out

    @property
    def neg(self) -> np.ndarray:
        out = np.zeros((len(self._subs), self.pairs), np.uint8)
        for i, row in enumerate(self._subs):
            out[i, : self._length // 2] = row[1::2]
        return out

    def subfingerprint_booleans(self, index: int) -> np.ndarray:
        return self._subs[index].copy()

    def freeze(self) -> Fingerprint:
        return Fingerprint(self.pos, self.neg, self._length)

    def copy(self) -> "FingerprintBuilder":
        dup = FingerprintBuilder(self._length)
        dup._subs = [row.copy() for row in self._subs]
        return dup

    def to_string(self) -> str:
        return self.freeze().to_string()

    def compare(self, other, comparison_range: int = 0, device: str = "cuda") -> float:
        return self.freeze().compare(
            other.freeze() if isinstance(other, FingerprintBuilder) else other,
            comparison_range, device)

    def __eq__(self, other) -> bool:
        if isinstance(other, (FingerprintBuilder, Fingerprint)):
            return self.freeze() == (
                other.freeze() if isinstance(other, FingerprintBuilder) else other)
        return NotImplemented


def compare_subfingerprint_booleans(sub1: np.ndarray, sub2: np.ndarray,
                                    comparison_range: int,
                                    subfingerprint_length: int) -> float:
    """Quirk-Q10 similarity of two raw interleaved boolean buffers
    (LBAudioDetectiveFingerprintCompareSubfingerprints,
    LBAudioDetectiveFingerprint.m:151-176): bit-pairs where ``sub1`` is
    non-zero count as possible hits; exact 2-bit equality counts a hit;
    returns hits/possibleHits, 0 when no possible hits."""
    s1 = np.asarray(sub1).astype(bool).ravel()
    s2 = np.asarray(sub2).astype(bool).ravel()
    n = min(int(comparison_range), int(subfingerprint_length),
            s1.shape[0], s2.shape[0])
    # Quirk Q11: an odd range rounds UP to a full pair — the reference's
    # loop runs i < range step 2 and then reads booleans i AND i+1
    # (LBAudioDetectiveFingerprint.m:155-169), exactly as the oracle and
    # _pair_mask implement it.  Zero-pad if a raw buffer ends exactly at n
    # (the reference reads its zero-initialised allocation there).
    need = 2 * ((n + 1) // 2)
    if s1.shape[0] < need:
        s1 = np.pad(s1, (0, need - s1.shape[0]))
    if s2.shape[0] < need:
        s2 = np.pad(s2, (0, need - s2.shape[0]))
    p1, q1 = s1[0:need:2], s1[1:need:2]
    p2, q2 = s2[0:need:2], s2[1:need:2]
    possible = p1 | q1
    hits = possible & (p1 == p2) & (q1 == q2)
    np_possible = int(possible.sum())
    return float(hits.sum()) / np_possible if np_possible else 0.0
