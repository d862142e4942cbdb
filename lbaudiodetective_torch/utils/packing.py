"""Bit packing for fingerprint storage and popcount-style matching.

A subfingerprint's sign classes are two {0,1} planes (pos, neg) of
``pairs`` entries (100 by default).  For storage and for the bitwise
XOR/popcount matcher variant we pack each plane into ``ceil(pairs/32)``
uint32 words, little-endian within a word (bit j of word w = pair 32*w + j).
"""

from __future__ import annotations

import numpy as np


def words_per_plane(pairs: int) -> int:
    return (pairs + 31) // 32


def pack_bits(plane: np.ndarray) -> np.ndarray:
    """``[..., pairs] uint8 -> [..., words] uint32`` little-endian bit packing."""
    *lead, pairs = plane.shape
    w = words_per_plane(pairs)
    padded = np.zeros((*lead, w * 32), dtype=np.uint8)
    padded[..., :pairs] = plane
    bits = padded.reshape(*lead, w, 32).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    return (bits << shifts).sum(axis=-1, dtype=np.uint32)


def unpack_bits(words: np.ndarray, pairs: int) -> np.ndarray:
    """``[..., words] uint32 -> [..., pairs] uint8``."""
    *lead, w = words.shape
    shifts = np.arange(32, dtype=np.uint32)
    bits = (words[..., None] >> shifts) & np.uint32(1)
    return bits.reshape(*lead, w * 32)[..., :pairs].astype(np.uint8)
