"""Host-side traffic made from the seed with NumPy alone, so that the
client process imports neither torch nor the program: the seeded streams
and the fingerprint text of live sessions."""

from __future__ import annotations

import numpy as np


def rng(seed: int, *keys: int) -> np.random.Generator:
    """A generator for one purpose of one seed: the same seed and keys give
    the same stream."""
    return np.random.default_rng([int(seed) % (1 << 64), *keys])


def planes_text(pos: np.ndarray, neg: np.ndarray) -> str:
    """``[n, pairs]`` planes in the golden string form: a subfingerprint's
    booleans interleaved (pos, neg) a pair, subfingerprints joined by
    ``+``."""
    bits = np.empty((pos.shape[0], 2 * pos.shape[1]), np.uint8)
    bits[:, 0::2], bits[:, 1::2] = pos, neg
    return "+".join((b + ord("0")).tobytes().decode("ascii") for b in bits)
