"""Shared PCM decode helpers for the container readers (wav/aiff/au).

One implementation of the whole-sample trim, the 24-bit triplet assembly,
and the multichannel mean-downmix — the three pieces every container reader
needs identically.  The native C++ decoder is validated against the readers
built on these (tests/test_native_decoder.py), so a numerics fix here
propagates to every container at once.
"""

from __future__ import annotations

import numpy as np


def whole(data: bytes, width: int) -> bytes:
    """Trim to whole samples: truncated files are tolerated upstream; a
    ragged tail byte must not make np.frombuffer raise."""
    return data[: (len(data) // width) * width]


def pcm24_to_float(data: bytes, little: bool) -> np.ndarray:
    """Signed 24-bit packed triplets -> float32 in [-1, 1)."""
    b = np.frombuffer(data, np.uint8)
    b = b[: (len(b) // 3) * 3].reshape(-1, 3)
    lo, mid, hi = (0, 1, 2) if little else (2, 1, 0)
    vals = (b[:, lo].astype(np.int32)
            | (b[:, mid].astype(np.int32) << 8)
            | (b[:, hi].astype(np.int32) << 16))
    vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
    return vals.astype(np.float32) / float(1 << 23)


def downmix_mean(x: np.ndarray, channels: int) -> np.ndarray:
    """Interleaved multichannel -> mono mean (float32 accumulation, the
    convention every reader shares; the C++ path accumulates in double and
    agrees to 1 ulp)."""
    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(
            -1, channels).mean(axis=1)
    return x
