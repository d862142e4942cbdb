"""G.711 companded PCM decode (mu-law / A-law), pure NumPy.

The reference accepts any container AudioToolbox can open
(LBAudioDetective.h:210-235 takes audio file URLs generally), and Core
Audio ships G.711 codecs ('ulaw'/'alaw' CAF format IDs, WAV format tags
6/7).  Telephony-band field recordings are a realistic input for a
bird-identification service, so the framework decodes both laws natively.

Decoding is a 256-entry table lookup built once from the scalar ITU-T
G.711 expansion formulas (the same tables every implementation ships).
"""

from __future__ import annotations

import numpy as np


def _mulaw_expand_scalar(u: int) -> int:
    """ITU-T G.711 mu-law byte -> linear 16-bit sample (max +-32124)."""
    u = ~u & 0xFF
    sign = u & 0x80
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    t = (((mantissa << 3) + 0x84) << exponent) - 0x84
    return -t if sign else t


def _alaw_expand_scalar(a: int) -> int:
    """ITU-T G.711 A-law byte -> linear 16-bit sample (max +-32256)."""
    a ^= 0x55
    sign = a & 0x80
    seg = (a >> 4) & 0x07
    t = (a & 0x0F) << 4
    if seg == 0:
        t += 8
    elif seg == 1:
        t += 0x108
    else:
        t = (t + 0x108) << (seg - 1)
    return t if sign else -t


MULAW_TABLE = np.array([_mulaw_expand_scalar(i) for i in range(256)],
                       dtype=np.int16)
ALAW_TABLE = np.array([_alaw_expand_scalar(i) for i in range(256)],
                      dtype=np.int16)


def decode_mulaw(data: bytes) -> np.ndarray:
    """mu-law bytes -> float32 samples in [-1, 1)."""
    idx = np.frombuffer(data, dtype=np.uint8)
    return MULAW_TABLE[idx].astype(np.float32) / 32768.0


def decode_alaw(data: bytes) -> np.ndarray:
    """A-law bytes -> float32 samples in [-1, 1)."""
    idx = np.frombuffer(data, dtype=np.uint8)
    return ALAW_TABLE[idx].astype(np.float32) / 32768.0


def _encode_nearest(table: np.ndarray, samples: np.ndarray) -> bytes:
    """Nearest-table-entry companding encode: exactly inverts the matching
    decode on its own output and is within one quantisation step
    everywhere (test/tooling helper)."""
    pcm = np.clip(np.asarray(samples, np.float32) * 32768.0, -32768, 32767)
    order = np.argsort(table.astype(np.int32), kind="stable")
    centers = table[order].astype(np.float32)
    pos = np.searchsorted(centers, pcm)
    lo = np.clip(pos - 1, 0, 255)
    hi = np.clip(pos, 0, 255)
    pick = np.where(np.abs(centers[hi] - pcm) < np.abs(pcm - centers[lo]),
                    hi, lo)
    return order[pick].astype(np.uint8).tobytes()


def encode_mulaw(samples: np.ndarray) -> bytes:
    """Linear float32 [-1,1) -> mu-law bytes."""
    return _encode_nearest(MULAW_TABLE, samples)


def encode_alaw(samples: np.ndarray) -> bytes:
    """Linear float32 [-1,1) -> A-law bytes."""
    return _encode_nearest(ALAW_TABLE, samples)
