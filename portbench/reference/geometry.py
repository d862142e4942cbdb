"""The fingerprint geometry of a configuration file, worked out from its
numbers alone: window starts, the spectral band edges with the reference's
two integer truncations (``LBAudioDetective.m:361-383``), the band widths
that normalise them, the spectrum divisor, the 1-D Haar matrix and the
subfingerprint count of a clip.  Plain Python and NumPy; nothing here reads
the program."""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Geometry:
    processing_sample_rate: float
    window_size: int
    analysis_stride: int
    pitch_step_count: int
    rows_per_frame: int
    subfingerprint_length: int
    min_frequency: float
    hop_domain: str
    file_sample_rate: float
    integer_hop: bool

    @classmethod
    def from_config(cls, config: dict) -> "Geometry":
        g = config["geometry"]
        return cls(**{f.name: g[f.name] for f in dataclasses.fields(cls)})

    @property
    def pairs(self) -> int:
        return self.subfingerprint_length // 2

    @property
    def words(self) -> int:
        return -(-self.pairs // 32)

    @property
    def hop(self) -> float:
        if self.hop_domain == "file":
            hop = self.analysis_stride * self.processing_sample_rate / self.file_sample_rate
            return float(round(hop)) if self.integer_hop else hop
        return float(self.analysis_stride)

    def n_sub(self, file_frames: int, proc_frames: int) -> int:
        """Complete frames of a clip: rows from the file-rate length in the
        "file" hop domain, only whole frames kept."""
        length = file_frames if self.hop_domain == "file" else proc_frames
        rows = max((length - self.window_size) // self.analysis_stride, 0)
        return rows // self.rows_per_frame

    def row_starts(self, n_rows: int) -> np.ndarray:
        return np.floor(np.arange(n_rows, dtype=np.float64) * self.hop).astype(np.int64)

    def _first_stage(self) -> np.ndarray:
        bins, sr = self.pitch_step_count, self.processing_sample_rate
        base = math.exp(math.log((sr / 2.0) / self.min_frequency) / bins)
        mincoef = float(self.window_size) / sr * self.min_frequency
        return np.array([int((base ** j - 1.0) * mincoef) + int(mincoef)
                         for j in range(bins + 1)], np.int64)

    def band_ranges(self) -> np.ndarray:
        """``[bands, 2]`` FFT-bin ``[low, high)`` of each band, clamped to
        ``[0, window/2]``."""
        idx = self._first_stage()
        width = self.processing_sample_rate / self.window_size
        half = self.window_size // 2
        out = np.empty((self.pitch_step_count, 2), np.int64)
        for i in range(self.pitch_step_count):
            for j, edge in enumerate((idx[i], idx[i + 1])):
                out[i, j] = min(max(int((2.0 * edge) / width - 1.0), 0), half)
        return out

    def band_widths(self) -> np.ndarray:
        idx = self._first_stage()
        return (idx[1:] - idx[:-1]).astype(np.float64)

    @property
    def divisor(self) -> float:
        """Positive spectrum components are divided by ``(window/2)/2``."""
        return float((self.window_size // 2) // 2)

    def k_max(self, residues: int = 16) -> int:
        """Most DFT bins of the bands' span that share one residue modulo
        ``residues``: the slots a two-stage DFT over that span needs."""
        r = self.band_ranges()
        ks = np.arange(int(r[:, 0].min()), int(r[:, 1].max()))
        return int(max((ks % residues == c).sum() for c in range(residues)))


def haar_matrix(n: int) -> np.ndarray:
    """``[n, n]`` float64 matrix of the reference's 1-D Haar decomposition
    (``LBAudioDetectiveFrame.m:134-153``): divide by sqrt(n), then halve
    with (a + b)/sqrt2 and (a - b)/sqrt2."""
    m = np.eye(n, dtype=np.float64) / np.sqrt(n)
    size = n
    while size > 1:
        size //= 2
        even, odd = m[0:2 * size:2].copy(), m[1:2 * size:2].copy()
        m[:size] = (even + odd) / np.sqrt(2.0)
        m[size:2 * size] = (even - odd) / np.sqrt(2.0)
    return m
