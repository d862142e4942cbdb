"""The work a kernel's inputs need, and the least time an H100 could take
for it.  Counts come from shapes and data alone, whatever the kernel does
to compute them; the peaks are NVIDIA's published ones for the H100 SXM
(dense, at the 700 W limit)."""

from __future__ import annotations

import numpy as np

from portbench.reference.geometry import Geometry

#: Device memory bytes/s and TF32 tensor-core FLOP/s; ``__popc`` runs at
#: 16 a clock an SM.
PEAK = {"bytes": 3.35e12, "tf32": 495e12}
POPC_PER_CLOCK_SM = 16


def bound_s(n_bytes: float, ops: float) -> float:
    """The larger of ``n_bytes`` at the memory rate and ``ops`` at the TF32
    tensor-core peak."""
    return max(n_bytes / PEAK["bytes"], ops / PEAK["tf32"])


def rows_fma(geom: Geometry, n_windows: int) -> dict[str, int]:
    """FMA of a band-rows computation over ``n_windows`` windows, each
    counted once: the 16-tap stage-1 DFT (re and im) over window/16 values
    of b and 16 residues, the complex stage 2 over ``k_max`` bins a residue
    (4 real FMA a term), the band projection, and the frame's two Haar
    products (each window is one row of a frame)."""
    k = geom.k_max()
    b_len, bands, rpf = geom.window_size // 16, geom.pitch_step_count, geom.rows_per_frame
    return {"stage1": n_windows * 16 * b_len * 16 * 2,
            "stage2": n_windows * b_len * k * 16 * 4,
            "projection": n_windows * 16 * k * bands,
            "haar": n_windows * (bands * bands + rpf * bands)}


def rows_work(geom: Geometry, batch: int, n_rows: int) -> tuple[int, int]:
    """(bytes, operations) of the rows kernel over ``n_rows`` windows of each
    of ``batch`` clips: the float32 audio the windows span read once, each
    frame's top-128 classes written once as int32, every FMA at 2
    operations."""
    span = int(geom.row_starts(n_rows)[-1]) + geom.window_size
    n_bytes = batch * span * 4 + batch * (n_rows // geom.rows_per_frame) * 128 * 4
    return n_bytes, 2 * sum(rows_fma(geom, batch * n_rows).values())


def rows_bound_s(geom: Geometry, batch: int, n_rows: int) -> float:
    """Least time of the rows kernel: operations at the TF32 tensor-core
    peak, bytes at the memory rate (no float32-accurate implementation on
    this card does better)."""
    return bound_s(*rows_work(geom, batch, n_rows))


def count_histogram(counts) -> np.ndarray:
    """Entries of each subfingerprint count: ``hist[c]``."""
    return np.bincount(np.asarray(counts, np.int64))


def scan_work(q_counts, lib_hist: np.ndarray, w: int, mask_pairs: int) -> tuple[int, int]:
    """(bytes, ``__popc``) of one launch of a one-vs-many scan: queries of
    ``q_counts`` rows against entries whose counts ``lib_hist`` tallies.
    Bytes: each entry's valid rows of the compared words of both planes and
    its count, the queries' valid rows, one float32 score a (query, entry).
    ``__popc``: one a compared word for each row of each offset (a row's pos
    and neg bits are disjoint, so one ``(Pl & Pq) | (Nl & Nq)`` counts both
    planes' hits)."""
    wu = min(w, (mask_pairs + 31) // 32)
    c = np.arange(len(lib_hist), dtype=np.int64)
    n_lib = int(lib_hist.sum())
    q = [int(x) for x in q_counts]
    n_bytes = int((lib_hist * c).sum()) * wu * 8 + n_lib * 4 + sum(q) * wu * 8 + len(q) * n_lib * 4
    popc = 0
    for nq in q:
        if nq > 0:
            terms = (np.abs(c - nq) + 1) * np.minimum(c, nq) * (c > 0)
            popc += int((terms * lib_hist).sum()) * wu
    return n_bytes, popc


def scan_bound_s(n_bytes: int, popc: int, sms: int, sm_mhz: float) -> float:
    """Least time of a scan: bytes at the memory rate, ``__popc`` at 16 a
    clock an SM at the card's maximum SM clock."""
    return max(n_bytes / PEAK["bytes"], popc / (POPC_PER_CLOCK_SM * sms * sm_mhz * 1e6))
