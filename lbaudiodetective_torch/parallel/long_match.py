"""Long-fingerprint matching with fp1's time axis over a ring of slots (port
of the JAX package's ``parallel/long_match.py``).

For hours-long audio the similarity is a large product and the longer
side's time axis scales across slots: each slot holds ``S1 / n`` rows of
fp1, the query's blocks rotate around the ring (``Mesh.ring_shift``), each
step adds the resident rows' banded-diagonal sums against the visiting
block into a local offset window, and the windows combine with one
``Mesh.psum``.  No slot holds more than ``S1 / n + S2 / n`` rows.  Hits are
float32 products of 0/1 planes (exact, as the reference's bf16 products
with float32 sums are); the diagonal sums are the port's strided views
(``ops.match._diagonal_view``, added in ascending column order), not a
column loop.  Scores agree with ``ops.match.match_long_padded`` within
1e-5 (the psum adds the windows in another order than the blockwise scan).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lbaudiodetective_torch.ops.match import _diagonal_view, _pair_mask, _sum_in_order
from lbaudiodetective_torch.parallel.mesh import Mesh, shard


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    out = np.zeros((rows, a.shape[1]), dtype=a.dtype)
    out[:a.shape[0]] = a
    return out


def _planes(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def match_long_time_sharded(pos1, neg1, n1, pos2, neg2, n2, mesh: Mesh,
                            axis: str = "data",
                            comparison_range: int = 0,
                            subfingerprint_length: int = 200) -> float:
    """One-vs-one long match with fp1's time axis split over ``axis``.

    pos1/neg1: ``[S1, pairs]`` uint8 planes of the longer fingerprint (the
    caller swaps, as for ``match_long_padded``); pos2/neg2 ``[S2, pairs]``;
    n1/n2 valid counts.  Both time axes are zero-padded to ring multiples.
    Slot d holds fp1 rows ``[d C, (d + 1) C)`` and first query block d; at
    step s it matches its rows against the block that started on slot
    ``(d - s) mod n``.  Column i of a block based at query row q0 adds
    ``sim[r, i]`` to offset ``g0 + r - q0 - i``; a step's sums land in a
    ``C + Qb - 1`` window of the slot's ``C + S2`` offset window, and the
    windows add into the global offsets through ``psum``."""
    pos1, neg1, pos2, neg2 = (_planes(x) for x in (pos1, neg1, pos2, neg2))
    s1_raw, pairs = pos1.shape
    s2_raw = pos2.shape[0]
    if s1_raw == 0 or s2_raw == 0:
        return 0.0
    if s1_raw < s2_raw:
        raise ValueError("fp1 must be the longer side (caller swaps)")
    slots = mesh.axis_slots(axis)
    n = len(slots)
    c = max(-(-s1_raw // n), 1)          # fp1 rows a slot
    qb = max(-(-s2_raw // n), 1)         # query rows a block
    s1p, s2p = c * n, qb * n
    res = [None if a is None else (a, b) for a, b in zip(
        shard(_pad_rows(pos1, s1p), mesh, axis), shard(_pad_rows(neg1, s1p), mesh, axis))]
    vis = [None if a is None else (a, b) for a, b in zip(
        shard(_pad_rows(pos2, s2p), mesh, axis), shard(_pad_rows(neg2, s2p), mesh, axis))]
    mask = _pair_mask(pairs, comparison_range, subfingerprint_length)

    state = []                           # per local slot: (rp, rn, inv_w, acc)
    for slot, r in zip(slots, res):
        if r is None:
            state.append(None)
            continue
        m = torch.from_numpy(mask).to(slot.device)
        rp = r[0].to(torch.float32) * m
        rn = r[1].to(torch.float32) * m
        w = (rp + rn).sum(-1)
        # Rows at or past n1 are zero-padded (w = 0, so sim = 0): no mask.
        inv_w = torch.where(w > 0.0, 1.0 / torch.clamp(w, min=1.0), torch.zeros_like(w))
        state.append((rp, rn, inv_w,
                      torch.zeros(c + s2p, dtype=torch.float32, device=slot.device)))

    for step in range(n):
        for d, st in enumerate(state):
            if st is None:
                continue
            rp, rn, inv_w, acc = st
            dev = slots[d].device
            q0 = ((d - step) % n) * qb
            vp, vn = (x.to(torch.float32) for x in vis[d])
            sim = (torch.matmul(rp, vp.T) + torch.matmul(rn, vn.T)) * inv_w[:, None]
            col_valid = (q0 + torch.arange(qb, device=dev)) < n2
            sim = sim * col_valid[None, :].to(torch.float32)
            # bl[t] = sum_j sim[t - (qb - 1 - j), j], j ascending: a strided
            # view of sim padded by qb - 1 rows at both ends.
            padded = F.pad(sim, (0, 0, qb - 1, qb - 1))
            bl = _sum_in_order(_diagonal_view(padded, c + qb - 1, qb, qb, qb + 1))
            start = s2p - q0 - qb + 1
            acc[start:start + c + qb - 1] += bl
        if step + 1 < n:
            vis = mesh.ring_shift(vis, axis)

    windows = []                         # the local windows in global offsets
    for d, st in enumerate(state):
        if st is not None:
            g = torch.zeros(s1p + s2p, dtype=torch.float32, device=slots[d].device)
            g[d * c:d * c + c + s2p] = st[3]
            windows.append(g)
        else:
            windows.append(None)
    d_global = mesh.psum(windows, axis)               # index = offset + S2p
    means = d_global[s2p:] / max(int(n2), 1)
    o_valid = torch.arange(s1p, device=d_global.device) <= int(n1) - int(n2)
    means = torch.where(o_valid, means, torch.zeros_like(means))
    return float(means.max()) if int(n2) > 0 else 0.0
