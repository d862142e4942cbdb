"""Packed-bit (popcount) matching for library scales (port of
the JAX package's ``ops/match_packed.py``).

A library entry lives as two planes of ``ceil(pairs/32)`` packed words per
subfingerprint (16x smaller than the matmul matcher's float planes), with
the quirk-Q10 similarity computed by AND + population count:

    hits(i, j)  = popcount(P1_i & P2_j) + popcount(N1_i & N2_j)
    possible(i) = popcount(P1_i | N1_i)          (fp1 = the longer side)

Words are uint32 bit patterns held as int32 tensors (the same bits: a NumPy
``.view(np.int32)``).  Every matcher call goes through
``ops.kernels.match_packed.match_one_vs_many_fused``: the Hopper kernel on
CUDA, its plain version on the CPU.  Scores equal the unpacked matcher's.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from lbaudiodetective_torch.utils.packing import words_per_plane
from lbaudiodetective_torch.ops.kernels.match_packed import (
    match_one_vs_many_fused, prefix_mask_words)
from lbaudiodetective_torch.ops.match import _pair_mask

def pack_bits_device(plane: torch.Tensor) -> torch.Tensor:
    """``[..., pairs] {0,1} -> [..., ceil(pairs/32)]`` int32 words on the
    plane's device (little-endian bit order, the layout of
    ``utils.packing.pack_bits``; bit 31 is the sign bit of the int32).  The
    bit weights are made on the device: copying them from the host would
    make the host wait for the device's queue."""
    *lead, pairs = plane.shape
    w = words_per_plane(pairs)
    bits = F.pad(plane.to(torch.int64), (0, w * 32 - pairs)).reshape(*lead, w, 32)
    weights = torch.ones(32, dtype=torch.int64, device=plane.device) << torch.arange(
        32, device=plane.device)
    words = (bits * weights).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


@lru_cache(maxsize=64)
def _mask_pairs(pairs: int, comparison_range: int, subfingerprint_length: int) -> int:
    """Leading pairs compared under quirk Q11."""
    return int(_pair_mask(pairs, comparison_range, subfingerprint_length).sum())


def _mask_words(pairs: int, comparison_range: int, subfingerprint_length: int
                ) -> np.ndarray:
    return prefix_mask_words(_mask_pairs(pairs, comparison_range, subfingerprint_length),
                             words_per_plane(pairs))


def match_one_vs_many_packed(q_pos_w: torch.Tensor, q_neg_w: torch.Tensor, n_query,
                             lib_pos_w: torch.Tensor, lib_neg_w: torch.Tensor,
                             n_lib: torch.Tensor, pairs: int,
                             comparison_range: int = 0,
                             subfingerprint_length: int = 200) -> torch.Tensor:
    """Query vs packed library: ``[Sq, W]`` (or ``[B, Sq, W]``) query words
    and ``[L, Sl, W]`` library words -> ``[L]`` (or ``[B, L]``) float32
    scores, equal to ``ops.match.match_one_vs_many_padded``."""
    if words_per_plane(pairs) != lib_pos_w.shape[-1]:
        raise ValueError(f"{pairs} pairs need {words_per_plane(pairs)} words per "
                         f"row, the library has {lib_pos_w.shape[-1]}")
    single = q_pos_w.dim() == 2
    if single:
        q_pos_w, q_neg_w = q_pos_w[None], q_neg_w[None]
    n_query = torch.as_tensor(n_query, dtype=torch.int32,
                              device=lib_pos_w.device).reshape(-1)
    scores = match_one_vs_many_fused(
        q_pos_w, q_neg_w, n_query, lib_pos_w, lib_neg_w, n_lib,
        _mask_pairs(pairs, comparison_range, subfingerprint_length))
    return scores[0] if single else scores


def entries_per_call(n_entries: int, chunk: int, device: torch.device) -> int:
    """Library entries per matcher call: ``chunk`` for the plain version,
    whose ``[chunk, S, Sq]`` hit planes it bounds; all of them on CUDA,
    where the kernel holds no transient and one launch serves the scan."""
    return max(n_entries, 1) if device.type == "cuda" else chunk


def phase_strided_query_planes(qp, qn, n, stride: int,
                               phases: int | None = None):
    """Phase-shifted strided query planes for the phase-robust coarse pass.

    ``[S, pairs]`` uint8 planes (or batched ``[B, S, pairs]``) ->
    ``([P, Sc, pairs], [P, Sc, pairs], [P])`` (batched: leading ``B``),
    where phase ``p`` holds ``q[p::stride]`` zero-padded to
    ``Sc = ceil(S/stride)`` and its subfingerprint count.

    The coarse pass strides both subfingerprint axes, so its offset slide
    is quantised to multiples of ``stride``; phase ``p`` restores alignment
    for true offsets ``k = -p (mod stride)``.  Consecutive subfingerprints
    cover disjoint audio, so a misaligned coarse compare scores ~chance;
    the max over all ``stride`` phases keeps crops at any offset in the
    shortlist.  ``phases`` < stride trades that recall for speed
    (``phases=1`` is the phase-0-only coarse pass).
    """
    qp = np.asarray(qp)
    qn = np.asarray(qn)
    batched = qp.ndim == 3
    if not batched:
        qp, qn = qp[None], qn[None]
    n_arr = np.atleast_1d(np.asarray(n, np.int32))
    b, s, pairs = qp.shape
    sc = -(-s // stride)
    p_total = stride if phases is None else max(1, min(phases, stride))
    out_p = np.zeros((b, p_total, sc, pairs), np.uint8)
    out_n = np.zeros_like(out_p)
    ncs = np.zeros((b, p_total), np.int32)
    for p in range(p_total):
        sl = qp[:, p::stride]
        out_p[:, p, : sl.shape[1]] = sl
        sl = qn[:, p::stride]
        out_n[:, p, : sl.shape[1]] = sl
        ncs[:, p] = np.maximum(0, -(-(n_arr - p) // stride))
    if not batched:
        return out_p[0], out_n[0], ncs[0]
    return out_p, out_n, ncs


def _descending(x: torch.Tensor) -> torch.Tensor:
    """Indices sorting each row by descending value, equal values in
    ascending index order (the tie rule of ``jax.lax.top_k``)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices


def two_stage_search_packed(q_pos_w, q_neg_w, n_query,
                            qc_pos_w, qc_neg_w, n_query_c,
                            lib_pos_w, lib_neg_w, n_lib,
                            libc_pos_w, libc_neg_w, n_lib_c,
                            pairs: int,
                            comparison_range: int = 0,
                            subfingerprint_length: int = 200,
                            coarse_range: int = 64,
                            chunk: int = 65536,
                            shortlist: int = 1024,
                            top_k: int = 5):
    """Coarse -> exact library search on the library's device.

    The coarse planes (``libc_*``: subfingerprint axis subsampled, entry
    axis zero-padded to a ``chunk`` multiple) are scanned chunk by chunk by
    the plain version and in one launch by the kernel
    (``entries_per_call``), every query and phase in each call; each entry's
    coarse score is its max over phases, and padding entries score -inf.
    The ``shortlist`` best coarse entries are gathered from the full planes
    and re-scored exactly by the same matcher, so an exact score equals
    the full scan's at that index.  Returns ``(indices[top_k], exact
    scores[top_k])`` by descending exact score, ties to the better coarse
    rank, as the reference's ``lax.top_k`` does.

    Query words are ``[S, W]`` with ``qc_*`` ``[P, Sc, W]`` (counts scalar
    and ``[P]``), or batched with a leading ``B`` (results ``[B, top_k]``).
    """
    lp = libc_pos_w.shape[0]
    if lp % chunk:
        raise ValueError("coarse plane entry axis must be zero-padded to a "
                         "multiple of chunk")
    dev = lib_pos_w.device
    single = q_pos_w.dim() == 2
    if single:
        q_pos_w, q_neg_w, qc_pos_w, qc_neg_w = (
            x[None] for x in (q_pos_w, q_neg_w, qc_pos_w, qc_neg_w))
    n_query = torch.as_tensor(n_query, dtype=torch.int32, device=dev).reshape(-1)
    b, n_phases = qc_pos_w.shape[:2]
    n_query_c = torch.as_tensor(n_query_c, dtype=torch.int32, device=dev).reshape(-1)
    qcp, qcn = (x.reshape(b * n_phases, *x.shape[2:]) for x in (qc_pos_w, qc_neg_w))
    step = entries_per_call(lp, chunk, dev)
    coarse = torch.cat([
        match_one_vs_many_packed(
            qcp, qcn, n_query_c, libc_pos_w[s:s + step], libc_neg_w[s:s + step],
            n_lib_c[s:s + step], pairs, coarse_range, subfingerprint_length
        ).reshape(b, n_phases, -1).amax(1)
        for s in range(0, lp, step)], dim=1)
    l = lib_pos_w.shape[0]
    coarse = torch.where(torch.arange(lp, device=dev) < l, coarse,
                         torch.full_like(coarse, -torch.inf))
    cand = _descending(coarse)[:, :shortlist]                       # [B, shortlist]
    exact = torch.stack([
        match_one_vs_many_packed(q_pos_w[i], q_neg_w[i], n_query[i],
                                 lib_pos_w[cand[i]], lib_neg_w[cand[i]], n_lib[cand[i]],
                                 pairs, comparison_range, subfingerprint_length)
        for i in range(b)])
    order = _descending(exact)[:, :top_k]
    idx, scores = torch.gather(cand, 1, order), torch.gather(exact, 1, order)
    return (idx[0], scores[0]) if single else (idx, scores)
