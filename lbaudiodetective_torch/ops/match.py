"""Fingerprint matching as matrix products (port of
the JAX package's ``ops/match.py``).

With sign-class planes P, N in {0,1}^pairs (never both set), the quirk-Q10
similarity factorises into two inner products:

    possible(fp1_j)    = sum_i P1[j,i] + N1[j,i]
    hits(fp1_j, fp2_k) = sum_i P1[j,i]*P2[k,i] + N1[j,i]*N2[k,i]

Hits are float32 products of 0/1 planes, exact since every sum is <= pairs
< 2^24 (torch's bf16 product would round its output to bf16, so the planes
stay float32).  The offset-sliding score is a masked banded-diagonal mean +
max.  The reference has no TPU kernel here; this is plain torch on every
device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lbaudiodetective_torch.device import DEFAULT_DEVICE, resolve_device


def _pair_mask(pairs: int, comparison_range: int, subfingerprint_length: int) -> np.ndarray:
    """Quirk Q11: ``comparison_range`` caps *booleans* compared (0 -> all);
    pairs beyond ceil(min(range, length)/2) are excluded."""
    if comparison_range == 0:
        comparison_range = subfingerprint_length
    n_bools = min(comparison_range, subfingerprint_length)
    n_pairs = (n_bools + 1) // 2
    mask = np.zeros(pairs, dtype=np.float32)
    mask[:n_pairs] = 1.0
    return mask


def similarity_matrix(pos1: torch.Tensor, neg1: torch.Tensor,
                      pos2: torch.Tensor, neg2: torch.Tensor,
                      pair_mask: torch.Tensor) -> torch.Tensor:
    """``[..., n1, pairs] x [..., n2, pairs] -> [..., n1, n2]`` per-pair
    similarity (hits / possibleHits, 0 where nothing is possible)."""
    m = pair_mask.to(torch.float32)
    p1 = pos1.to(torch.float32) * m
    n1 = neg1.to(torch.float32) * m
    p2 = pos2.to(torch.float32)
    n2 = neg2.to(torch.float32)
    hits = torch.matmul(p1, p2.transpose(-1, -2)) + torch.matmul(n1, n2.transpose(-1, -2))
    possible = (p1 + n1).sum(-1)                                   # [..., n1]
    sim = hits / torch.clamp(possible, min=1.0)[..., :, None]
    return torch.where(possible[..., :, None] > 0.0, sim, torch.zeros_like(sim))


def _diagonal_view(x: torch.Tensor, n_out: int, n_terms: int,
                   out_stride: int, term_stride: int) -> torch.Tensor:
    """Strided view ``v[..., o, i] = flat(x)[..., o*out_stride + i*term_stride]``
    over the last two (contiguous) axes of ``x``."""
    x = x.contiguous()
    lead = x.shape[:-2]
    return x.as_strided((*lead, n_out, n_terms),
                        (*x.stride()[:-2], out_stride, term_stride))


def _sum_in_order(terms: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis one term at a time, in ascending order, as the
    reference's roll loop does: float32 addition is not associative, and
    this order gives the reference's bits (and the packed kernel's)."""
    total = torch.zeros(terms.shape[:-1], dtype=terms.dtype, device=terms.device)
    for i in range(terms.shape[-1]):
        total = total + terms[..., i]
    return total


def banded_diagonal_sums(sim: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
    """``D[..., o] = sum_{i < n2} sim[..., o+i, i]`` for o in [0, S1).

    Columns ``i >= n2`` are zeroed; the rows are zero-padded by S2 so that
    the diagonal of offset o is a strided view (row stride S2, term stride
    S2 + 1).  The reference rolls circularly instead: its terms differ from
    these zeros only at o + i >= S1, i.e. o > S1 - 1 - i, and every valid
    offset has o + i <= n1 - 1 < S1 for i < n2, so those offsets are
    invalid and the caller masks them."""
    s1, s2 = sim.shape[-2], sim.shape[-1]
    i_idx = torch.arange(s2, device=sim.device)
    masked = sim * (i_idx < n2[..., None, None]).to(sim.dtype)
    padded = F.pad(masked, (0, 0, 0, s2))                    # [..., S1 + S2, S2]
    return _sum_in_order(_diagonal_view(padded, s1, s2, s2, s2 + 1))


def offset_scores(sim: torch.Tensor, n1: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
    """Offset-sliding max of banded-diagonal means (reference
    LBAudioDetectiveFingerprint.m:133-148).  sim ``[..., S1, S2]`` (padding
    zero); n1 >= n2 ``[...]`` valid counts.  Returns ``[...]``, 0 when
    n2 == 0."""
    s1 = sim.shape[-2]
    sums = banded_diagonal_sums(sim, n2)
    means = sums / torch.clamp(n2, min=1).to(sim.dtype)[..., None]
    o_valid = torch.arange(s1, device=sim.device) <= (n1 - n2)[..., None]
    score = torch.where(o_valid, means, torch.zeros_like(means)).amax(-1)
    return torch.where(n2 > 0, score, torch.zeros_like(score))


def _match_padded(pos1, neg1, n1, pos2, neg2, n2,
                  comparison_range: int, subfingerprint_length: int) -> torch.Tensor:
    pairs = pos1.shape[-1]
    mask = torch.from_numpy(_pair_mask(pairs, comparison_range,
                                       subfingerprint_length)).to(pos1.device)
    # Swap so fp1 is the longer (LBAudioDetectiveFingerprint.m:123-131).
    swap = n1 < n2
    swap_b = swap.reshape(swap.shape + (1, 1))
    pos_l = torch.where(swap_b, pos2, pos1)
    neg_l = torch.where(swap_b, neg2, neg1)
    pos_s = torch.where(swap_b, pos1, pos2)
    neg_s = torch.where(swap_b, neg1, neg2)
    n_l = torch.where(swap, n2, n1)
    n_s = torch.where(swap, n1, n2)
    sim = similarity_matrix(pos_l, neg_l, pos_s, neg_s, mask)
    return offset_scores(sim, n_l, n_s)


def match_fingerprints(fp1: tuple[np.ndarray, np.ndarray],
                       fp2: tuple[np.ndarray, np.ndarray],
                       comparison_range: int = 0,
                       subfingerprint_length: int = 200,
                       device: torch.device | str = DEFAULT_DEVICE) -> float:
    """One-vs-one match score between two (pos, neg) uint8 fingerprints,
    computed on ``device``."""
    from lbaudiodetective_torch.ops.extract import bucket_subfingerprints

    device = resolve_device(device, "match_fingerprints")
    (pos1, neg1), (pos2, neg2) = fp1, fp2
    n1, n2 = pos1.shape[0], pos2.shape[0]
    if n1 == 0 or n2 == 0:
        return 0.0
    s = bucket_subfingerprints(max(n1, n2))
    pairs = pos1.shape[1]

    def pad(a):
        out = np.zeros((s, pairs), dtype=np.uint8)
        out[:a.shape[0]] = a
        return torch.from_numpy(out).to(device)

    score = _match_padded(pad(pos1), pad(neg1), torch.tensor(n1, device=device),
                          pad(pos2), pad(neg2), torch.tensor(n2, device=device),
                          comparison_range, subfingerprint_length)
    return float(score)


def match_one_vs_many_padded(query_pos: torch.Tensor, query_neg: torch.Tensor,
                             n_query: torch.Tensor,
                             lib_pos: torch.Tensor, lib_neg: torch.Tensor,
                             n_lib: torch.Tensor,
                             comparison_range: int = 0,
                             subfingerprint_length: int = 200) -> torch.Tensor:
    """Query ``[Sq, pairs]`` + scalar count vs a padded library
    ``[L, Sl, pairs]`` + ``[L]`` counts -> ``[L]`` scores.

    Hit counts are symmetric in the two fingerprints, so they are one
    product over the flattened library ``[L*Sl, pairs] @ [pairs, Sq]``; only
    the denominator and the slide direction depend on which side is longer
    (quirk Q10), handled by scoring both orientations."""
    l, s_lib, pairs = lib_pos.shape
    mask = torch.from_numpy(_pair_mask(pairs, comparison_range,
                                       subfingerprint_length)).to(lib_pos.device)
    lp = lib_pos.reshape(l * s_lib, pairs).to(torch.float32) * mask
    ln = lib_neg.reshape(l * s_lib, pairs).to(torch.float32) * mask
    qp = query_pos.to(torch.float32)
    qn = query_neg.to(torch.float32)
    hits = (torch.matmul(lp, qp.T) + torch.matmul(ln, qn.T)).reshape(l, s_lib, -1)

    w_lib = (lp + ln).sum(-1).reshape(l, s_lib)
    w_q = ((qp + qn) * mask).sum(-1)
    inv_lib = torch.where(w_lib > 0.0, 1.0 / torch.clamp(w_lib, min=1.0),
                          torch.zeros_like(w_lib))
    inv_q = torch.where(w_q > 0.0, 1.0 / torch.clamp(w_q, min=1.0),
                        torch.zeros_like(w_q))
    nq = torch.as_tensor(n_query, device=lib_pos.device).expand(l)
    return _both_orientation_scores(hits, inv_lib, inv_q, n_lib, nq)


def _both_orientation_scores(hits: torch.Tensor, inv_lib: torch.Tensor,
                             inv_q: torch.Tensor, n_lib: torch.Tensor,
                             nq: torch.Tensor) -> torch.Tensor:
    """Offset-sliding scores for both swap orientations from one ``hits``
    tensor ``[L, Sl, Sq]``; inv_lib ``[L, Sl]`` and inv_q ``[Sq]`` are the
    reciprocal possible hits (0 where none); n_lib/nq ``[L]`` counts."""
    l, s_lib, s_q = hits.shape
    # Orientation A: the library entry is fp1 (slid, longer).  Scale rows.
    score_a = offset_scores(hits * inv_lib[..., None], n_lib, nq)
    # Orientation B: the query is fp1.  D[l, o] = sum_{i < n_lib} sim_b[l, i, o+i];
    # zero-padding the last axis by Sl makes it a strided view (row stride
    # Sq + Sl + 1 per term).  As in banded_diagonal_sums, the reference's
    # circular rolls differ only at o + i >= Sq, offsets the mask drops.
    sim_b = hits * inv_q[None, None, :]
    i_idx = torch.arange(s_lib, device=hits.device)
    masked_b = sim_b * (i_idx[None, :] < n_lib[:, None]).to(sim_b.dtype)[..., None]
    padded = F.pad(masked_b, (0, s_lib))                     # [L, Sl, Sq + Sl]
    total_b = _sum_in_order(_diagonal_view(padded, s_q, s_lib, 1, s_q + s_lib + 1))
    means_b = total_b / torch.clamp(n_lib, min=1).to(sim_b.dtype)[:, None]
    o_valid_b = torch.arange(s_q, device=hits.device)[None, :] <= (nq - n_lib)[:, None]
    score_b = torch.where(o_valid_b, means_b, torch.zeros_like(means_b)).amax(-1)
    score_b = torch.where(n_lib > 0, score_b, torch.zeros_like(score_b))
    return torch.where(n_lib < nq, score_b, score_a)


def _long_inputs(pos1, neg1, n1, pos2, neg2, n2, device: torch.device | str, what: str):
    """The long matchers' planes (uint8 arrays or tensors) and counts as
    tensors on ``device``."""
    device = resolve_device(device, what)
    planes = [torch.as_tensor(x, device=device) for x in (pos1, neg1, pos2, neg2)]
    counts = [torch.as_tensor(n, dtype=torch.int64, device=device) for n in (n1, n2)]
    return device, planes, counts


def match_long_padded(pos1, neg1, n1, pos2, neg2, n2,
                      comparison_range: int = 0,
                      subfingerprint_length: int = 200,
                      chunk: int = 512,
                      device: torch.device | str = DEFAULT_DEVICE) -> torch.Tensor:
    """Long-context one-vs-one matcher: fp1 may be hours long.

    fp1 is scanned in ``chunk``-row blocks, so the ``[S1, S2]`` similarity
    matrix never exists whole.  Each block's similarity ``[chunk, S2]``
    adds its banded-diagonal sums into a ``chunk + S2`` window, column by
    column in ascending order, and the window is added into the offset
    accumulator at the block's base offset, in block order: the reference's
    order (the JAX package's ``ops/match.py:186-193``).  fp1 must be the
    longer side (no swap here) and zero-padded to a multiple of ``chunk``.
    Planes are uint8 ``[S1, pairs]`` / ``[S2, pairs]`` on or for ``device``;
    returns a 0-d float32 tensor there."""
    device, (pos1, neg1, pos2, neg2), (n1, n2) = _long_inputs(
        pos1, neg1, n1, pos2, neg2, n2, device, "match_long_padded")
    s1, pairs = pos1.shape
    s2 = pos2.shape[0]
    if s1 % chunk:
        raise ValueError("pos1 must be padded to a multiple of chunk")
    mask = torch.from_numpy(_pair_mask(pairs, comparison_range,
                                       subfingerprint_length)).to(device)
    p2 = pos2.to(torch.float32)
    q2 = neg2.to(torch.float32)
    i_mask = (torch.arange(s2, device=device) < n2).to(torch.float32)
    # Offsets o live at acc[o + S2]: a block's window [b*chunk - S2,
    # b*chunk + chunk) never leaves the padding, which no valid offset reads.
    acc = torch.zeros(s1 + 2 * s2, dtype=torch.float32, device=device)
    for start in range(0, s1, chunk):
        lp = pos1[start:start + chunk].to(torch.float32) * mask
        ln = neg1[start:start + chunk].to(torch.float32) * mask
        hits = torch.matmul(lp, p2.T) + torch.matmul(ln, q2.T)
        w = (lp + ln).sum(-1)
        sim = torch.where(w[:, None] > 0.0, hits / torch.clamp(w, min=1.0)[:, None],
                          torch.zeros_like(hits)) * i_mask[None, :]
        # local[k] = sum_i sim[k - S2 + i, i] for k in [0, chunk + S2).
        padded = F.pad(sim, (0, 0, s2, s2))
        local = _sum_in_order(_diagonal_view(padded, chunk + s2, s2, s2, s2 + 1))
        acc[start:start + chunk + s2] = acc[start:start + chunk + s2] + local
    means = acc[s2:s2 + s1] / torch.clamp(n2, min=1).to(torch.float32)
    o_valid = torch.arange(s1, device=device) <= (n1 - n2)
    score = torch.where(o_valid, means, torch.zeros_like(means)).amax()
    return torch.where(n2 > 0, score, torch.zeros_like(score))


def match_long_hierarchical(pos1, neg1, n1, pos2, neg2, n2,
                            comparison_range: int = 0,
                            subfingerprint_length: int = 200,
                            col_stride: int = 4,
                            n_candidates: int = 16,
                            refine_radius: int = 2,
                            device: torch.device | str = DEFAULT_DEVICE) -> torch.Tensor:
    """Hierarchical coarse -> fine long matcher.

    Coarse pass: every offset's score estimated from every
    ``col_stride``-th query subfingerprint (the offset axis stays at full
    resolution).  Fine pass: the ``n_candidates`` best coarse offsets
    (ties to the lower offset, as ``lax.top_k``) and their
    ±``refine_radius`` neighbours re-scored exactly with every column; the
    result is the maximum over that set.  Equal to the full scan whenever
    the true argmax survives the coarse top-k (use ``match_long_padded``
    for a guaranteed-exact score).  Same contract as ``match_long_padded``:
    fp1 is the longer side, zero-padded."""
    from lbaudiodetective_torch.ops.match_packed import _descending

    device, (pos1, neg1, pos2, neg2), (n1, n2) = _long_inputs(
        pos1, neg1, n1, pos2, neg2, n2, device, "match_long_hierarchical")
    s1, pairs = pos1.shape
    s2 = pos2.shape[0]
    mask = torch.from_numpy(_pair_mask(pairs, comparison_range,
                                       subfingerprint_length)).to(device)
    p1 = pos1.to(torch.float32) * mask
    q1 = neg1.to(torch.float32) * mask
    w = (p1 + q1).sum(-1)                                          # [S1]
    inv_w = torch.where(w > 0.0, 1.0 / torch.clamp(w, min=1.0), torch.zeros_like(w))

    # -- coarse: subsampled columns, all offsets ------------------------------
    cols = torch.arange(0, s2, col_stride, device=device)
    hits_c = (torch.matmul(p1, pos2[cols].to(torch.float32).T)
              + torch.matmul(q1, neg2[cols].to(torch.float32).T))  # [S1, Sc]
    col_valid = (cols < n2).to(torch.float32)
    sim_c = hits_c * inv_w[:, None] * col_valid[None, :]
    # d_c[o] = sum_j sim_c[o + cols[j], j]: rows zero-padded by S2, term
    # stride col_stride rows + 1.  The reference's circular rolls differ
    # only past S1, at offsets the mask drops.
    sc = sim_c.shape[1]
    padded = F.pad(sim_c, (0, 0, 0, s2))
    d_c = _sum_in_order(_diagonal_view(padded, s1, sc, sc, col_stride * sc + 1))
    means_c = d_c / torch.clamp(col_valid.sum(), min=1.0)
    o_valid = torch.arange(s1, device=device) <= (n1 - n2)
    means_c = torch.where(o_valid, means_c, torch.full_like(means_c, -1.0))
    cand = _descending(means_c)[:n_candidates]                      # [K]

    # -- fine: exact re-score around each candidate ---------------------------
    deltas = torch.arange(-refine_radius, refine_radius + 1, device=device)
    offsets = (cand[:, None] + deltas[None, :]).reshape(-1)
    o = torch.clamp(offsets, 0, s1 - s2)
    rows = o[:, None] + torch.arange(s2, device=device)[None, :]   # [K*R, S2]
    hits = ((p1[rows] * pos2.to(torch.float32)).sum(-1)
            + (q1[rows] * neg2.to(torch.float32)).sum(-1))         # [K*R, S2]
    i_valid = (torch.arange(s2, device=device) < n2).to(torch.float32)
    sim = hits * inv_w[rows] * i_valid
    means = sim.sum(-1) / torch.clamp(n2, min=1).to(torch.float32)
    valid = (offsets >= 0) & (offsets <= n1 - n2)
    score = torch.where(valid, means, torch.zeros_like(means)).amax()
    return torch.where(n2 > 0, score, torch.zeros_like(score))
