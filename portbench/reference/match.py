"""Plain PyTorch match scores, the yardstick of the port's packed matcher:
the offset-sliding mean of per-subfingerprint similarities, maximised over
offsets, where a pair is possible when the longer fingerprint's pair is
set and a hit when both classes agree (``LBAudioDetectiveFingerprint.m:
119-176``; at equal lengths the library entry is the longer side).

Scores are worked out in float64.  ``dtype=torch.bfloat16`` is the control:
similarities, their sums and the means rounded to bfloat16, the step below
the float32 the configuration states."""

from __future__ import annotations

import numpy as np
import torch


def unpack(words: torch.Tensor, pairs: int) -> torch.Tensor:
    """``[..., W]`` int32 words (uint32 bit patterns, bit j of word w is
    pair 32 w + j) -> ``[..., pairs]`` uint8."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :pairs].to(torch.uint8)


def pack(plane: np.ndarray) -> np.ndarray:
    """``[..., pairs]`` {0, 1} -> ``[..., W]`` int32 words (inverse of
    :func:`unpack`)."""
    *lead, pairs = plane.shape
    w = -(-pairs // 32)
    bits = np.zeros((*lead, w * 32), np.uint64)
    bits[..., :pairs] = plane
    words = (bits.reshape(*lead, w, 32) << np.arange(32, dtype=np.uint64)).sum(-1)
    return words.astype(np.uint32).view(np.int32)


def mask_pairs(pairs: int, comparison_range: int, subfingerprint_length: int) -> int:
    """Pairs compared: ``comparison_range`` counts booleans, 0 means all."""
    n_bools = min(comparison_range or subfingerprint_length, subfingerprint_length)
    return min(pairs, (n_bools + 1) // 2)


def scores(q_pos: torch.Tensor, q_neg: torch.Tensor, nq: torch.Tensor,
           e_pos: torch.Tensor, e_neg: torch.Tensor, ne: torch.Tensor,
           n_mask: int, dtype: torch.dtype = torch.float64,
           budget: int = 1 << 30) -> torch.Tensor:
    """``[B, Sq, P]`` query planes with ``[B]`` counts against ``[E, S, P]``
    entry planes with ``[E]`` counts (rows past a count zero) -> ``[B, E]``
    float64 scores, ``budget`` bytes a block of entries."""
    dev = e_pos.device
    b, sq, _ = q_pos.shape
    e, s, _ = e_pos.shape
    m = (torch.arange(q_pos.shape[-1], device=dev) < n_mask).double()
    qp, qn = q_pos.double() * m, q_neg.double() * m
    w_q = (qp + qn).sum(-1)                                         # [B, Sq]
    nq, ne = nq.to(dev).long(), ne.to(dev).long()
    out = torch.zeros((b, e), dtype=torch.float64, device=dev)
    step = max(1, budget // max(1, b * s * sq * 8))
    for e0 in range(0, e, step):
        ep, en = e_pos[e0:e0 + step].double() * m, e_neg[e0:e0 + step].double() * m
        w_e = (ep + en).sum(-1)                                     # [E', S]
        hits = (torch.einsum("esp,bqp->besq", ep, qp)
                + torch.einsum("esp,bqp->besq", en, qn))           # [B, E', S, Sq]
        inv_e = torch.where(w_e > 0, 1.0 / w_e.clamp(min=1), torch.zeros_like(w_e))
        inv_q = torch.where(w_q > 0, 1.0 / w_q.clamp(min=1), torch.zeros_like(w_q))
        sim_a = (hits * inv_e[None, :, :, None]).to(dtype)         # the entry is longer
        sim_b = (hits * inv_q[:, None, None, :]).to(dtype)         # the query is longer
        n_e = ne[e0:e0 + step][None, :]
        n_q = nq[:, None]
        best = torch.zeros((b, ep.shape[0]), dtype=torch.float64, device=dev)
        acc = torch.float64 if dtype == torch.float64 else torch.float32
        for o in range(max(s, sq)):
            if o < s:     # D_a[o] = sum_i sim_a[o + i, i], i < n_q
                d = torch.diagonal(sim_a, offset=-o, dim1=-2, dim2=-1).to(acc).sum(-1)
                mean = (d.to(dtype) / n_q.clamp(min=1).to(dtype)).double()
                ok = (n_e >= n_q) & (o <= n_e - n_q)
                best = torch.where(ok, torch.maximum(best, mean), best)
            if o < sq:    # D_b[o] = sum_i sim_b[i, o + i], i < n_e
                d = torch.diagonal(sim_b, offset=o, dim1=-2, dim2=-1).to(acc).sum(-1)
                mean = (d.to(dtype) / n_e.clamp(min=1).to(dtype)).double()
                ok = (n_e < n_q) & (o <= n_q - n_e)
                best = torch.where(ok, torch.maximum(best, mean), best)
        out[:, e0:e0 + step] = torch.where((n_e > 0) & (n_q > 0), best,
                                           torch.zeros_like(best))
    return out
