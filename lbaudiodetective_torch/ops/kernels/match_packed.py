"""Packed one-vs-many matcher: query words ``[B, Sq, W]`` vs library words
``[L, Sl, W]`` (+ counts) ``-> [B, L]`` float32 scores.

Port of ``lbaudiodetective_tpu/ops/pallas/match_fused.py`` (kernel
``match_one_vs_many_fused``), whose scores equal the XLA packed matcher
``ops/match_packed.py::match_one_vs_many_packed``.  Words are the packed
uint32 planes held as int32 with the same bits (torch has no uint32 shifts
on the CPU and no popcount op).  Only the first ``mask_pairs`` pairs of
each plane are compared (quirk Q11).  On a CUDA tensor the hand-written
kernel ``csrc/match_packed.cu`` runs; on a CPU tensor the plain version
below.  The kernel reads each library entry once a launch, whatever the
number of queries; its scores are bit-equal to the plain version's.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from lbaudiodetective_torch.ops.match import _both_orientation_scores

#: Shared memory a block may opt in to on the H100 (sm_90), in bytes.
SMEM_LIMIT = 232448
#: Shared memory a CTA may take for two, or four, to share an SM (228 KB an
#: SM, 1 KB of it reserved a block).
SMEM_TWO_CTAS = 115712
SMEM_FOUR_CTAS = 57344
#: Library entries a chunk of the kernel's walk: at most, and at least while
#: every query of a launch fits in one CTA.
CHUNK_ENTRIES = 64
MIN_CHUNK_ENTRIES = 16


def prefix_mask_words(mask_pairs: int, w: int) -> np.ndarray:
    """``[w]`` uint32 words with the first ``mask_pairs`` bits set."""
    out = np.zeros(w, np.uint32)
    for k in range(w):
        out[k] = (1 << min(max(mask_pairs - 32 * k, 0), 32)) - 1
    return out


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int32 tensor (SWAR).  int32 ``>>``
    is arithmetic, but every shifted value is masked before it is used, so
    the copies of the sign bit never count; the first subtraction wraps
    modulo 2^32 as the unsigned form does."""
    v = x - ((x >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    return (v + (v >> 16)) & 0x3F


def match_one_vs_many_fused_plain(q_pos_w: torch.Tensor, q_neg_w: torch.Tensor,
                                  n_query: torch.Tensor, lib_pos_w: torch.Tensor,
                                  lib_neg_w: torch.Tensor, n_lib: torch.Tensor,
                                  mask_pairs: int) -> torch.Tensor:
    """Plain version, the XLA packed matcher's math: AND the words,
    popcount, sum over the compared words into ``[L, Sl, Sq]`` hits, then
    the offset-sliding scores of both orientations."""
    (b, sq, w), (l, sl, _) = q_pos_w.shape, lib_pos_w.shape
    dev = lib_pos_w.device
    wu = min(w, (mask_pairs + 31) // 32)
    m = torch.from_numpy(prefix_mask_words(mask_pairs, w).view(np.int32)).to(dev)
    lp, ln = lib_pos_w & m, lib_neg_w & m
    lib_planes = [(lp[..., k, None].contiguous(), ln[..., k, None].contiguous())
                  for k in range(wu)]                                 # [L, Sl, 1]

    def inv_possible(p, n):
        c = popcount32(p | n).sum(-1).to(torch.float32)
        return torch.where(c > 0.0, 1.0 / torch.clamp(c, min=1.0), torch.zeros_like(c))

    inv_lib = inv_possible(lp, ln)                                   # [L, Sl]
    out = torch.zeros((b, l), dtype=torch.float32, device=dev)
    for i in range(b):
        qp, qn = q_pos_w[i] & m, q_neg_w[i] & m                      # [Sq, W]
        hits = torch.zeros((l, sl, sq), dtype=torch.int32, device=dev)
        for k, (lpk, lnk) in enumerate(lib_planes):    # one [L, Sl, Sq] plane at a time
            hits += popcount32(lpk & qp[:, k].contiguous())
            hits += popcount32(lnk & qn[:, k].contiguous())
        out[i] = _both_orientation_scores(hits.to(torch.float32), inv_lib,
                                          inv_possible(qp, qn), n_lib,
                                          n_query[i].expand(l))
    return out


def launch_plan(smem_bytes, b: int, sq: int, sl: int, w: int) -> tuple[int, int, int]:
    """``(queries a CTA, entries a chunk, CTAs an SM)`` of a kernel launch.
    Every query in one CTA with the largest chunks of ``MIN_CHUNK_ENTRIES``
    to ``CHUNK_ENTRIES`` entries that fit in a quarter of an SM's shared
    memory (four CTAs an SM, as in a search's coarse pass), else in half;
    where the queries do not fit so, groups of as many queries as fit
    beside the largest chunk of up to ``MIN_CHUNK_ENTRIES`` entries, two
    CTAs an SM, else one.  ``smem_bytes(bg, sq, e, sl, w)`` is the kernel's
    layout (``lbad_match_packed_smem_bytes``).  Raises ``ValueError``
    naming the limit when one query and one entry do not fit."""
    b = max(b, 1)
    for ctas, budget in ((4, SMEM_FOUR_CTAS), (2, SMEM_TWO_CTAS)):
        e = CHUNK_ENTRIES
        while e >= MIN_CHUNK_ENTRIES and smem_bytes(b, sq, e, sl, w) > budget:
            e //= 2
        if e >= MIN_CHUNK_ENTRIES:
            return b, e, ctas
    for ctas, budget in ((2, SMEM_TWO_CTAS), (1, SMEM_LIMIT)):
        e = MIN_CHUNK_ENTRIES
        while e >= 1 and smem_bytes(1, sq, e, sl, w) > budget:
            e //= 2
        if e >= 1:
            bg, hi = 1, b
            while bg < hi:                          # the most queries that fit
                mid = (bg + hi + 1) // 2
                if smem_bytes(mid, sq, e, sl, w) <= budget:
                    bg = mid
                else:
                    hi = mid - 1
            return bg, e, ctas
    raise ValueError(f"Sq={sq}, Sl={sl}, W={w} needs {smem_bytes(1, sq, 1, sl, w)} bytes of "
                     f"shared memory per block; the limit is {SMEM_LIMIT}")


@lru_cache(maxsize=256)
def _device_plan(b: int, sq: int, sl: int, w: int) -> tuple[int, int, int]:
    """``launch_plan`` with the kernel's own layout, once per shape."""
    from lbaudiodetective_torch.ops.kernels._build import load_library

    return launch_plan(load_library().lbad_match_packed_smem_bytes, b, sq, sl, w)


def _check(q_pos_w, q_neg_w, n_query, lib_pos_w, lib_neg_w, n_lib) -> None:
    words = (q_pos_w, q_neg_w, lib_pos_w, lib_neg_w)
    if any(t.dtype != torch.int32 for t in (*words, n_query, n_lib)):
        raise TypeError("match_one_vs_many_fused takes int32 words and counts")
    if q_pos_w.dim() != 3 or lib_pos_w.dim() != 3:
        raise ValueError("match_one_vs_many_fused takes [B, Sq, W] query and "
                         "[L, Sl, W] library words")
    if q_neg_w.shape != q_pos_w.shape or lib_neg_w.shape != lib_pos_w.shape:
        raise ValueError("pos/neg word shapes differ")
    if q_pos_w.shape[2] != lib_pos_w.shape[2]:
        raise ValueError(f"query has {q_pos_w.shape[2]} words per row, library "
                         f"{lib_pos_w.shape[2]}")
    if n_query.shape != q_pos_w.shape[:1] or n_lib.shape != lib_pos_w.shape[:1]:
        raise ValueError("counts must be [B] and [L]")
    if len({t.device for t in (*words, n_query, n_lib)}) != 1:
        raise ValueError("query, library and counts must share one device")


def match_one_vs_many_fused(q_pos_w: torch.Tensor, q_neg_w: torch.Tensor,
                            n_query: torch.Tensor, lib_pos_w: torch.Tensor,
                            lib_neg_w: torch.Tensor, n_lib: torch.Tensor,
                            mask_pairs: int) -> torch.Tensor:
    """``[B, Sq, W]`` query words + ``[B]`` counts vs ``[L, Sl, W]`` library
    words + ``[L]`` counts (all int32) ``-> [B, L]`` float32 scores.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``match_one_vs_many_fused.launches`` counts the launches).  Counts are
    clamped to ``[0, S]`` by the kernel."""
    _check(q_pos_w, q_neg_w, n_query, lib_pos_w, lib_neg_w, n_lib)
    dev = lib_pos_w.device
    if dev.type == "cpu":
        return match_one_vs_many_fused_plain(q_pos_w, q_neg_w, n_query, lib_pos_w,
                                             lib_neg_w, n_lib, mask_pairs)
    if dev.type != "cuda":
        raise NotImplementedError(f"no match kernel for device {dev}")
    from lbaudiodetective_torch.ops.kernels._build import check, load_library

    lib = load_library()
    (b, sq, w), (l, sl, _) = q_pos_w.shape, lib_pos_w.shape
    if b > 65535:
        raise ValueError(f"at most 65535 queries per launch, got {b}")
    bg, e, ctas = _device_plan(b, sq, sl, w)
    out = torch.empty((b, l), dtype=torch.float32, device=dev)
    if b == 0 or l == 0:
        return out
    t = [x.contiguous() for x in (q_pos_w, q_neg_w, n_query, lib_pos_w, lib_neg_w, n_lib)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        check(lib.lbad_match_packed(t[0].data_ptr(), t[1].data_ptr(), t[2].data_ptr(), b, sq,
                                    t[3].data_ptr(), t[4].data_ptr(), t[5].data_ptr(), l, sl,
                                    w, mask_pairs, bg, e, ctas, out.data_ptr(), stream),
              "match_one_vs_many_fused")
    match_one_vs_many_fused.launches += 1
    return out


match_one_vs_many_fused.launches = 0
