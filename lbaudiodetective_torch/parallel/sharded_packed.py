"""Sharded matching, search and ring dedup on packed planes (port of the
JAX package's ``parallel/sharded_packed.py``).

A packed library entry is two planes of uint32 words (held as int32), the
only form that fits BASELINE config 5's 1M tracks.  Three mesh
capabilities run directly on it, every match a call of the port's packed
matcher (``ops.match_packed.match_one_vs_many_packed``: the Hopper kernel
``csrc/match_packed.cu`` on CUDA, its plain version on the CPU):

- **Library sharding**: the library splits over the ``"library"`` slots,
  the query is replicated, and each slot scans its resident shard.  Scores
  are per entry, so they equal the single-device library's bit for bit.
- **Ring all-pairs**: packed blocks rotate around a ring of slots
  (``Mesh.ring_shift``); each step scores the resident block against the
  visiting one.
- **Ring dedup top-k**: the same ring with a streaming top-k fold, so no
  slot holds the O(L^2) scores.

Results are sharded: one tensor a slot (``mesh.unshard`` joins them).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lbaudiodetective_torch.ops.kernels.match_packed import match_one_vs_many_fused
from lbaudiodetective_torch.ops.match_packed import (
    _descending, _mask_pairs, match_one_vs_many_packed, two_stage_search_packed)
from lbaudiodetective_torch.parallel.mesh import Mesh, shard

#: Queries a launch of the match kernel takes at most (its grid's y limit).
MAX_QUERIES = 65535


def _library_shards(mesh: Mesh, axis: str, *arrays) -> list:
    """Per slot of ``axis``: a tuple of the arrays' int32 shards (words and
    counts), or ``None`` on a slot another process owns."""
    parts = zip(*(shard(a, mesh, axis) for a in arrays))
    return [None if p[0] is None else tuple(x.to(torch.int32) for x in p) for p in parts]


def match_library_sharded_packed(q_pos_w, q_neg_w, n_query,
                                 lib_pos_w, lib_neg_w, n_lib,
                                 pairs: int, mesh: Mesh,
                                 comparison_range: int = 0,
                                 subfingerprint_length: int = 200) -> list:
    """One-vs-many on a packed library sharded over ``"library"``.

    query: ``[Sq, W]`` int32 words + count (replicated to every slot);
    library: ``[L, Sl, W]`` words + ``[L]`` counts (tensors, split here, or
    lists of shards).  Returns the ``[L / n]`` scores of each slot.  Each
    slot runs the packed matcher on its resident shard: one kernel launch a
    slot on CUDA."""
    out = []
    for slot, part in zip(mesh.axis_slots("library"),
                          _library_shards(mesh, "library", lib_pos_w, lib_neg_w, n_lib)):
        if part is None:
            out.append(None)
            continue
        dev = slot.device
        n_q = n_query.to(dev) if isinstance(n_query, torch.Tensor) else n_query
        out.append(match_one_vs_many_packed(
            q_pos_w.to(dev, non_blocking=True), q_neg_w.to(dev, non_blocking=True), n_q,
            *part, pairs, comparison_range, subfingerprint_length))
    return out


def match_many_library_sharded_packed(q_pos_w, q_neg_w, n_query,
                                      lib_pos_w, lib_neg_w, n_lib,
                                      pairs: int, mesh: Mesh,
                                      comparison_range: int = 0,
                                      subfingerprint_length: int = 200) -> list:
    """Batched :func:`match_library_sharded_packed`: ``[B, Sq, W]`` query
    words and ``[B]`` counts -> ``[B, L / n]`` scores a slot, every query
    in one call of the matcher a slot (the packed matcher takes a leading
    query axis, so this is the same call)."""
    return match_library_sharded_packed(q_pos_w, q_neg_w, n_query, lib_pos_w, lib_neg_w,
                                        n_lib, pairs, mesh, comparison_range,
                                        subfingerprint_length)


def _packed_block_scores(res, vis, mask_pairs: int) -> torch.Tensor:
    """All-pairs scores of a resident block against a visiting block:
    ``([lr, S, W] x2, [lr]) x ([lv, S, W] x2, [lv]) -> [lr, lv]`` float32,
    ``[i, j]`` the match of resident ``i`` and visiting ``j`` with the
    longer one slid (the resident one at equal counts, as the reference's
    swap ``rc < vc`` does).  The match kernel slides its library entry at
    equal counts, so the visiting block goes in as the queries (split to
    ``MAX_QUERIES`` a launch) and the resident block as the library."""
    (res_pos, res_neg, res_cnt), (vis_pos, vis_neg, vis_cnt) = res, vis
    parts = [match_one_vs_many_fused(vis_pos[s:s + MAX_QUERIES], vis_neg[s:s + MAX_QUERIES],
                                     vis_cnt[s:s + MAX_QUERIES], res_pos, res_neg, res_cnt,
                                     mask_pairs)
             for s in range(0, max(len(vis_cnt), 1), MAX_QUERIES)]
    return torch.cat(parts).T


def _ring_setup(pos_w, neg_w, counts, mesh: Mesh, axis: str):
    res = _library_shards(mesh, axis, pos_w, neg_w, counts)
    l_local = next(p[0].shape[0] for p in res if p is not None)
    return mesh.axis_slots(axis), res, l_local


def ring_all_pairs_scores_packed(pos_w, neg_w, counts, pairs: int, mesh: Mesh,
                                 axis: str = "library",
                                 comparison_range: int = 0,
                                 subfingerprint_length: int = 200) -> list:
    """Many-vs-many scores over a ring of packed blocks.

    pos_w/neg_w: ``[L, S, W]`` int32 words, counts ``[L]`` (tensors or
    lists of shards over ``axis``).  Returns each slot's ``[L / n, L]``
    float32 rows: ``[i, j]`` the match of tracks i and j.  Step ``s`` of
    slot ``d`` scores its rows against the block that started on slot
    ``(d - s) mod n`` and writes it at that block's columns; n steps."""
    slots, res, l_local = _ring_setup(pos_w, neg_w, counts, mesh, axis)
    n = len(slots)
    mask = _mask_pairs(pairs, comparison_range, subfingerprint_length)
    out = [None if r is None else
           torch.empty((l_local, l_local * n), dtype=torch.float32, device=s.device)
           for s, r in zip(slots, res)]
    vis = res
    for step in range(n):
        for d, r in enumerate(res):
            if r is not None:
                src = (d - step) % n
                out[d][:, src * l_local:(src + 1) * l_local] = _packed_block_scores(
                    r, vis[d], mask)
        if step + 1 < n:
            vis = mesh.ring_shift(vis, axis)
    return out


def ring_dedup_topk_packed(pos_w, neg_w, counts, pairs: int, mesh: Mesh,
                           k: int = 8, axis: str = "library",
                           comparison_range: int = 0,
                           subfingerprint_length: int = 200) -> tuple[list, list]:
    """All-pairs candidate search with a streaming top-k on packed planes.

    Returns ``(scores, indices)``, each a list of ``[L / n, k]`` shards: the
    k best-matching *other* tracks of each track (self matches are -inf),
    descending.  Each ring step merges the running best with the new block
    (``[best | block]``) and keeps the k largest with a stable sort, so a
    tie goes to the earlier position, as ``lax.top_k`` gives it: a running
    best from an earlier step beats an equal score in the new block.  Slot
    d meets the blocks of slots d, d - 1, ... in turn, so the index kept on
    a tie depends on the ring's size; the scores do not."""
    slots, res, l_local = _ring_setup(pos_w, neg_w, counts, mesh, axis)
    n = len(slots)
    mask = _mask_pairs(pairs, comparison_range, subfingerprint_length)
    best_s, best_i = [], []
    for s, r in zip(slots, res):
        best_s.append(None if r is None else
                      torch.full((l_local, k), -torch.inf, dtype=torch.float32, device=s.device))
        best_i.append(None if r is None else
                      torch.full((l_local, k), -1, dtype=torch.int64, device=s.device))
    vis = res
    for step in range(n):
        for d, r in enumerate(res):
            if r is None:
                continue
            dev = slots[d].device
            src = (d - step) % n
            block = _packed_block_scores(r, vis[d], mask)
            cols = src * l_local + torch.arange(l_local, device=dev)
            rows = d * l_local + torch.arange(l_local, device=dev)
            block = block.masked_fill(rows[:, None] == cols[None, :], -torch.inf)
            merged = torch.cat([best_s[d], block], dim=1)
            merged_idx = torch.cat([best_i[d], cols[None, :].expand(l_local, -1)], dim=1)
            order = _descending(merged)[:, :k]
            best_s[d] = torch.gather(merged, 1, order)
            best_i[d] = torch.gather(merged_idx, 1, order)
        if step + 1 < n:
            vis = mesh.ring_shift(vis, axis)
    return best_s, best_i


def _search_shards(queries, lib, libc, pairs: int, mesh: Mesh, comparison_range: int,
                   subfingerprint_length: int, coarse_range: int, chunk: int,
                   shortlist: int, top_k: int) -> tuple[np.ndarray, np.ndarray]:
    """Each slot's two-stage search on its shard, indices offset to the
    global entry axis; ``([..., n * k_local] indices, scores)`` on the host,
    in slot order."""
    slots = mesh.require_local("library", "sharded search")
    lib = _library_shards(mesh, "library", *lib)
    libc = _library_shards(mesh, "library", *libc)
    l_local = lib[0][0].shape[0]
    chunk = min(chunk, libc[0][0].shape[0])
    k_local = min(top_k, l_local)
    # The exact stage re-scores `shortlist` candidates and the local top-k
    # draws from them, so the shortlist must cover k_local (tiny shards).
    shortlist = max(min(shortlist, l_local), k_local)
    idx_parts, sc_parts = [], []
    for i, (slot, exact, coarse) in enumerate(zip(slots, lib, libc)):
        dev = slot.device
        pad = (-coarse[0].shape[0]) % chunk
        if pad:            # a shard rarely divides the chunk (1M / 8 = 125,000)
            coarse = tuple(F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad)) for x in coarse)
        q = [x.to(dev, non_blocking=True) if isinstance(x, torch.Tensor) else x
             for x in queries]
        idx, sc = two_stage_search_packed(*q, *exact, *coarse, pairs, comparison_range,
                                          subfingerprint_length, coarse_range, chunk,
                                          shortlist, k_local)
        idx_parts.append((idx + i * l_local).cpu())
        sc_parts.append(sc.cpu())
    return torch.cat(idx_parts, dim=-1).numpy(), torch.cat(sc_parts, dim=-1).numpy()


def search_library_sharded_packed(q_pos_w, q_neg_w, n_query,
                                  qc_pos_w, qc_neg_w, n_query_c,
                                  lib_pos_w, lib_neg_w, n_lib,
                                  libc_pos_w, libc_neg_w, n_lib_c,
                                  pairs: int, mesh: Mesh,
                                  comparison_range: int = 0,
                                  subfingerprint_length: int = 200,
                                  coarse_range: int = 64,
                                  chunk: int = 65536,
                                  shortlist: int = 1024,
                                  top_k: int = 5) -> tuple[np.ndarray, np.ndarray]:
    """Two-stage coarse -> exact search with the packed library sharded
    over ``"library"`` (``FingerprintLibrary.search`` at pod scale).

    Each slot runs ``ops.match_packed.two_stage_search_packed`` on its
    shard (``shortlist`` and ``chunk`` apply a shard; coarse planes are
    zero-padded to a ``chunk`` multiple inside the shard) and contributes
    its top-k with globally offset indices; the host merges them with a
    stable sort over the slots in order, so a tie goes to the lower slot.
    Exact whenever every true global top-k entry survives its own shard's
    shortlist.  Returns ``(indices [top_k] int64, exact scores [top_k])``."""
    idx, sc = _search_shards(
        (q_pos_w, q_neg_w, n_query, qc_pos_w, qc_neg_w, n_query_c),
        (lib_pos_w, lib_neg_w, n_lib), (libc_pos_w, libc_neg_w, n_lib_c), pairs, mesh,
        comparison_range, subfingerprint_length, coarse_range, chunk, shortlist, top_k)
    order = np.argsort(-sc, kind="stable")[:top_k]
    return idx[order].astype(np.int64), sc[order]


def search_many_library_sharded_packed(q_pos_w, q_neg_w, n_query,
                                       qc_pos_w, qc_neg_w, n_query_c,
                                       lib_pos_w, lib_neg_w, n_lib,
                                       libc_pos_w, libc_neg_w, n_lib_c,
                                       pairs: int, mesh: Mesh,
                                       comparison_range: int = 0,
                                       subfingerprint_length: int = 200,
                                       coarse_range: int = 64,
                                       chunk: int = 65536,
                                       shortlist: int = 1024,
                                       top_k: int = 5) -> tuple[np.ndarray, np.ndarray]:
    """Batched :func:`search_library_sharded_packed`: B queries (a leading
    axis on every query input) in one search call a slot; returns
    ``(indices [B, top_k], scores [B, top_k])`` merged on the host."""
    idx, sc = _search_shards(
        (q_pos_w, q_neg_w, n_query, qc_pos_w, qc_neg_w, n_query_c),
        (lib_pos_w, lib_neg_w, n_lib), (libc_pos_w, libc_neg_w, n_lib_c), pairs, mesh,
        comparison_range, subfingerprint_length, coarse_range, chunk, shortlist, top_k)
    order = np.argsort(-sc, axis=1, kind="stable")[:, :top_k]
    return (np.take_along_axis(idx, order, axis=1).astype(np.int64),
            np.take_along_axis(sc, order, axis=1))
