"""Sharded extraction and matching on unpacked planes (port of the JAX
package's ``parallel/sharded.py``).

- **Data parallelism**: batched extraction with the clip axis split over
  the ``"data"`` slots; each slot runs the port's extractor on its clips
  (on CUDA the rows kernel ``csrc/fused_rows.cu`` at 128 x 32, with the
  select inside).  No collective.
- **Library sharding** and **ring all-pairs** on ``{0, 1}`` uint8 planes:
  both sides are packed on their device (``pack_bits_device``) and go
  through ``parallel.sharded_packed``, so every match is a call of the
  packed matcher (the match kernel on CUDA); the ``[L, L, S, pairs]``
  broadcast of the reference is never built.  Packed and unpacked scores
  are equal.
"""

from __future__ import annotations

import torch

from lbaudiodetective_torch.config import FingerprintConfig
from lbaudiodetective_torch.ops.extract import extract_fingerprint_padded
from lbaudiodetective_torch.ops.match_packed import pack_bits_device
from lbaudiodetective_torch.parallel.mesh import Mesh, as_tensor, shard
from lbaudiodetective_torch.parallel.sharded_packed import (
    match_library_sharded_packed, ring_all_pairs_scores_packed)


def extract_data_parallel(audio, n_valid_sub, config: FingerprintConfig,
                          n_rows: int, mesh: Mesh) -> tuple[list, list]:
    """Batched extraction with the clip axis split over the ``"data"`` slots.

    audio: ``[B, T]`` float32 (padded to a multiple of the data axis with
    silent clips); n_valid_sub: ``[B]``.  Returns ``(pos, neg)``, each a
    list of ``[B / n, n_rows / rows_per_frame, pairs]`` uint8 shards."""
    pos, neg = [], []
    for a, n in zip(shard(audio, mesh, "data"), shard(n_valid_sub, mesh, "data")):
        if a is None:
            pos.append(None)
            neg.append(None)
            continue
        p, q = extract_fingerprint_padded(a, n, config, n_rows)
        pos.append(p)
        neg.append(q)
    return pos, neg


def _pairs(planes) -> int:
    """Pairs a row of uint8 planes (a tensor or shards, some ``None``)."""
    if isinstance(planes, (list, tuple)):
        return int(next(p for p in planes if p is not None).shape[-1])
    return int(as_tensor(planes).shape[-1])


def _packed(planes) -> list | torch.Tensor:
    """Words of uint8 planes (a tensor or shards), packed on their device."""
    if isinstance(planes, (list, tuple)):
        return [None if p is None else pack_bits_device(p) for p in planes]
    return pack_bits_device(as_tensor(planes))


def match_library_sharded(query_pos, query_neg, n_query,
                          lib_pos, lib_neg, n_lib, mesh: Mesh,
                          comparison_range: int = 0,
                          subfingerprint_length: int = 200) -> list:
    """One-vs-many with the library split over ``"library"``.

    query: ``[S, pairs]`` uint8 + count (replicated); library: ``[L, S,
    pairs]`` + ``[L]`` counts (or their shards).  Returns each slot's
    ``[L / n]`` scores."""
    return match_library_sharded_packed(
        _packed(query_pos), _packed(query_neg), n_query, _packed(lib_pos), _packed(lib_neg),
        n_lib, _pairs(query_pos), mesh, comparison_range, subfingerprint_length)


def ring_all_pairs_scores(pos, neg, counts, mesh: Mesh, axis: str = "library",
                          comparison_range: int = 0,
                          subfingerprint_length: int = 200) -> list:
    """Many-vs-many scores over a ring (pod-scale dedup): ``[L, S, pairs]``
    uint8 planes and ``[L]`` counts (or their shards over ``axis``) -> each
    slot's ``[L / n, L]`` rows, ``[i, j]`` the match of tracks i and j."""
    return ring_all_pairs_scores_packed(_packed(pos), _packed(neg), counts, _pairs(pos), mesh,
                                        axis, comparison_range, subfingerprint_length)
