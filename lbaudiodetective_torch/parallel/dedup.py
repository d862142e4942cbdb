"""Pod-scale library deduplication on unpacked planes (port of the JAX
package's ``parallel/dedup.py``): every track is matched against every
other over a ring of slots and each slot keeps its tracks' top-k candidates,
one visiting block at a time, so no slot holds the O(L^2) scores.  The
planes are packed on their device and run through
``parallel.sharded_packed.ring_dedup_topk_packed`` (the match kernel on
CUDA)."""

from __future__ import annotations

from lbaudiodetective_torch.parallel.mesh import Mesh
from lbaudiodetective_torch.parallel.sharded import _packed, _pairs
from lbaudiodetective_torch.parallel.sharded_packed import ring_dedup_topk_packed


def ring_dedup_topk(pos, neg, counts, mesh: Mesh, k: int = 8,
                    axis: str = "library",
                    comparison_range: int = 0,
                    subfingerprint_length: int = 200) -> tuple[list, list]:
    """All-pairs candidate search with a streaming top-k.

    pos/neg: ``[L, S, pairs]`` uint8 planes, counts ``[L]`` (or their shards
    over ``axis``).  Returns ``(scores, indices)``, each a list of
    ``[L / n, k]`` shards: the k best-matching *other* tracks of each track,
    self matches masked out, ties to the earlier candidate."""
    return ring_dedup_topk_packed(_packed(pos), _packed(neg), counts, _pairs(pos), mesh, k,
                                  axis, comparison_range, subfingerprint_length)
