"""Multi-device parallelism: a mesh of device slots, sharded extraction and
matching, and ring collectives for pod-scale library search (port of the
JAX package's ``parallel/``).

The scale axes of BASELINE map onto a ``("data", "library")`` mesh of
slots (``parallel.mesh``): clips split over ``"data"`` (data parallelism),
the fingerprint library over ``"library"``, and all-pairs and
long-fingerprint work rides a ring of slots.  Every match is a call of the
packed matcher (the Hopper match kernel on CUDA) and every extraction the
port's extractor; the collectives are device copies within a process and
``torch.distributed`` across processes.
"""

from lbaudiodetective_torch.parallel.mesh import make_mesh
from lbaudiodetective_torch.parallel.long_match import match_long_time_sharded
from lbaudiodetective_torch.parallel.sharded import (
    extract_data_parallel,
    match_library_sharded,
    ring_all_pairs_scores,
)
from lbaudiodetective_torch.parallel.sharded_packed import (
    match_library_sharded_packed,
    ring_all_pairs_scores_packed,
    ring_dedup_topk_packed,
)
from lbaudiodetective_torch.parallel.sharded_library import (
    ShardedFingerprintLibrary,
)

__all__ = [
    "make_mesh",
    "extract_data_parallel",
    "match_library_sharded",
    "match_library_sharded_packed",
    "match_long_time_sharded",
    "ring_all_pairs_scores",
    "ring_all_pairs_scores_packed",
    "ring_dedup_topk_packed",
    "ShardedFingerprintLibrary",
]
