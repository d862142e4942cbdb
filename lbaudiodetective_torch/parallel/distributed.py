"""Joining a multi-process job, and the library shard a process owns (port
of the JAX package's ``parallel/distributed.py``).

Every process calls :func:`initialize` before building meshes; a process
that fails re-joins through the coordinator and reloads its library shard
from the sharded checkpoint (``utils.serialize.save_library_sharded``), so
the matching service restarts per process without refingerprinting.  After
it, ``make_mesh`` gives each rank its run of slots and the mesh's
collectives cross processes through ``torch.distributed``.

The backend is the caller's: ``nccl`` by default for CUDA slots, ``gloo``
for CPU slots, never switched silently.  NCCL refuses two ranks on one
GPU, so on a one-card host the cross-process path runs only on the CPU
(``tests/test_torch_distributed.py`` runs it in two gloo processes).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from lbaudiodetective_torch.device import DEFAULT_DEVICE, resolve_device


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None,
               device: torch.device | str = DEFAULT_DEVICE) -> None:
    """Join (or re-join after a failure) the multi-process job.

    A no-op in one process (no address and no process count).  Otherwise
    ``torch.distributed.init_process_group`` with
    ``init_method="tcp://<coordinator_address>"`` (``host:port``), the world
    size and this rank.  ``backend`` defaults to ``nccl`` when ``device`` is
    CUDA (the default; ``RuntimeError`` without CUDA) and ``gloo`` on the
    CPU."""
    if coordinator_address is None and num_processes is None:
        return
    if backend is None:
        backend = "nccl" if resolve_device(device, "initialize").type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def shard_bounds(total: int, process_id: int, num_processes: int) -> tuple[int, int]:
    """Library shard ``[start, end)`` owned by a process: the unit of
    checkpoint reload on restart."""
    per = -(-total // num_processes)
    start = min(process_id * per, total)
    return start, min(start + per, total)
