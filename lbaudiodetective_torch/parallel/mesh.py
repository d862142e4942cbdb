"""A mesh of device slots and its two collectives (port of the JAX
package's ``parallel/mesh.py``).

JAX's ``Mesh`` is a grid of devices driven by one program, its collectives
compiled into XLA ops.  Here a mesh is a grid of **slots**: each slot is a
``torch.device`` plus the rank of the process that owns it.  Slots may
repeat a device: ``make_mesh(devices=["cuda:0"] * 4)`` runs the partitioned
code on one card, as the JAX package runs it on virtual CPU devices, and
the CPU tests use ``["cpu"] * 8``.

A sharded tensor is a plain list of per-slot tensors split along one mesh
axis (``shard``); a slot another process owns holds ``None``.  Slots on one
device hold views of the whole, never copies; padding copies only when the
axis does not divide the leading dimension.  The collectives are
:meth:`Mesh.ring_shift` (``lax.ppermute`` of ``i -> i + 1 mod n``) and
:meth:`Mesh.psum`; between slots of one process they are device copies
(none on one device), between processes ``torch.distributed`` point-to-
point and ``all_reduce``.  The slots of an axis are the ones at index 0 of
every other axis: the other rows of a sharded axis are replicas, and only
the first computes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from lbaudiodetective_torch.device import DEFAULT_DEVICE, resolve_device


def world() -> tuple[int, int]:
    """``(world size, rank)`` of this process: ``(1, 0)`` outside a
    ``torch.distributed`` process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclasses.dataclass(frozen=True)
class Slot:
    """One place of a mesh: its position in slot order, its device and the
    rank of the process that computes there."""

    index: int
    device: torch.device
    rank: int = 0


class Mesh:
    """A grid of :class:`Slot` with named axes; ``shape`` maps each axis
    name to its size (``mesh.shape["library"]``), as in JAX."""

    def __init__(self, slots, axis_names: tuple[str, ...]):
        grid = np.array(slots, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-D slots for axes {tuple(axis_names)}")
        if len({s.device.type for s in grid.flat}) > 1:
            raise ValueError("a mesh holds slots of one device type, got "
                             f"{sorted({str(s.device) for s in grid.flat})}")
        self.slots = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))

    @property
    def devices(self) -> np.ndarray:
        """The slots' devices, in the mesh's shape."""
        out = np.empty(self.slots.shape, dtype=object)
        for pos in np.ndindex(out.shape):
            out[pos] = self.slots[pos].device
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {sorted({str(s.device) for s in self.slots.flat})})"

    def axis_slots(self, axis: str) -> list[Slot]:
        """The slots along ``axis`` at index 0 of every other axis."""
        a = self.axis_names.index(axis)
        pos = [0] * self.slots.ndim
        out = []
        for i in range(self.slots.shape[a]):
            pos[a] = i
            out.append(self.slots[tuple(pos)])
        return out

    @staticmethod
    def is_local(slot: Slot) -> bool:
        return slot.rank == world()[1]

    def require_local(self, axis: str, what: str) -> list[Slot]:
        """``axis_slots``, raising ``ValueError`` where another process owns
        one (``what`` gathers its results on this host)."""
        slots = self.axis_slots(axis)
        if not all(self.is_local(s) for s in slots):
            raise ValueError(f"{what} needs every slot of the {axis!r} axis in this process")
        return slots

    # -- collectives ---------------------------------------------------------

    def ring_shift(self, shards: list, axis: str) -> list:
        """``lax.ppermute`` of ``(i -> i + 1 mod n)`` over ``axis``:
        slot ``i``'s shard (a tensor or a tuple of tensors) moves to slot
        ``i + 1``.  Within a process a shard moves with a non-blocking
        ``.to`` (a no-op between slots of one device); between processes
        every send and receive of the step goes in one
        ``batch_isend_irecv``, so a ring of processes cannot deadlock.  A
        received shard takes the shape of the receiving slot's own."""
        slots = self.axis_slots(axis)
        n = len(slots)
        if len(shards) != n:
            raise ValueError(f"{len(shards)} shards for {n} slots of {axis!r}")
        out: list = [None] * n
        ops = []
        for i, src in enumerate(slots):
            j = (i + 1) % n
            dst = slots[j]
            if self.is_local(src) and self.is_local(dst):
                out[j] = _map(shards[i], lambda t: t.to(dst.device, non_blocking=True))
            elif self.is_local(src):
                for k, t in enumerate(_flat(shards[i])):
                    ops.append(dist.P2POp(dist.isend, t.contiguous(), dst.rank, tag=8 * j + k))
            elif self.is_local(dst):
                bufs = [torch.empty_like(t) for t in _flat(shards[j])]
                for k, b in enumerate(bufs):
                    ops.append(dist.P2POp(dist.irecv, b, src.rank, tag=8 * j + k))
                out[j] = bufs[0] if isinstance(shards[j], torch.Tensor) else tuple(bufs)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def psum(self, values: list, axis: str) -> torch.Tensor:
        """Sum of the per-slot ``values`` over ``axis``: this process's
        slots in slot order on its first slot's device, then
        ``all_reduce`` across processes where the axis spans more than
        one."""
        slots = self.axis_slots(axis)
        local = [v for s, v in zip(slots, values) if self.is_local(s)]
        if not local:
            raise ValueError(f"this process holds no slot of {axis!r}")
        dev = local[0].device
        total = local[0].clone()
        for v in local[1:]:
            total = total + v.to(dev)
        if len({s.rank for s in slots}) > 1:
            dist.all_reduce(total)
        return total


def _flat(shard) -> list[torch.Tensor]:
    return [shard] if isinstance(shard, torch.Tensor) else list(shard)


def _map(shard, fn):
    return fn(shard) if isinstance(shard, torch.Tensor) else tuple(fn(t) for t in shard)


def make_mesh(n_devices: int | None = None,
              axis_names: tuple[str, str] = ("data", "library"),
              library_parallelism: int | None = None,
              devices=None,
              device: torch.device | str = DEFAULT_DEVICE) -> Mesh:
    """A 2-D ``(data, library)`` mesh over the first ``n_devices`` slots.

    ``devices`` names the slots' devices and may repeat one
    (``["cuda:0"] * 4``).  Without it, ``device`` ("cuda" by default,
    ``RuntimeError`` without CUDA) decides: on CUDA the slots are every
    process's visible cards once each, and asking for more raises
    ``ValueError`` as JAX does; on the CPU ``n_devices`` names the slot
    count.  In a ``torch.distributed`` group of W processes the slots split
    into W equal runs in rank order (process-major, as ``jax.devices()``).
    ``library_parallelism`` fixes the library axis; by default it is the
    largest power of two ``p`` with ``p * p <= n`` and ``n % p == 0``, as
    in JAX, so both axes scale.
    """
    n_proc, _ = world()
    if devices is None:
        dev = resolve_device(device, "make_mesh")
        if dev.type == "cuda":
            devices = [torch.device("cuda", i)
                       for _ in range(n_proc) for i in range(torch.cuda.device_count())]
        elif n_devices is None:
            raise ValueError("a CPU mesh needs n_devices: the slot count")
        else:
            devices = [dev] * n_devices
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, only {len(devices)} available")
    if n % n_proc:
        raise ValueError(f"{n} slots do not split over {n_proc} processes")
    if library_parallelism is None:
        library_parallelism = 1
        while (library_parallelism * 2) ** 2 <= n and n % (library_parallelism * 2) == 0:
            library_parallelism *= 2
    if n % library_parallelism:
        raise ValueError(f"{n} devices not divisible by library axis {library_parallelism}")
    per_rank = n // n_proc
    slots = [Slot(i, d, i // per_rank) for i, d in enumerate(devices[:n])]
    grid = np.empty((n // library_parallelism, library_parallelism), dtype=object)
    for i, s in enumerate(slots):
        grid[divmod(i, library_parallelism)] = s
    return Mesh(grid, axis_names)


def submesh(slots, axis: str) -> Mesh:
    """A 1-D mesh named ``axis`` over ``slots`` (slots of another mesh keep
    their indices, so two submeshes of one mesh are disjoint exactly when
    they share no slot)."""
    slots = list(slots)
    grid = np.empty(len(slots), dtype=object)
    for i, s in enumerate(slots):
        grid[i] = s
    return Mesh(grid, (axis,))


# -- sharded tensors -------------------------------------------------------------


def as_tensor(x) -> torch.Tensor:
    """A tensor over ``x``: packed uint32 words (NumPy) become int32 with
    the same bits, as the port holds them."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def shard(x, mesh: Mesh, axis: str) -> list:
    """Split ``x`` along its first dimension over the slots of ``axis``.
    A list or tuple is taken as already sharded.  The first dimension is
    zero-padded to a multiple of the slot count (a copy, only then); each
    local slot gets its piece on its device, a view where the device is
    ``x``'s; slots of other processes get ``None``."""
    slots = mesh.axis_slots(axis)
    if isinstance(x, (list, tuple)):
        if len(x) != len(slots):
            raise ValueError(f"{len(x)} shards for {len(slots)} slots of {axis!r}")
        return list(x)
    x = as_tensor(x)
    n = len(slots)
    pad = (-x.shape[0]) % n
    if pad:
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
    per = x.shape[0] // n
    return [x[i * per:(i + 1) * per].to(s.device, non_blocking=True)
            if mesh.is_local(s) else None for i, s in enumerate(slots)]


def unshard(shards: list, dim: int = 0) -> torch.Tensor:
    """The shards concatenated along ``dim`` on the first one's device
    (every shard must be in this process)."""
    if any(s is None for s in shards):
        raise ValueError("unshard needs every shard in this process")
    dev = shards[0].device
    return torch.cat([s.to(dev) for s in shards], dim=dim)
