"""The port's mesh of device slots (``lbaudiodetective_torch/parallel/
mesh.py``) on the CPU: its shapes equal the JAX package's ``make_mesh`` on
the 8 virtual CPU devices of tests/conftest.py for every slot count and
library axis, it refuses what JAX refuses, a sharded tensor holds views
(a copy only to pad), and the two collectives move and sum per-slot
tensors as ``lax.ppermute`` and ``lax.psum`` do."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from lbaudiodetective_torch.parallel.mesh import (  # noqa: E402
    Mesh, Slot, make_mesh, shard, submesh, unshard)


@pytest.mark.parametrize("library_parallelism", [None, 1, 2, 4])
@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_equals_jax(n, library_parallelism):
    try:
        ref = dict(jax_make_mesh(n, library_parallelism=library_parallelism).shape)
    except ValueError:
        with pytest.raises(ValueError, match="not divisible"):
            make_mesh(n, library_parallelism=library_parallelism, device="cpu")
        return
    mesh = make_mesh(n, library_parallelism=library_parallelism, device="cpu")
    assert mesh.shape == ref
    assert [s.index for s in mesh.slots.flat] == list(range(n))
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert all(s.rank == 0 for s in mesh.slots.flat)


def test_mesh_errors():
    with pytest.raises(ValueError, match="requested 9 devices, only 8"):
        jax_make_mesh(9)
    with pytest.raises(ValueError, match="requested 4 devices, only 2"):
        make_mesh(4, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="needs n_devices"):
        make_mesh(device="cpu")
    with pytest.raises(ValueError, match="one device type"):
        make_mesh(devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="3-D"):
        Mesh(np.empty((1, 1, 1), dtype=object), ("data", "library"))
    mesh = make_mesh(devices=["cpu"] * 6, library_parallelism=3)
    assert mesh.shape == {"data": 2, "library": 3}
    assert [s.index for s in mesh.axis_slots("library")] == [0, 1, 2]
    assert [s.index for s in mesh.axis_slots("data")] == [0, 3]


def test_shard_holds_views_and_pads_by_copy():
    mesh = make_mesh(8, device="cpu")                     # library axis 2
    x = torch.arange(12).reshape(6, 2)
    parts = shard(x, mesh, "library")
    assert [p.shape[0] for p in parts] == [3, 3]
    assert parts[0].data_ptr() == x.data_ptr()            # a view, not a copy
    assert parts[1].data_ptr() == x[3:].data_ptr()
    assert torch.equal(unshard(parts), x)
    ragged = shard(torch.arange(7), mesh, "data")         # 4 slots: pads to 8
    assert [p.tolist() for p in ragged] == [[0, 1], [2, 3], [4, 5], [6, 0]]
    assert shard(parts, mesh, "library") == parts         # a list is already sharded
    with pytest.raises(ValueError, match="3 shards for 2 slots"):
        shard([x, x, x], mesh, "library")
    words = np.array([[0xFFFFFFFF, 1]], np.uint32)        # packed words keep their bits
    assert shard(words, make_mesh(devices=["cpu"]), "library")[0].tolist() == [[-1, 1]]


def test_ring_shift_is_ppermute_and_psum_sums_in_slot_order():
    mesh = make_mesh(devices=["cpu"] * 4, library_parallelism=4)
    shards = [torch.full((2,), float(i)) for i in range(4)]
    moved = mesh.ring_shift(shards, "library")
    assert [float(t[0]) for t in moved] == [3.0, 0.0, 1.0, 2.0]      # i -> i + 1 mod n
    pairs = mesh.ring_shift(list(zip(shards, shards)), "library")
    assert [float(p[1][0]) for p in pairs] == [3.0, 0.0, 1.0, 2.0]
    total = mesh.psum([torch.tensor([1e8]), torch.tensor([1.0]), torch.tensor([-1e8]),
                       torch.tensor([1.0])], "library")
    assert float(total) == float(np.float32(np.float32(np.float32(1e8) + 1) - 1e8) + 1)
    assert torch.equal(shards[0], torch.zeros(2))                   # inputs untouched


def test_submesh_keeps_slot_identity():
    mesh = make_mesh(devices=["cpu"] * 4)
    slots = list(mesh.slots.flat)
    left, right = submesh(slots[:2], "data"), submesh(slots[2:], "library")
    assert left.shape == {"data": 2} and right.shape == {"library": 2}
    assert {s.index for s in left.slots.flat} == {0, 1}
    assert right.axis_slots("library")[0] == Slot(2, torch.device("cpu"), 0)


def test_parallel_imports_no_jax(tmp_path):
    code = ("import sys; import lbaudiodetective_torch.parallel, "
            "lbaudiodetective_torch.parallel.pipeline, lbaudiodetective_torch.parallel.dedup, "
            "lbaudiodetective_torch.parallel.distributed, lbaudiodetective_torch.parallel.dryrun; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'lbaudiodetective_tpu'))]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(pathlib.Path(__file__).resolve().parents[1])] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
