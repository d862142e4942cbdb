"""Worker of the two-process gloo test of the port's mesh
(tests/test_torch_distributed.py::test_two_process_gloo_ring_and_match).

Each process joins the group through ``parallel.distributed.initialize``
(gloo, CPU), owns two of the four library slots of a ``(1, 4)`` mesh,
loads only its own shards of the sharded checkpoint, and runs across the
process boundary: the library-sharded match, ring all-pairs, ring dedup
(``Mesh.ring_shift`` through ``batch_isend_irecv``) and the time-sharded
long match (``Mesh.psum`` through ``all_reduce``).  It writes its own
slots' results for the test to assemble and check.

Usage: _torch_dist_worker.py <port> <pid> <nprocs> <libdir> <query.npz> <out.npz>
"""

import sys

import numpy as np


def main():
    port, pid, nprocs, libdir, query_npz, out_npz = sys.argv[1:7]
    pid, nprocs = int(pid), int(nprocs)

    import torch

    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch.parallel import distributed
    from lbaudiodetective_torch.parallel.long_match import match_long_time_sharded
    from lbaudiodetective_torch.parallel.mesh import make_mesh
    from lbaudiodetective_torch.parallel.sharded_packed import (
        match_library_sharded_packed, ring_all_pairs_scores_packed, ring_dedup_topk_packed)
    from lbaudiodetective_torch.utils.serialize import load_library_shard

    distributed.initialize(f"127.0.0.1:{port}", nprocs, pid, device="cpu")
    assert torch.distributed.get_backend() == "gloo"
    cfg = FingerprintConfig()
    mesh = make_mesh(devices=["cpu"] * 4, library_parallelism=4)
    slots = mesh.axis_slots("library")
    assert [s.rank for s in slots] == [0, 0, 1, 1]

    words, counts = ([None] * 4, [None] * 4), [None] * 4
    man = None
    for i, slot in enumerate(slots):
        if slot.rank == pid:                  # only this process's shards
            pos_w, neg_w, cnt, man = load_library_shard(libdir, i, cfg)
            words[0][i] = torch.from_numpy(np.asarray(pos_w).view(np.int32))
            words[1][i] = torch.from_numpy(np.asarray(neg_w).view(np.int32))
            counts[i] = torch.from_numpy(np.asarray(cnt))
    pairs = man["pairs"]

    q = np.load(query_npz)
    scores = match_library_sharded_packed(
        torch.from_numpy(q["pos_w"].view(np.int32)), torch.from_numpy(q["neg_w"].view(np.int32)),
        int(q["n"]), *words, counts, pairs, mesh)
    ring = ring_all_pairs_scores_packed(*words, counts, pairs, mesh)
    dd_scores, dd_idx = ring_dedup_topk_packed(*words, counts, pairs, mesh, k=3)
    long_score = match_long_time_sharded(q["long_pos"], q["long_neg"], int(q["long_n1"]),
                                         q["long_pos"][5:29], q["long_neg"][5:29], 24, mesh,
                                         axis="library")
    mine = [i for i, s in enumerate(slots) if s.rank == pid]
    assert all(scores[i] is None for i in range(4) if i not in mine)
    np.savez(out_npz, slots=np.asarray(mine),
             scores=np.stack([scores[i].numpy() for i in mine]),
             ring=np.stack([ring[i].numpy() for i in mine]),
             dd_scores=np.stack([dd_scores[i].numpy() for i in mine]),
             dd_idx=np.stack([dd_idx[i].numpy() for i in mine]), long=np.float64(long_score))
    torch.distributed.destroy_process_group()
    print(f"pid{pid} OK slots {mine}", flush=True)


if __name__ == "__main__":
    main()
