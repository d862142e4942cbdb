"""The port's multi-process layer (``lbaudiodetective_torch/parallel/
distributed.py`` and the mesh's collectives across processes) on the CPU:
``initialize`` is a no-op in one process and otherwise joins through
``torch.distributed.init_process_group`` with the caller's backend (gloo
for CPU slots by default), ``shard_bounds`` equals the JAX package's, a
process re-joins and reloads its shard with equal scores, and two real gloo
processes each load their own shards and run the library-sharded match,
ring all-pairs, ring dedup and the time-sharded long match across the
process boundary, equal to one process (bit for bit; the long match within
1e-5, its psum adds in another order)."""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_tpu.parallel import distributed as jax_distributed  # noqa: E402
from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.models.fingerprint import Fingerprint  # noqa: E402
from lbaudiodetective_torch.models.library import FingerprintLibrary  # noqa: E402
from lbaudiodetective_torch.parallel import distributed  # noqa: E402
from lbaudiodetective_torch.parallel.long_match import match_long_time_sharded  # noqa: E402
from lbaudiodetective_torch.parallel.mesh import make_mesh, unshard  # noqa: E402
from lbaudiodetective_torch.parallel.sharded_packed import (  # noqa: E402
    ring_all_pairs_scores_packed, ring_dedup_topk_packed)
from lbaudiodetective_torch.utils.serialize import (  # noqa: E402
    load_library, save_library, save_library_sharded)


@pytest.fixture
def joins(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    return calls


def test_initialize_single_process_is_noop(joins):
    distributed.initialize()
    assert joins == []


@pytest.mark.parametrize("backend, device, expected", [(None, "cpu", "gloo"),
                                                       ("nccl", "cpu", "nccl"),
                                                       ("gloo", "cuda", "gloo")])
def test_initialize_joins_with_the_callers_backend(joins, backend, device, expected):
    distributed.initialize("coord:1234", num_processes=4, process_id=2, backend=backend,
                           device=device)
    assert joins == [((expected,), {"init_method": "tcp://coord:1234", "world_size": 4,
                                    "rank": 2})]


@pytest.mark.parametrize("total, n", [(103, 8), (3, 8), (16, 4), (1, 1), (0, 3)])
def test_shard_bounds_equal_jax(total, n):
    seen = []
    for pid in range(n):
        got = distributed.shard_bounds(total, pid, n)
        assert got == jax_distributed.shard_bounds(total, pid, n)
        seen.extend(range(*got))
    assert seen == list(range(total))


def _fps(seed, n, rows):
    rng = np.random.default_rng(seed)
    cfg = FingerprintConfig()
    out = []
    for _ in range(n):
        cls = rng.choice(3, size=(rows, cfg.num_wavelet_pairs))
        out.append(Fingerprint.from_planes((cls == 1).astype(np.uint8),
                                           (cls == 2).astype(np.uint8)))
    return out


def test_rejoin_reloads_shard_and_scores_match(tmp_path, joins):
    cfg = FingerprintConfig()
    fps = _fps(77, 12, 16)
    lo, hi = distributed.shard_bounds(len(fps), process_id=1, num_processes=3)
    shard_file = str(tmp_path / "shard1.npz")
    save_library(shard_file, fps[lo:hi], cfg)
    query = fps[lo + 1]

    def scores():
        pos_w, neg_w, counts, pairs = load_library(shard_file, cfg)
        return FingerprintLibrary.from_arrays(pos_w, neg_w, counts, pairs, cfg,
                                              device="cpu").match(query)

    before = scores()
    distributed.initialize("coord:1234", num_processes=3, process_id=1, device="cpu")
    after = scores()
    np.testing.assert_array_equal(before, after)
    assert after[1] == pytest.approx(1.0) and len(joins) == 1


def test_two_process_gloo_ring_and_match(tmp_path):
    cfg = FingerprintConfig()
    fps = _fps(123, 14, 12)
    libdir = str(tmp_path / "libdb")
    save_library_sharded(libdir, fps, cfg, n_shards=4)              # 4 x 4, 2 padded
    rng = np.random.default_rng(5)
    long_pos = (rng.random((203, cfg.num_wavelet_pairs)) < 0.4).astype(np.uint8)
    long_neg = ((rng.random(long_pos.shape) < 0.4) & (long_pos == 0)).astype(np.uint8)
    q_pos_w, q_neg_w = fps[5].packed()
    query_npz = str(tmp_path / "query.npz")
    np.savez(query_npz, pos_w=q_pos_w, neg_w=q_neg_w, n=fps[5].num_subfingerprints,
             long_pos=long_pos, long_neg=long_neg, long_n1=203)

    with socket.socket() as s:                                      # a free port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([repo] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs, outs, logs = [], [], []
    try:
        for pid in range(2):
            outs.append(str(tmp_path / f"out{pid}.npz"))
            procs.append(subprocess.Popen(
                [sys.executable, str(pathlib.Path(__file__).parent / "_torch_dist_worker.py"),
                 str(port), str(pid), "2", libdir, query_npz, outs[-1]],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for p in procs:
            try:
                logs.append(p.communicate(timeout=240)[0])
            except subprocess.TimeoutExpired:
                logs.append("<worker timed out after 240 s>")
    finally:
        for p in procs:                       # no orphans if the rendezvous hangs
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"

    # One process, one slot a shard, on the same padded library.
    lib = FingerprintLibrary.from_fingerprints(fps, cfg, device="cpu")
    pad = lambda x: torch.cat([x, x.new_zeros((2, *x.shape[1:]))])   # noqa: E731
    words = [pad(lib.pos_words[:, :12]), pad(lib.neg_words[:, :12])]
    counts = pad(lib.counts)
    mesh = make_mesh(devices=["cpu"] * 4, library_parallelism=4)
    ref_scores = np.zeros(16, np.float32)
    ref_scores[:14] = lib.match(fps[5])
    ref_ring = unshard(ring_all_pairs_scores_packed(*words, counts, lib.pairs, mesh)).numpy()
    ref_dd = [unshard(x).numpy() for x in ring_dedup_topk_packed(*words, counts, lib.pairs,
                                                                  mesh, k=3)]
    ref_long = match_long_time_sharded(long_pos, long_neg, 203, long_pos[5:29],
                                       long_neg[5:29], 24, mesh, axis="library")
    seen = []
    for out in outs:
        z = np.load(out)
        for k, slot in enumerate(z["slots"]):
            rows = slice(4 * slot, 4 * slot + 4)
            np.testing.assert_array_equal(z["scores"][k], ref_scores[rows])
            np.testing.assert_array_equal(z["ring"][k], ref_ring[rows])
            np.testing.assert_array_equal(z["dd_scores"][k], ref_dd[0][rows])
            np.testing.assert_array_equal(z["dd_idx"][k], ref_dd[1][rows])
            seen.append(int(slot))
        assert abs(float(z["long"]) - ref_long) < 1e-5 and ref_long > 0.99
    assert sorted(seen) == [0, 1, 2, 3]
    assert ref_scores[5] == pytest.approx(1.0)
