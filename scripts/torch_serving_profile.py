#!/usr/bin/env python3
"""Where a live-session post's time goes: the port's HTTP service
(``lbaudiodetective_torch/serving.py``) under concurrent clients, and the
device calls of a post without HTTP.

    python scripts/torch_serving_profile.py [cuda|cpu] [entries]

A library of ``entries`` random fingerprints (16,384 by default; 53
subfingerprints in rows of 56, 100 pairs) is made from a seed.  16
per-session and 64 pooled sessions each post 7 increments of 8
subfingerprints (a library entry's own rows), all sessions at once, one
HTTP connection a request, from clients in a separate process (this
script, ``--clients``), against:

- ``backlog5``: ``socketserver``'s listen backlog of 5;
- ``backlog128``: the port's ``IdentificationServer`` (backlog 128);
- ``backlog128_unserialised``: the same with the service's ``_lock``
  replaced by a no-op, so handler threads dispatch device work at once;
- ``backlog128_inprocess``: the port's server with the clients as threads
  of the server's process, as ``chip_smoke.py`` phase 9 runs them.

Then, in one thread without HTTP: a per-session matcher's
``update_bucketed`` + ``top_k(5)`` a post, and a 64-slot pool's ``flush`` +
``top_k(5)`` with every slot at one age and at 8 different ages.  Prints a
JSON line a measurement; times are host walls around calls that end in a
device-to-host copy (so they include the device's work), in ms.  A post
whose connection fails ends its session's run and is counted.
"""

from __future__ import annotations

import http.client
import json
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

N_SUB, S, PAIRS, POST, POSTS = 53, 56, 100, 8, 7
MODES = {"per_session": (16, False), "pooled": (64, True)}
#: variant: (listen backlog, service lock serialising, clients in another process)
VARIANTS = {"backlog5": (5, True, True), "backlog128": (128, True, True),
            "backlog128_unserialised": (128, False, True),
            "backlog128_inprocess": (128, True, False)}


def post(addr, path: str, body: bytes = b"") -> tuple[dict, float]:
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection(*addr, timeout=300)
    try:
        conn.request("POST", path, body=body)
        out = json.loads(conn.getresponse().read())
    finally:
        conn.close()
    return out, time.perf_counter() - t0


def run_clients(addr, sessions: list[tuple[str, str]]) -> dict:
    """Every (session, fingerprint string) posts its increments in order, all
    sessions at once; latencies in seconds, the wall, failed posts."""
    lat, failed = [], []

    def one(sid, text):
        subs = text.split("+")
        for k in range(POSTS):
            body = "+".join(subs[k * POST:(k + 1) * POST]).encode("ascii")
            try:
                lat.append(post(addr, f"/stream/{sid}", body)[1])
            except OSError:                    # a connection the backlog dropped
                failed.append(sid)
                return

    threads = [threading.Thread(target=one, args=s) for s in sessions]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"lat": lat, "wall": time.perf_counter() - t0, "failed": len(failed)}


class _NoLock:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def http_run(dev, lib, names, texts, variant: str, mode: str) -> dict:
    from lbaudiodetective_torch import serving

    backlog, serialised, other_process = VARIANTS[variant]
    n, pooled = MODES[mode]
    svc = serving.IdentificationService(lib, names, stream_pool=pooled, device=dev)
    if not serialised:
        svc._lock = _NoLock()
    serving.IdentificationServer.request_queue_size = backlog
    srv = serving.make_server(svc)
    serving.IdentificationServer.request_queue_size = VARIANTS["backlog128"][0]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        addr = srv.server_address
        sessions = [(post(addr, "/stream/open")[0]["session"], t) for t in texts[:n]]
        if other_process:
            with tempfile.NamedTemporaryFile("w", suffix=".json") as f:
                json.dump({"addr": list(addr), "sessions": sessions}, f)
                f.flush()
                proc = subprocess.run([sys.executable, __file__, "--clients", f.name],
                                      capture_output=True, text=True, check=True, timeout=600)
            res = json.loads(proc.stdout.strip().splitlines()[-1])
        else:
            res = run_clients(addr, sessions)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
    ms = np.array(res["lat"]) * 1e3
    return {"variant": variant, "mode": mode, "sessions": n, "posts": len(ms),
            "failed_posts": res["failed"], "p50_ms": float(np.percentile(ms, 50)),
            "p95_ms": float(np.percentile(ms, 95)), "max_ms": float(ms.max()),
            "posts_per_s": len(ms) / res["wall"]}


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def direct(dev, lib, fps) -> list[dict]:
    from lbaudiodetective_torch.streaming.incremental import (
        IncrementalLibraryMatcher, StreamSessionPool)

    out = []
    m = IncrementalLibraryMatcher(lib, batch=1, device=dev)
    fp = fps[0]
    ms = [timed(lambda k=k: (m.update_bucketed(fp.pos[None, k * POST:(k + 1) * POST],
                                               fp.neg[None, k * POST:(k + 1) * POST]),
                             m.top_k(5)))
          for k in range(POSTS)]
    out.append({"call": "per_session update_bucketed + top_k", "ms": ms})
    for ages in ("one age", "8 ages"):
        pool = StreamSessionPool(lib, slots=64, device=dev)
        for g in range(64):
            pool.open(str(g))
        if ages == "8 ages":               # slot g starts g % 8 subfingerprints in
            for g in range(64):
                pool.post(str(g), fps[g].pos[:g % 8], fps[g].neg[:g % 8])
            pool.flush()
        ms = []
        for _ in range(POSTS - 1):
            for g in range(64):
                a = pool.age(str(g))
                pool.post(str(g), fps[g].pos[a:a + POST], fps[g].neg[a:a + POST])
            ms.append(timed(lambda: (pool.flush(), pool.top_k(5))))
        out.append({"call": f"pool of 64 flush + top_k, {ages}", "ms": ms})
    return out


def main() -> int:
    import torch

    from lbaudiodetective_torch.models.fingerprint import Fingerprint
    from lbaudiodetective_torch.models.library import FingerprintLibrary
    from lbaudiodetective_torch.utils import packing

    dev = torch.device(sys.argv[1] if len(sys.argv) > 1 else "cuda")
    entries = int(sys.argv[2]) if len(sys.argv) > 2 else 16384
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    kind = "cpu"
    if dev.type == "cuda":
        kind = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    cls = rng.integers(0, 3, (entries, S, PAIRS), dtype=np.uint8)
    cls[:, N_SUB:] = 0
    planes = [(cls == c).astype(np.uint8) for c in (1, 2)]
    lib = FingerprintLibrary.from_arrays(*(packing.pack_bits(p) for p in planes),
                                         np.full(entries, N_SUB, np.int32), PAIRS, device=dev)
    fps = [Fingerprint(planes[0][i, :N_SUB], planes[1][i, :N_SUB]) for i in range(64)]
    for rec in direct(dev, lib, fps):          # also warms the device paths
        print(json.dumps({"device": kind, **rec, "median_ms": float(np.median(rec["ms"]))}),
              flush=True)
    names = [f"track_{i}" for i in range(entries)]
    texts = [f.to_string() for f in fps]
    for variant in VARIANTS:
        for mode in MODES:
            print(json.dumps({"device": kind, **http_run(dev, lib, names, texts, variant,
                                                          mode)}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--clients"]:
        spec = json.loads(pathlib.Path(sys.argv[2]).read_text())
        print(json.dumps(run_clients(tuple(spec["addr"]), [tuple(s) for s in spec["sessions"]])))
        sys.exit(0)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    sys.exit(main())
