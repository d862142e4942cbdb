#!/usr/bin/env python3
"""Whether the port's ``PipelinedIdentifier`` overlaps its batches on the
card (``lbaudiodetective_torch/parallel/pipeline.py``).

    python scripts/torch_pipeline_profile.py [--profile]

A 16,384-entry library of random fingerprints (53 subfingerprints in rows
of 56, 100 pairs) and 256 ten-second clips of brown noise are made from a
seed.  Three times: four ``submit`` calls of 64 clips (each call's host
wall), ``drain``, and the same four batches extracted and matched one after
another with a ``.cpu()`` of each batch's scores (the serial loop).  Then
the host wall of each part of a submit, and how long the host then waits
for the device (``synchronize``): a part that makes the host wait for the
device's queue shows as a long host wall and a short wait.  With
``--profile``, ``torch.profiler``'s host-side rows of one pipelined run
(``cudaStreamSynchronize`` counts the host's waits).  Times in ms, host
walls (one card on a shared host: they spread).
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.device import to_device  # noqa: E402
from lbaudiodetective_torch.parallel.pipeline import (  # noqa: E402
    PipelinedIdentifier, _padded_batch)


def main() -> None:
    dev = torch.device("cuda")
    cfg = FingerprintConfig()
    rng = np.random.default_rng(0)
    lib_pos = (rng.random((16384, 56, 100)) < 0.4).astype(np.uint8)
    lib_neg = ((rng.random(lib_pos.shape) < 0.4) & (lib_pos == 0)).astype(np.uint8)
    counts = np.full(16384, 53, np.int32)
    noise = rng.standard_normal((256, 55120)).astype(np.float32) * 0.1
    audio = (np.cumsum(noise, axis=1) * 0.05).astype(np.float32)
    batches = [(audio[i:i + 64], np.full(64, 53, np.int64)) for i in range(0, 256, 64)]
    pipe = PipelinedIdentifier(lib_pos, lib_neg, counts, cfg, device=dev)
    for rep in range(3):
        list(pipe.run(batches))                                 # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        submits = []
        for b in batches:
            t1 = time.perf_counter()
            pipe.submit(*b)
            submits.append((time.perf_counter() - t1) * 1e3)
        pipe.drain()
        total = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for b in batches:
            pipe._match(*pipe._extract(*b), b[1]).cpu()
        serial = (time.perf_counter() - t0) * 1e3
        print(f"rep {rep}: submits {[round(x, 1) for x in submits]} ms, pipelined total "
              f"{total:.1f} ms, serial loop {serial:.1f} ms", flush=True)
    b = batches[0]
    for name, fn in (("pad", lambda: _padded_batch(cfg, *b)),
                     ("pad + H2D", lambda: to_device(_padded_batch(cfg, *b)[0], dev)),
                     ("extract", lambda: pipe._extract(*b)),
                     ("extract + match", lambda: pipe._match(*pipe._extract(*b), b[1]))):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        print(f"{name}: host {(t1 - t0) * 1e3:.2f} ms, then waiting for the device "
              f"{(time.perf_counter() - t1) * 1e3:.2f} ms", flush=True)
    if "--profile" in sys.argv:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            list(pipe.run(batches))
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=12))
    print(subprocess_smi())


def subprocess_smi() -> str:
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


if __name__ == "__main__":
    main()
