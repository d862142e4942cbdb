"""Tracing and profiling hooks (port of the JAX package's
``utils/profiling.py``).

- ``stage(name)``: a context manager that adds a host wall-clock span and
  opens a ``torch.profiler.record_function`` range (and, on a CUDA build
  with a card, an NVTX range), so device traces group by pipeline stage
  (decode / extract / match / stream).
- ``trace_to(dir)``: run a ``torch.profiler.profile`` around a block (the
  card's activity too where CUDA is available) and write its Chrome trace
  into ``dir``.
- ``StageTimers``: per-stage wall times and call counts, the structured
  metrics that replace the reference's NSLog result dictionaries
  (LBAudioDetectiveTests.m:90).
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch


@contextlib.contextmanager
def _nvtx_range(name: str):
    if not torch.cuda.is_available():
        yield
        return
    torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


class StageTimers:
    def __init__(self):
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        with torch.profiler.record_function(name), _nvtx_range(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def report(self) -> dict:
        return {name: {"seconds": self.totals[name], "calls": self.counts[name]}
                for name in sorted(self.totals)}


_GLOBAL = StageTimers()


def stage(name: str):
    """Module-level convenience: ``with profiling.stage("extract"): ...``"""
    return _GLOBAL.stage(name)


def report() -> dict:
    return _GLOBAL.report()


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Profile the block (host, and the card where CUDA is available) and
    write ``trace_<pid>_<n>.json``, a Chrome trace, into ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    n = sum(1 for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_"))
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))
