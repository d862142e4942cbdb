"""The benchmark's generic part: find a cell's configuration, traffic,
driver and per-layer readers by name, time set-up and the window, trace the
window in a traced run, check what the window produced against the plain
reference, and print the result line.

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric is a file of its own, found by its name in
``BENCHMARK.json``:

- ``portbench/configs/<config>.json``: the deployment (geometry, library,
  service settings, guarantees);
- ``portbench/traffic/<traffic>.json``: the driver that serves the mix, its
  parameters and the limits of its checks;
- ``portbench/drivers/<driver>.py``: a ``Driver(run)`` with ``setup()``,
  ``window(seconds)``, ``wrap(tracer)``, ``end_to_end()``, ``counts()``,
  ``counters()``, ``release()`` and ``check()``, and ``control()``, which
  puts the reference a precision step down in the place of the timed
  calls and returns what puts the program back (``portbench/control.py``);
- ``portbench/metrics/<metric>.py``: ``read(trace)``, the metric's value
  from a traced window, or None where the window holds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import itertools
import json
import pathlib
import sys
import time

#: Top-level module names no run may hold once its window has closed: the
#: JAX package the port was made from, and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "lbaudiodetective_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names of ``modules`` (default ``sys.modules``) that are in
    :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({k.split(".", 1)[0] for k in names} & set(FORBIDDEN))


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """A module from its file (names may hold dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: pathlib.Path

    @classmethod
    def find(cls, name: str, root: pathlib.Path) -> "Cell":
        bench = load_json(root / "BENCHMARK.json")
        matches = [w for w in bench["workloads"] if w["name"] == name]
        if not matches:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = matches[0]
        pb = root / "portbench"

        def mine(m):
            return name in m.get("workloads", [name])

        return cls(name, w, load_json(pb / "configs" / f"{w['config']}.json"),
                   load_json(pb / "traffic" / f"{w['traffic']}.json"),
                   [m for m in bench["end_to_end"] if mine(m)],
                   [m for m in bench["per_layer"] if mine(m)], root)

    def driver_path(self) -> pathlib.Path:
        return self.root / "portbench" / "drivers" / f"{self.traffic['driver']}.py"

    def metric_path(self, name: str) -> pathlib.Path:
        return self.root / "portbench" / "metrics" / f"{name}.py"


@dataclasses.dataclass
class Run:
    """What a driver is given: the cell, the seed, the device, and where a
    run may write (``work_dir``, inside the checkout)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    work_dir: pathlib.Path

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def geom(self):
        from portbench.reference.geometry import Geometry

        return Geometry.from_config(self.cell.config)


class Tracer:
    """Spans around the public calls of the program that a traced run wraps:
    each call a ``record_function`` named ``pb:<call>#<i>`` in the profiler's
    trace, and its host wall and ``info`` kept here."""

    def __init__(self):
        self.spans: dict[str, list[dict]] = {}
        self._ids = itertools.count()
        self._undo: list = []

    def wrap(self, owner, attr: str, info=None) -> None:
        import torch

        orig = getattr(owner, attr)
        spans = self.spans.setdefault(attr, [])
        ids = self._ids

        def wrapper(*args, **kwargs):
            i = next(ids)
            with torch.profiler.record_function(f"pb:{attr}#{i}"):
                t0 = time.perf_counter()
                out = orig(*args, **kwargs)
                t1 = time.perf_counter()
            spans.append({"id": i, "t0": t0, "t1": t1,
                          "info": info(args, kwargs, out) if info else None})
            return out

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, orig))

    def unwrap(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


def _union_ns(intervals: list[tuple[int, int]]) -> int:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


@dataclasses.dataclass
class Trace:
    """A traced window, as the per-layer readers see it.  Times in ns on the
    profiler's clock."""

    window: tuple[int, int]
    device: list[tuple[str, int, int]]         # kernels, copies, sets
    spans: dict[str, list[dict]]               # the Tracer's, with start/end ns
    counters: dict
    cell: Cell
    sms: int
    sm_max_mhz: float

    @property
    def geom(self):
        from portbench.reference.geometry import Geometry

        return Geometry.from_config(self.cell.config)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_ns(self, start: int | None = None, end: int | None = None,
                key: str = "") -> int:
        """Device time in ``[start, end)`` in which some event whose name
        holds ``key`` ran (all events by default), overlaps counted once."""
        a = self.window[0] if start is None else start
        b = self.window[1] if end is None else end
        return _union_ns([(max(s, a), min(e, b)) for n, s, e in self.device
                          if key in n and e > a and s < b])

    def device_ns(self, key: str) -> int:
        """Summed duration of the events whose name holds ``key``."""
        return sum(e - s for n, s, e in self.device if key in n)

    def calls(self, call: str) -> list[dict]:
        """Every wrapped ``call`` in call order: ``id``, host walls ``t0`` and
        ``t1`` (s), ``info``; ``start_ns``/``end_ns`` where the profiler
        recorded its span (it records the threads it runs on, not the
        server's handler threads)."""
        return sorted(self.spans.get(call, []), key=lambda sp: sp["id"])

    def walls_ns(self, call: str) -> list[tuple[int, int, dict]]:
        """(start, end, info) of each wrapped ``call`` on the profiler's
        clock, in call order."""
        return [(sp["start_ns"], sp["end_ns"], sp["info"])
                for sp in sorted(self.spans.get(call, []), key=lambda sp: sp["id"])
                if "start_ns" in sp]


def idle_pct(trace: Trace) -> float | None:
    """Share of the traced window in which no kernel, copy or set ran on
    the card (the reader of every cell's ``device_idle_pct``)."""
    if trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_ns() / 1e9 / trace.window_s)


def device_events(prof) -> tuple[list, dict[int, tuple[int, int]], tuple[int, int] | None]:
    """(device events, ``pb:`` span id -> (start, end) ns, window) of a
    profile."""
    import torch

    device, spans, window = [], {}, None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # The device side of a host annotation spans other events; only
            # kernels, copies and sets count as device work.
            if not (name.startswith("pb:") or e.is_user_annotation()):
                device.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name == "pb:window":
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif name.startswith("pb:") and "#" in name:
            spans[int(name.rsplit("#", 1)[1])] = (e.start_ns(), e.start_ns() + e.duration_ns())
    return device, spans, window


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the harness span the host was inside (or "between calls")."""
    by_name: dict[str, int] = {}
    for n, s, e in trace.device:
        by_name[n] = by_name.get(n, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    events = sorted((s, e) for _, s, e in trace.device)
    gaps, end = [], trace.window[0]
    for s, e in events + [(trace.window[1], trace.window[1])]:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    spans = [(name, sp["start_ns"], sp["end_ns"]) for name, lst in trace.spans.items()
             for sp in lst if "start_ns" in sp]

    def host_at(t: int) -> str:
        inside = [(e - s, name) for name, s, e in spans if s <= t < e]
        return min(inside)[1] if inside else "between calls"

    return {"device_ops": [[n[:120], ns / 1e9] for n, ns in ops],
            "idle_gaps": [[host_at((a + b) // 2), (b - a) / 1e9] for a, b in gaps]}
