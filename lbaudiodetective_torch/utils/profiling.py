"""The port's span recorder.

``stage(name, **attrs)`` marks a piece of the program's work: its name,
start and end (``time.perf_counter_ns``), thread, enclosing span on the
same thread (its parent), a request id (the root's own id unless a root
passes ``request=``; children inherit it) and ``attrs``, the counts of work
at that boundary, which the span may also ``set`` while it is open.

The recorder is off unless a ``recording()`` block is open: ``stage()``
then checks one module variable and returns :data:`NO_SPAN`, a shared
no-op that reads no clock and keeps nothing.  Inside ``recording()``
every thread's spans go into one bounded in-memory buffer (spans past its
capacity are counted in ``dropped``, not kept).

Spans opened on threads that ``torch.profiler`` does not see (the HTTP
server's handler threads) are placed on the profiler's clock all the same:
a ``recording()`` opened inside a ``torch.profiler.profile`` block brackets
named ``record_function`` anchors with ``perf_counter_ns`` reads as it opens
and as it closes, and :meth:`Recording.on_trace_clock` shifts every span
by the median offset the anchors show.

``trace_to(dir)`` profiles a block (host, and the card where CUDA is
available) with the recorder on, and writes one Chrome trace holding both
the profiler's events and the program's spans from every thread.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import statistics
import threading
import time

import torch

#: Name prefix of the ``record_function`` ranges that tie the recorder's
#: clock to the profiler's.
_ANCHOR = "profiling.anchor"
_ANCHORS_A_SIDE = 5


class _NoSpan:
    """What ``stage()`` and ``current()`` return while nothing records."""

    __slots__ = ()
    id = None
    request = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass

    def elapsed(self, key: str) -> None:
        pass


NO_SPAN = _NoSpan()


class Span:
    """One recorded piece of work; a context manager, opened by ``stage()``."""

    __slots__ = ("name", "id", "parent", "request", "thread", "start_ns", "end_ns", "attrs",
                 "_rec")

    def __init__(self, rec: "Recording", name: str, request, attrs: dict):
        self._rec = rec
        self.name = name
        self.id = next(rec._ids)
        self.request = request
        self.attrs = attrs
        self.parent = self.thread = self.start_ns = self.end_ns = None

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.request is None:
                self.request = top.request
        if self.request is None:
            self.request = self.id
        self.thread = threading.get_native_id()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end_ns = time.perf_counter_ns()
        _stack().pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._rec._keep(self)
        return False

    def set(self, **attrs) -> None:
        """Add or replace attributes while the span is open."""
        self.attrs.update(attrs)

    def elapsed(self, key: str) -> None:
        """Set attribute ``key`` to the ns since the span opened (a wait
        inside the span, such as acquiring a lock)."""
        self.attrs[key] = time.perf_counter_ns() - self.start_ns

    def as_dict(self, offset_ns: int = 0) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "request": self.request, "thread": self.thread,
                "start_ns": self.start_ns + offset_ns, "end_ns": self.end_ns + offset_ns,
                "attrs": dict(self.attrs)}


class Recording:
    """The spans of one ``recording()`` block: ``spans`` (closed spans, in
    the order they closed), ``dropped`` (spans past ``capacity``) and,
    once :meth:`on_trace_clock` has run, ``clock`` (the offset and its
    spread over the anchors)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.spans: list[Span] = []
        self.dropped = 0
        self.clock: dict | None = None
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._open = True
        self._token = f"{os.getpid()}.{id(self)}"
        self._anchors: list[tuple[str, int]] = []

    def _keep(self, span: Span) -> None:
        with self._lock:
            if not self._open:
                return
            if len(self.spans) < self.capacity:
                self.spans.append(span)
            else:
                self.dropped += 1

    def _anchor(self) -> None:
        """Named ``record_function`` ranges between ``perf_counter_ns``
        reads, where the calling thread is being profiled."""
        if not torch.autograd._profiler_enabled():
            return
        for _ in range(_ANCHORS_A_SIDE):
            name = f"{_ANCHOR}#{self._token}.{len(self._anchors)}"
            a = time.perf_counter_ns()
            with torch.profiler.record_function(name):
                pass
            b = time.perf_counter_ns()
            self._anchors.append((name, (a + b) // 2))

    def on_trace_clock(self, prof) -> list[dict]:
        """The spans as dicts (``name``, ``id``, ``parent``, ``request``,
        ``thread``, ``start_ns``, ``end_ns``, ``attrs``) with times on the
        clock of ``prof``, the finished ``torch.profiler.profile`` this
        recording ran inside.  Sets ``clock``: the median offset, the spread
        (largest less smallest) of the anchors' offsets, and their count."""
        mids = dict(self._anchors)
        offsets = []
        for e in prof.profiler.kineto_results.events():
            mid = mids.get(e.name())
            if mid is not None:
                offsets.append(e.start_ns() + e.duration_ns() // 2 - mid)
        if not offsets:
            raise ValueError("no clock anchors in the profile: open recording() inside "
                             "torch.profiler.profile, on the thread that profiles")
        offset = int(statistics.median(offsets))
        self.clock = {"offset_ns": offset, "spread_ns": max(offsets) - min(offsets),
                      "anchors": len(offsets)}
        return [s.as_dict(offset) for s in self.spans]


_recording: Recording | None = None
_local = threading.local()


def _stack() -> list[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def stage(name: str, request=None, **attrs):
    """A span around a block: ``with profiling.stage("extract.pad", clips=n)
    as sp: ...; sp.set(samples=...)``.  :data:`NO_SPAN` while nothing
    records."""
    rec = _recording
    if rec is None:
        return NO_SPAN
    return Span(rec, name, request, attrs)


def current():
    """The innermost open span on the calling thread (:data:`NO_SPAN` if
    none, or while nothing records)."""
    if _recording is None:
        return NO_SPAN
    stack = _stack()
    return stack[-1] if stack else NO_SPAN


@contextlib.contextmanager
def recording(capacity: int = 1 << 18):
    """Turn the recorder on for the block and yield its :class:`Recording`;
    its ``spans`` are complete when the block exits.  One recording at a
    time."""
    global _recording
    if _recording is not None:
        raise RuntimeError("the span recorder is already recording")
    rec = Recording(capacity)
    rec._anchor()
    _recording = rec
    try:
        yield rec
    finally:
        _recording = None
        with rec._lock:
            rec._open = False
        rec._anchor()


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Profile the block (host, and the card where CUDA is available) with
    the span recorder on, and write ``trace_<pid>_<n>.json`` into
    ``log_dir``: a Chrome trace of the profiler's events and the program's
    spans (category ``program_span``, each on its own thread's row, with
    its id, parent, request and attributes under ``args``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        with recording() as rec:
            yield prof
    spans = rec.on_trace_clock(prof)
    n = sum(1 for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_"))
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": s["name"], "pid": os.getpid(),
         "tid": s["thread"], "ts": (s["start_ns"] - base) / 1e3,
         "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
         "args": {"id": s["id"], "parent": s["parent"], "request": s["request"], **s["attrs"]}}
        for s in spans)
    with open(path, "w") as f:
        json.dump(trace, f)
