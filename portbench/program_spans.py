#!/usr/bin/env python3
"""The program's own spans in a cell's run: a cell run as ``portbench/run.py``
runs it, with the port's span recorder (``lbaudiodetective_torch.utils.
profiling.recording()``) on around the window, and the per-layer metrics
that read those spans.

    python3 portbench/program_spans.py --workload <cell> --seed <n> --seconds <s> --trace <0|1> [--record 0|1]

The result line is ``run.py``'s.  With ``--trace 1`` the spans are mapped
to the profiler's clock and handed to the readers as ``trace.program_spans``
(``trace.program_dropped`` counts the spans the recorder's buffer had no
room for); the metrics of ``program_metrics.json`` (entries in the form of
``BENCHMARK.json``'s ``per_layer``) join the cell's, the breakdown names
idle gaps by the program's spans (:func:`breakdown`), and the spans, the
clock's offset and the slowest posts' breakdown (:func:`slow_posts`) go to
``program_spans.json`` in the run's work directory.  With ``--trace 0
--record 1`` the end-to-end metrics are those of a run with the recorder on
(``--record 0`` is ``run.py`` itself).

``run.py``, ``harness.Trace`` and ``harness.breakdown`` take the recorder
in as this module's :func:`main` does once the benchmark carries these
metrics; until then this module puts them in place for its own run and
takes them out again.
"""

from __future__ import annotations

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, run  # noqa: E402

_HARNESS_BREAKDOWN = harness.breakdown

#: The parts of a post's time in :func:`slow_posts`, in the order a post
#: meets them.
PARTS = ("parse", "enqueue_wait", "window_lock_wait", "window", "dispatch_wait", "flush",
         "top_k", "respond")


@dataclasses.dataclass
class ProgramTrace(harness.Trace):
    """A traced window with the program's spans (dicts as
    ``Recording.on_trace_clock`` gives them, on the profiler's clock)."""

    program_spans: list[dict] = dataclasses.field(default_factory=list)
    program_dropped: int = 0


def spans_of(trace) -> list[dict] | None:
    """The program's spans of a traced window, or None where the run
    recorded none or the recorder dropped any."""
    spans = getattr(trace, "program_spans", None)
    if not spans or getattr(trace, "program_dropped", 0):
        return None
    return spans


def named(spans: list[dict], name: str, **attrs) -> list[dict]:
    """The spans called ``name`` whose attributes hold ``attrs``."""
    return [s for s in spans if s["name"] == name
            and all(s["attrs"].get(k) == v for k, v in attrs.items())]


def wall_ns(span: dict) -> int:
    return span["end_ns"] - span["start_ns"]


def posts(spans: list[dict]) -> list[dict]:
    """The ``serve.request`` roots of live-session posts."""
    return named(spans, "serve.request", method="POST", route="/stream/<id>")


def post_flushes(spans: list[dict]) -> list[tuple[dict, dict | None]]:
    """Each post-caused ``pool.flush`` with the ``pool.top_k`` that ranked
    after it (the next one under the same parent), or None."""
    tops: dict = {}
    for t in named(spans, "pool.top_k", cause="post"):
        tops.setdefault((t["thread"], t["parent"]), []).append(t)
    out = []
    for f in named(spans, "pool.flush", cause="post"):
        after = [t for t in tops.get((f["thread"], f["parent"]), [])
                 if t["start_ns"] >= f["end_ns"]]
        out.append((f, min(after, key=lambda t: t["start_ns"]) if after else None))
    return out


def p95(values: list[float]) -> float:
    """95th percentile, the highest-ranked value at or above it (as
    ``np.percentile(..., method="higher")``)."""
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, -(-95 * (len(ordered) - 1) // 100))]


def overlap_ns(s: int, e: int, a: int, b: int) -> int:
    """Length of ``[s, e)`` within ``[a, b)``."""
    return max(0, min(e, b) - max(s, a))


def slow_posts(spans: list[dict], share: float = 0.05) -> dict | None:
    """Where the slowest ``share`` of posts (by ``serve.request`` wall)
    spent their time, mean ms a post: ``serve.parse``; the wait for
    ``_pcond`` in ``pool.enqueue``; then, of the flush that answered the
    post and after the post was queued, the leader's ``pool.window`` (split
    into the window itself, up to its ``timeout_ns``, and
    ``window_lock_wait``, the waits to take ``_pcond`` before it and to take
    it back after) and ``pool.dispatch_wait``, the ``pool.flush`` and
    ``pool.top_k``; ``serve.respond``; the rest as ``other``.
    ``lock_behind_ms`` is the part of the waits for ``_pcond`` that other
    threads' ``pool.flush`` and ``pool.top_k`` spans (which run holding it)
    overlapped, by span and ``cause``."""
    by_id = {s["id"]: s for s in spans}
    kids: dict = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    done = [p for p in posts(spans) if p["attrs"].get("flush") in by_id]
    if not done:
        return None
    done.sort(key=wall_ns, reverse=True)
    slow = done[:max(1, round(share * len(done)))]
    pairs = dict((f["id"], t) for f, t in post_flushes(spans))
    holders = [s for s in spans if s["name"] in ("pool.flush", "pool.top_k")]
    parts = {k: 0 for k in PARTS + ("other",)}
    behind: dict[str, int] = {}
    for p in slow:
        own = {k["name"]: k for k in kids.get(p["id"], [])}
        flush = by_id[p["attrs"]["flush"]]
        leader = {k["name"]: k for k in kids.get(flush["parent"], [])}
        enq = own.get("pool.enqueue")
        queued = enq["end_ns"] if enq else p["start_ns"]
        waits = []                          # (start, end, thread) of the waits for _pcond
        if enq:
            waits.append((enq["start_ns"], enq["start_ns"] + enq["attrs"].get("waited_ns", 0),
                          p["thread"]))
        win = leader.get("pool.window")
        if win:
            opened = win["start_ns"] + win["attrs"].get("waited_ns", 0)
            shut = min(win["end_ns"], opened + win["attrs"].get("timeout_ns", win["end_ns"]))
            for a, b in ((win["start_ns"], opened), (shut, win["end_ns"])):
                waits.append((max(a, queued), min(b, flush["start_ns"]), win["thread"]))
        disp = leader.get("pool.dispatch_wait")
        got = {"parse": wall_ns(own["serve.parse"]) if "serve.parse" in own else 0,
               "enqueue_wait": enq["attrs"].get("waited_ns", 0) if enq else 0,
               "window_lock_wait": overlap_ns(win["start_ns"], opened, queued, flush["start_ns"])
               + overlap_ns(shut, win["end_ns"], queued, flush["start_ns"]) if win else 0,
               "window": overlap_ns(opened, shut, queued, flush["start_ns"]) if win else 0,
               "dispatch_wait": overlap_ns(disp["start_ns"], disp["end_ns"], queued,
                                           flush["start_ns"]) if disp else 0,
               "flush": wall_ns(flush),
               "top_k": wall_ns(pairs[flush["id"]]) if pairs.get(flush["id"]) else 0,
               "respond": wall_ns(own["serve.respond"]) if "serve.respond" in own else 0}
        for k, v in got.items():
            parts[k] += v
        parts["other"] += wall_ns(p) - sum(got.values())
        for a, b, thread in waits:
            for h in holders:
                if h["thread"] != thread and b > a:
                    key = f'{h["name"]}:{h["attrs"].get("cause")}'
                    behind[key] = behind.get(key, 0) + overlap_ns(h["start_ns"], h["end_ns"], a, b)
    n = len(slow)
    return {"posts": len(done), "slow": n,
            "wall_ms": statistics.mean(wall_ns(p) for p in slow) / 1e6,
            "parts_ms": {k: v / n / 1e6 for k, v in parts.items()},
            "lock_behind_ms": {k: v / n / 1e6 for k, v in sorted(behind.items()) if v}}


def breakdown(trace, top: int = 10) -> dict:
    """``harness.breakdown``, with each idle gap named as :func:`idle_gaps`
    names it."""
    out = _HARNESS_BREAKDOWN(trace, top)
    out["idle_gaps"] = [[name, (b - a) / 1e9] for a, b, name in idle_gaps(trace, top)]
    return out


def idle_gaps(trace, top: int = 10) -> list[tuple[int, int, str]]:
    """The ``top`` longest stretches of the window without device work, as
    (start, end, name): the narrowest program span open at the midpoint on
    any thread, joined to the harness span open there
    (``process_decoded_batch > extract.pad``); "between calls" where neither
    is open."""
    events = sorted((s, e) for _, s, e in trace.device)
    gaps, end = [], trace.window[0]
    for s, e in events + [(trace.window[1], trace.window[1])]:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    calls = [(name, sp["start_ns"], sp["end_ns"]) for name, lst in trace.spans.items()
             for sp in lst if "start_ns" in sp]
    program = [(s["name"], s["start_ns"], s["end_ns"])
               for s in getattr(trace, "program_spans", None) or []]

    def narrowest(spans, t):
        inside = [(e - s, name) for name, s, e in spans if s <= t < e]
        return min(inside)[1] if inside else None

    def host_at(t: int) -> str:
        names = [n for n in (narrowest(calls, t), narrowest(program, t)) if n]
        return " > ".join(names) if names else "between calls"

    return [(a, b, host_at((a + b) // 2)) for a, b in gaps]


def main(argv=None, root: pathlib.Path = ROOT, device=None, start: float | None = None) -> int:
    """Run a cell through ``run.main`` with the recorder on around the
    window (``--record 1``, the default) and, with ``--trace 1``, the
    program's spans read as above; returns the exit code."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--record", type=int, choices=(0, 1), default=1)
    args, rest = p.parse_known_args(argv)
    start = _START if start is None else start
    if not args.record:
        return run.main(rest, root=root, device=device, start=start)
    from lbaudiodetective_torch.utils import profiling

    metrics = harness.load_json(pathlib.Path(__file__).with_name("program_metrics.json"))
    held: dict = {}
    saved = {"load_module": harness.load_module, "device_events": harness.device_events,
             "Trace": harness.Trace, "breakdown": harness.breakdown}
    find, find_attr = harness.Cell.find, harness.Cell.__dict__["find"]

    def load_module(path: pathlib.Path):
        module = saved["load_module"](path)
        if path.parent.name == "drivers":
            window = module.Driver.window

            def recorded(driver, seconds):
                with profiling.recording() as rec:
                    window(driver, seconds)
                held["rec"] = rec
                held["work_dir"] = driver.run.work_dir

            module.Driver.window = recorded
        return module

    def device_events(prof):
        out = saved["device_events"](prof)
        rec = held["rec"]
        held["spans"] = rec.on_trace_clock(prof)
        return out

    def trace(*fields):
        held["trace"] = ProgramTrace(*fields, program_spans=held["spans"],
                                     program_dropped=held["rec"].dropped)
        return held["trace"]

    def find_cell(name: str, root: pathlib.Path):
        cell = find(name, root)
        cell.per_layer = cell.per_layer + [m for m in metrics if name in m["workloads"]]
        return cell

    harness.load_module, harness.device_events = load_module, device_events
    harness.Trace, harness.breakdown, harness.Cell.find = trace, breakdown, find_cell
    try:
        rc = run.main(rest, root=root, device=device, start=start)
    finally:
        for name, value in saved.items():
            setattr(harness, name, value)
        harness.Cell.find = find_attr
    if "trace" in held:
        t, rec = held["trace"], held["rec"]
        post = slow_posts(t.program_spans) if t.program_spans else None
        gaps = [[name, (a - t.window[0]) / 1e9, (b - a) / 1e9] for a, b, name in idle_gaps(t)]
        (held["work_dir"] / "program_spans.json").write_text(json.dumps(
            {"clock": rec.clock, "dropped": rec.dropped, "window": list(t.window),
             "slow_posts": post, "idle_gaps": gaps, "spans": t.program_spans}))
        print(f"portbench: program spans {len(t.program_spans)}, dropped {rec.dropped}, "
              f"clock {json.dumps(rec.clock)}; idle gaps (name, s into the window, s) "
              f"{json.dumps(gaps)}; slowest posts {json.dumps(post)}", file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    # Run the module's single instance: the readers import it by its name.
    from portbench import program_spans

    sys.exit(program_spans.main(start=_START))
