"""The readers of the program's spans (``portbench/program_spans.py`` and
the metrics of ``program_metrics.json``) on hand-built traced windows, the
idle gaps named by the program's spans across threads, and a run of each
cell with the recorder on that reads every one of them."""

from __future__ import annotations

import io
import json
from contextlib import redirect_stdout

import pytest

from portbench import harness, program_spans as ps
from portbench.tests import tiny

METRICS = json.loads((tiny.PB / "program_metrics.json").read_text())
MS = 1_000_000


def reader(name: str):
    return harness.load_module(tiny.PB / "metrics" / f"{name}.py").read


class Spans:
    """Span dicts as ``Recording.on_trace_clock`` gives them."""

    def __init__(self):
        self.spans: list[dict] = []

    def add(self, name, start, end, parent=None, thread=1, **attrs) -> dict:
        sid = len(self.spans) + 1
        p = next((s for s in self.spans if s["id"] == parent), None)
        self.spans.append({"name": name, "id": sid, "parent": parent,
                           "request": p["request"] if p else sid, "thread": thread,
                           "start_ns": start, "end_ns": end, "attrs": attrs})
        return self.spans[-1]


def trace(spans, device=(), dropped=0, calls=None, window=(0, 1000 * MS)):
    return ps.ProgramTrace(window, list(device), calls or {}, {}, None, 0, 0.0,
                           program_spans=spans, program_dropped=dropped)


def service(posts_per_flush=(3, 1), close_at=None) -> Spans:
    """Leaders each flushing a few posts (each post 10 ms into its own
    request), then a close; times in ms from 100 ms on."""
    sp = Spans()
    t = 100 * MS
    thread = 10
    for n in posts_per_flush:
        reqs = [sp.add("serve.request", t + i * MS, t + 60 * MS + i * MS, thread=thread + i,
                       method="POST", route="/stream/<id>") for i in range(n)]
        lead = reqs[0]
        sp.add("pool.enqueue", t, t + 2 * MS, lead["id"], lead["thread"], rows=8, waited_ns=MS)
        sp.add("pool.window", t + 2 * MS, t + 22 * MS, lead["id"], lead["thread"], waited_ns=0)
        sp.add("pool.dispatch_wait", t + 22 * MS, t + 23 * MS, lead["id"], lead["thread"])
        fl = sp.add("pool.flush", t + 23 * MS, t + 33 * MS, lead["id"], lead["thread"],
                    cause="post", sessions=n, k_max=8, rows=8 * n,
                    requests=[r["request"] for r in reqs])
        sp.add("pool.top_k", t + 33 * MS, t + 53 * MS, lead["id"], lead["thread"],
               cause="post", slots_scored=64, slots_used=n)
        for r in reqs:
            r["attrs"]["flush"] = fl["id"]
            sp.add("serve.respond", r["end_ns"] - MS, r["end_ns"], r["id"], r["thread"])
        t += 200 * MS
        thread += 10
    if close_at is not None:
        req = sp.add("serve.request", close_at, close_at + 50 * MS, thread=99, method="POST",
                     route="/stream/<id>/close")
        c = sp.add("pool.close", close_at, close_at + 45 * MS, req["id"], 99, cause="close",
                   waited_ns=5 * MS)
        sp.add("pool.flush", close_at + 5 * MS, close_at + 15 * MS, c["id"], 99, cause="close",
               sessions=0, k_max=0, rows=0)
        sp.add("pool.top_k", close_at + 15 * MS, close_at + 40 * MS, c["id"], 99, cause="close",
               slots_scored=64, slots_used=1)
    return sp


def test_post_wait_is_the_p95_of_each_post_joined_to_its_flush():
    sp = service(posts_per_flush=[1] * 20)
    for k, p in enumerate(ps.posts(sp.spans)):
        flush = next(s for s in sp.spans if s["id"] == p["attrs"]["flush"])
        p["start_ns"] = flush["start_ns"] - (k + 1) * MS        # post k waited k + 1 ms
    sp.add("serve.request", 0, 90 * MS, thread=7, method="POST", route="/stream/<id>",
           flush=12345)                                  # its flush was not recorded
    assert reader("post_wait_ms.posts")(trace(sp.spans)) == 20.0      # ceil(0.95 * 19) -> the 20th
    assert ps.p95(list(range(1, 101))) == 96 and ps.p95([4.0]) == 4.0


def test_flush_close_and_fold_counts():
    sp = service(posts_per_flush=(3, 1, 2), close_at=800 * MS)
    t = trace(sp.spans)
    assert reader("flush_ms.posts")(t) == 30.0                      # 10 ms fold + 20 ms top-k
    assert reader("close_ms.posts")(t) == 40.0                      # 45 ms held less 5 ms waited
    assert reader("flush_posts.posts")(t) == 2.0                    # (3 + 1 + 2) / 3
    assert reader("topk_useful_pct.posts")(t) == pytest.approx(100.0 * 7 / 256)
    pairs = ps.post_flushes(sp.spans)
    assert len(pairs) == 3 and all(top["attrs"]["cause"] == "post" for _, top in pairs)


def test_extract_spans_are_means_a_batch():
    sp = Spans()
    for k, (pad, wrap) in enumerate(((30, 4), (40, 6))):
        t = k * 100 * MS
        root = sp.add("detective.batch", t, t + 90 * MS, clips=256)
        sp.add("extract.pad", t, t + pad * MS, root["id"], clips=256)
        sp.add("fingerprint.wrap", t + 80 * MS, t + (80 + wrap) * MS, root["id"], clips=256)
    t = trace(sp.spans)
    assert reader("extract_pad_ms.enroll")(t) == 35.0
    assert reader("extract_wrap_ms.enroll")(t) == 5.0


@pytest.mark.parametrize("name", [m["name"] for m in METRICS])
def test_a_reader_finds_nothing_without_spans_or_with_any_dropped(name):
    sp = service(posts_per_flush=(3, 1), close_at=800 * MS)
    root = sp.add("detective.batch", 0, 90 * MS)
    sp.add("extract.pad", 0, 30 * MS, root["id"])
    sp.add("fingerprint.wrap", 80 * MS, 84 * MS, root["id"])
    read = reader(name)
    assert read(trace(sp.spans)) is not None
    assert read(trace(sp.spans, dropped=1)) is None
    assert read(trace([])) is None
    assert read(trace([s for s in sp.spans if s["name"] == "serve.respond"])) is None
    plain = harness.Trace((0, MS), [], {}, {}, None, 0, 0.0)
    assert read(plain) is None


def test_the_metrics_are_entries_of_the_benchmark_form():
    bench = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    layers = {m["layer"] for m in bench["per_layer"]}
    for m in METRICS:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] == "program_span" and (tiny.PB / "metrics" / f"{m['name']}.py").exists()
        assert all(w in e2e[m["moves"]]["workloads"] for w in m["workloads"])
        assert m["name"] not in {p["name"] for p in bench["per_layer"]}
    assert {m["layer"] for m in METRICS} - layers == {"service, live sessions"}


def test_idle_gaps_are_named_by_the_narrowest_program_span_on_any_thread():
    device = [("k", 0, 10 * MS), ("k", 20 * MS, 30 * MS), ("k", 60 * MS, 70 * MS),
              ("k", 100 * MS, 104 * MS)]
    sp = Spans()
    sp.add("serve.request", 5 * MS, 50 * MS, thread=1)                  # wide, thread 1
    sp.add("pool.top_k", 11 * MS, 19 * MS, 1, thread=2)                 # narrow, thread 2
    batch = sp.add("detective.batch", 30 * MS, 59 * MS, thread=3)
    sp.add("extract.pad", 40 * MS, 50 * MS, batch["id"], thread=3)
    calls = {"process_decoded_batch": [{"id": 0, "start_ns": 29 * MS, "end_ns": 60 * MS}]}
    t = trace(sp.spans, device=device, calls=calls, window=(0, 120 * MS))
    named = ps.breakdown(t)
    assert [(n, round(s * 1e3)) for n, s in named["idle_gaps"]] == [
        ("process_decoded_batch > extract.pad", 30), ("between calls", 30),
        ("between calls", 16), ("pool.top_k", 10)]
    plain = harness.breakdown(t)
    assert named["device_ops"] == plain["device_ops"]
    assert [s for _, s in named["idle_gaps"]] == [s for _, s in plain["idle_gaps"]]
    assert [n for n, _ in plain["idle_gaps"]] == ["process_decoded_batch"] + ["between calls"] * 3


def test_the_slowest_posts_split_their_wait():
    """A leader queued behind a close, and its follower (times in ms)."""
    sp = Spans()
    close = sp.add("pool.close", 95 * MS, 110 * MS, thread=99, cause="close", waited_ns=0)
    sp.add("pool.flush", 100 * MS, 104 * MS, close["id"], 99, cause="close", sessions=0)
    sp.add("pool.top_k", 104 * MS, 109 * MS, close["id"], 99, cause="close", slots_used=1)
    lead = sp.add("serve.request", 100 * MS, 170 * MS, thread=10, method="POST",
                  route="/stream/<id>")
    follow = sp.add("serve.request", 115 * MS, 165 * MS, thread=11, method="POST",
                    route="/stream/<id>")
    for r, (t0, waited) in ((lead, (100, 8 * MS)), (follow, (115, MS // 2))):
        sp.add("serve.parse", t0 * MS, (t0 + 1) * MS, r["id"], r["thread"])
        sp.add("pool.enqueue", (t0 + 1) * MS, (t0 + 2) * MS + (9 * MS if r is lead else 0),
               r["id"], r["thread"], waited_ns=waited)
        sp.add("serve.respond", r["end_ns"] - 2 * MS, r["end_ns"], r["id"], r["thread"])
    sp.add("pool.wait", 117 * MS, 163 * MS, follow["id"], 11)
    sp.add("pool.window", 111 * MS, 131 * MS, lead["id"], 10, waited_ns=2 * MS,
           timeout_ns=15 * MS)                      # 2 ms to take _pcond, 3 ms to take it back
    sp.add("pool.dispatch_wait", 131 * MS, 132 * MS, lead["id"], 10)
    flush = sp.add("pool.flush", 132 * MS, 142 * MS, lead["id"], 10, cause="post", sessions=2,
                   requests=[lead["request"], follow["request"]])
    sp.add("pool.top_k", 142 * MS, 162 * MS, lead["id"], 10, cause="post", slots_used=2)
    lead["attrs"]["flush"] = follow["attrs"]["flush"] = flush["id"]
    slow = ps.slow_posts(sp.spans, share=0.5)
    assert slow["posts"] == 2 and slow["slow"] == 1 and slow["wall_ms"] == 70.0
    assert slow["parts_ms"] == {"parse": 1.0, "enqueue_wait": 8.0, "window_lock_wait": 5.0,
                                "window": 15.0, "dispatch_wait": 1.0, "flush": 10.0,
                                "top_k": 20.0, "respond": 2.0, "other": 8.0}
    assert slow["lock_behind_ms"] == {"pool.flush:close": 3.0, "pool.top_k:close": 5.0}
    both = ps.slow_posts(sp.spans, share=1.0)
    assert both["parts_ms"]["window"] == 13.0                       # the follower's 11 ms of it
    assert both["parts_ms"]["window_lock_wait"] == 4.0              # and 3 ms
    assert sum(both["parts_ms"].values()) == pytest.approx(both["wall_ms"]) == 60.0


@pytest.mark.parametrize("workload", ["posts_pooled", "enroll_b256"])
def test_a_traced_run_with_the_recorder_reads_every_program_metric(tmp_path, workload):
    root = tiny.make_root(tmp_path)
    out = io.StringIO()
    saved = (harness.load_module, harness.Trace, harness.breakdown, harness.device_events)
    with redirect_stdout(out):
        assert ps.main(["--workload", workload, "--seed", str(2**31 + 9), "--seconds", "1.5",
                        "--trace", "1"], root=root, device="cpu") == 0
    assert (harness.load_module, harness.Trace, harness.breakdown, harness.device_events) == saved
    assert len(harness.Cell.find(workload, root).per_layer) == len(
        [m for m in json.loads((root / "BENCHMARK.json").read_text())["per_layer"]
         if workload in m["workloads"]])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"]
    wanted = {m["name"] for m in METRICS if workload in m["workloads"]}
    assert wanted <= set(line["metrics"])
    saved_spans = json.loads(
        (root / "build" / "portbench" / workload / "program_spans.json").read_text())
    assert saved_spans["dropped"] == 0 and saved_spans["clock"]["anchors"] == 10
    assert saved_spans["idle_gaps"] and saved_spans["window"][1] > saved_spans["window"][0]
    assert (saved_spans["slow_posts"] is not None) == (workload == "posts_pooled")
