"""The port's span recorder (``utils/profiling.py``): off by default, spans
with thread, parent, request id and attributes inside ``recording()``, on
``torch.profiler``'s clock from any thread, and in ``trace_to``'s Chrome
trace."""

import json
import pathlib
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from lbaudiodetective_torch.utils import profiling  # noqa: E402

HALF_MS = 500_000


def test_stage_is_the_shared_noop_and_records_nothing_when_off():
    sp = profiling.stage("off", rows=3)
    assert sp is profiling.NO_SPAN and profiling.stage("other") is sp
    with sp as inner:
        inner.set(rows=4)
        inner.elapsed("waited_ns")
        assert profiling.current() is profiling.NO_SPAN
    assert sp.id is None and sp.request is None
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.dropped == 0


def test_stage_records_time_even_on_exception():
    """Name, thread, parent, request and attributes; nesting holds when a
    span ends in an exception."""
    with profiling.recording() as rec:
        with profiling.stage("root", route="/x") as root:
            with pytest.raises(RuntimeError):
                with profiling.stage("boom", rows=2) as boom:
                    boom.set(bytes=8)
                    raise RuntimeError("x")
            with profiling.stage("after") as after:
                assert profiling.current() is after
                after.elapsed("waited_ns")
            assert profiling.current() is root
        with profiling.stage("other", request="req-7"):
            with profiling.stage("child"):
                pass
    assert profiling.stage("late") is profiling.NO_SPAN
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["boom", "after", "root", "child", "other"]
    assert by["root"].parent is None and by["root"].request == by["root"].id
    assert by["boom"].parent == by["after"].parent == by["root"].id
    assert by["boom"].request == by["after"].request == by["root"].id
    assert by["boom"].attrs == {"rows": 2, "bytes": 8, "error": "RuntimeError"}
    assert by["root"].attrs == {"route": "/x"}
    assert 0 <= by["after"].attrs["waited_ns"] <= by["after"].end_ns - by["after"].start_ns
    assert by["child"].request == by["other"].request == "req-7"
    assert by["child"].parent == by["other"].id
    assert {s.thread for s in rec.spans} == {threading.get_native_id()}
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
    assert by["root"].start_ns <= by["boom"].start_ns <= by["boom"].end_ns <= by["root"].end_ns


def test_threads_keep_their_own_parents_and_the_buffer_is_bounded():
    def work(i):
        with profiling.stage("t.root", request=i):
            for _ in range(3):
                with profiling.stage("t.child", i=i):
                    time.sleep(0)

    with profiling.recording(capacity=10) as rec:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(rec.spans) == 10 and rec.dropped == 10
    ids = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name == "t.child":
            assert s.request == s.attrs["i"]
            if s.parent in ids:
                assert ids[s.parent].thread == s.thread and ids[s.parent].request == s.request
    with pytest.raises(RuntimeError, match="already"):
        with profiling.recording():
            with profiling.recording():
                pass


def _events(prof) -> dict:
    return {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()}


@pytest.mark.parametrize("where", ["profiler thread", "other thread"])
def test_spans_land_on_the_profiler_clock(where):
    """A span between two ``record_function`` ranges of the profiling
    thread lies between them on the profiler's clock, to 0.5 ms, whether
    it ran on that thread or on one the profiler does not see."""
    go, done = threading.Event(), threading.Event()

    def span():
        go.wait(timeout=60)
        with profiling.stage("between"):
            time.sleep(0.002)
        done.set()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.recording() as rec:
            worker = threading.Thread(target=span) if where == "other thread" else None
            if worker:
                worker.start()
            with record_function("before"):
                pass
            if worker:
                go.set()
                done.wait(timeout=60)
            else:
                go.set()
                span()
            with record_function("after"):
                pass
    if worker:
        worker.join(timeout=60)
        assert not worker.is_alive()
    spans = rec.on_trace_clock(prof)
    events = _events(prof)
    (sp,) = [s for s in spans if s["name"] == "between"]
    assert (sp["thread"] == threading.get_native_id()) == (where == "profiler thread")
    assert sp["start_ns"] >= events["before"][1] - HALF_MS
    assert sp["end_ns"] <= events["after"][0] + HALF_MS
    assert sp["end_ns"] - sp["start_ns"] >= 2_000_000
    assert rec.clock["anchors"] == 10


def test_trace_to_writes_a_chrome_trace_with_the_stages(tmp_path):
    """The program's spans from a second thread go into the Chrome trace
    beside the profiler's events, with their ids and attributes."""
    def handler():
        with profiling.stage("serve.request", route="/stream/<id>"):
            with profiling.stage("pool.flush", sessions=3):
                torch.ones(64).cumsum(0).sum()

    with profiling.trace_to(str(tmp_path)):
        with record_function("main-range"):
            t = threading.Thread(target=handler)
            t.start()
            t.join(timeout=60)
    with profiling.trace_to(str(tmp_path)):
        torch.ones(8).sum()
    assert profiling.stage("x") is profiling.NO_SPAN
    traces = sorted(pathlib.Path(tmp_path).glob("trace_*.json"))
    assert len(traces) == 2                 # a second trace does not overwrite the first
    events = json.loads(traces[0].read_text())["traceEvents"]
    program = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(program) == {"serve.request", "pool.flush"}
    req, flush = program["serve.request"], program["pool.flush"]
    assert req["tid"] == flush["tid"] != threading.get_native_id()
    assert flush["args"]["parent"] == req["args"]["id"] == flush["args"]["request"]
    assert flush["args"]["sessions"] == 3 and req["args"]["route"] == "/stream/<id>"
    (main,) = [e for e in events if e.get("name") == "main-range"]
    assert main["ts"] - 500 <= req["ts"] <= req["ts"] + req["dur"] <= main["ts"] + main["dur"] + 500
