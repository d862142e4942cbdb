"""The port's tracing hooks (``utils/profiling.py``): the JAX package's API
(tests/test_profiling.py) on ``torch.profiler``."""

import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_torch.utils import profiling  # noqa: E402


def test_stage_timers_accumulate():
    t = profiling.StageTimers()
    for _ in range(3):
        with t.stage("extract"):
            pass
    with t.stage("match"):
        pass
    rep = t.report()
    assert set(rep) == {"extract", "match"}
    assert rep["extract"]["calls"] == 3 and rep["match"]["calls"] == 1
    assert rep["extract"]["seconds"] >= 0.0


def test_stage_records_time_even_on_exception():
    t = profiling.StageTimers()
    with pytest.raises(RuntimeError):
        with t.stage("boom"):
            raise RuntimeError("x")
    assert t.report()["boom"]["calls"] == 1


def test_module_level_stage_and_report():
    with profiling.stage("unit-test-stage"):
        pass
    assert profiling.report()["unit-test-stage"]["calls"] >= 1


def test_trace_to_writes_a_chrome_trace_with_the_stages(tmp_path):
    with profiling.trace_to(str(tmp_path)):
        with profiling.StageTimers().stage("extract-stage"):
            torch.ones(64).cumsum(0).sum()
    with profiling.trace_to(str(tmp_path)):
        torch.ones(8).sum()
    traces = sorted(pathlib.Path(tmp_path).glob("trace_*.json"))
    assert len(traces) == 2                 # a second trace does not overwrite the first
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "extract-stage" in names
