"""``fold_useful_pct.posts`` on hand-built traced windows: the share of the
slots a flush folded whose sessions had posted, None where the spans carry
no ``slots_folded`` (a program from before the count) or none were
recorded."""

from __future__ import annotations

import pytest

from portbench import harness, program_spans as ps
from portbench.tests import tiny


def read(spans, dropped=0):
    trace = ps.ProgramTrace((0, 1), [], {}, {}, None, 0, 0.0, program_spans=spans,
                            program_dropped=dropped)
    return harness.load_module(tiny.PB / "metrics" / "fold_useful_pct.posts.py").read(trace)


def flush(i, **attrs):
    return {"name": "pool.flush", "id": i, "parent": None, "request": i, "thread": 1,
            "start_ns": i, "end_ns": i + 1, "attrs": {"cause": "post", **attrs}}


@pytest.mark.parametrize("folded, want", [((2, 1, 0), 100.0), ((64, 64, 64), 3 / 192 * 100)])
def test_fold_useful_pct_is_sessions_over_slots_folded(folded, want):
    sessions = (2, 1, 0)
    spans = [flush(i, sessions=s, slots_folded=f) for i, (s, f) in enumerate(zip(sessions, folded))]
    assert read(spans) == pytest.approx(want)


def test_fold_useful_pct_reads_nothing_without_the_count():
    assert read([flush(0, sessions=2), flush(1, sessions=1)]) is None
    assert read([flush(0, sessions=2, slots_folded=2)], dropped=1) is None
    assert read([]) is None
