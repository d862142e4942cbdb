"""Median wall of a post-caused ``pool.flush`` and the ``pool.top_k`` that
ranked after it (the program's spans)."""

import statistics

from portbench import program_spans as ps


def read(trace):
    spans = ps.spans_of(trace)
    if spans is None:
        return None
    walls = [ps.wall_ns(f) + ps.wall_ns(t) for f, t in ps.post_flushes(spans) if t is not None]
    return statistics.median(walls) / 1e6 if walls else None
