"""Median time a session's close held the pool's locks: the wall of a
``pool.close`` span (cause ``close``) less the wait to acquire them, which
covers its flush, its top-k and the slot's reset (the program's spans)."""

import statistics

from portbench import program_spans as ps


def read(trace):
    spans = ps.spans_of(trace)
    if spans is None:
        return None
    held = [ps.wall_ns(c) - c["attrs"]["waited_ns"]
            for c in ps.named(spans, "pool.close", cause="close") if "waited_ns" in c["attrs"]]
    return statistics.median(held) / 1e6 if held else None
