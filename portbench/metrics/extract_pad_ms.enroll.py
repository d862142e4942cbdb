"""Mean wall of ``extract.pad``, the host padding a batch's clips into one
array, a batch (the program's spans)."""

import statistics

from portbench import program_spans as ps


def read(trace):
    spans = ps.spans_of(trace)
    if spans is None:
        return None
    walls = [ps.wall_ns(s) for s in ps.named(spans, "extract.pad")]
    return statistics.mean(walls) / 1e6 if walls else None
