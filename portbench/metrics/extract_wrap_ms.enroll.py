"""Mean wall of ``fingerprint.wrap``, building a batch's ``Fingerprint``
objects from the planes copied back, a batch (the program's spans)."""

import statistics

from portbench import program_spans as ps


def read(trace):
    spans = ps.spans_of(trace)
    if spans is None:
        return None
    walls = [ps.wall_ns(s) for s in ps.named(spans, "fingerprint.wrap")]
    return statistics.mean(walls) / 1e6 if walls else None
