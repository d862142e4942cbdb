"""Mean sessions folded by a post-caused ``pool.flush`` (its ``sessions``
attribute; the program's spans)."""

import statistics

from portbench import program_spans as ps


def read(trace):
    spans = ps.spans_of(trace)
    if spans is None:
        return None
    folded = [f["attrs"]["sessions"] for f in ps.named(spans, "pool.flush", cause="post")
              if "sessions" in f["attrs"]]
    return statistics.mean(folded) if folded else None
