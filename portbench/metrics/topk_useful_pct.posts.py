"""Share of the session slots that the pool's top-k calls scored whose
results went into an answer: 100 x the sum of ``slots_used`` over the sum
of ``slots_scored`` of every ``pool.top_k`` span (the program's spans)."""

from portbench import program_spans as ps


def read(trace):
    spans = ps.spans_of(trace)
    if spans is None:
        return None
    tops = ps.named(spans, "pool.top_k")
    scored = sum(t["attrs"].get("slots_scored", 0) for t in tops)
    return 100.0 * sum(t["attrs"].get("slots_used", 0) for t in tops) / scored if scored else None
