"""p95 over the window's live-session posts of the time from a post's
``serve.request`` opening to the start of the ``pool.flush`` that answered
it (the program's spans)."""

from portbench import program_spans as ps


def read(trace):
    spans = ps.spans_of(trace)
    if spans is None:
        return None
    flushes = {s["id"]: s for s in ps.named(spans, "pool.flush")}
    waits = [flushes[p["attrs"]["flush"]]["start_ns"] - p["start_ns"]
             for p in ps.posts(spans) if p["attrs"].get("flush") in flushes]
    return ps.p95(waits) / 1e6 if waits else None
