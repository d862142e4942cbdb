"""Share of the session slots that the pool's folds counted hits for whose
sessions had posted: 100 x the sum of ``sessions`` over the sum of
``slots_folded`` of every ``pool.flush`` span (the program's spans).  None
where no flush span carries ``slots_folded``."""

from portbench import program_spans as ps


def read(trace):
    spans = ps.spans_of(trace)
    if spans is None:
        return None
    flushes = [f for f in ps.named(spans, "pool.flush") if "slots_folded" in f["attrs"]]
    folded = sum(f["attrs"]["slots_folded"] for f in flushes)
    return 100.0 * sum(f["attrs"].get("sessions", 0) for f in flushes) / folded if folded else None
