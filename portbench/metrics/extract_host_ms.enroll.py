"""Host time of an enrollment batch: the wall of a wrapped
``process_decoded_batch`` call less the time inside it in which the device
was busy, per batch."""


def read(trace):
    walls = trace.walls_ns("process_decoded_batch")
    if not walls:
        return None
    return sum((e - s) - trace.busy_ns(s, e) for s, e, _ in walls) / len(walls) / 1e6
