"""Device time of host-to-device copies inside an enrollment batch (a
wrapped ``process_decoded_batch`` call), per batch."""


def read(trace):
    walls = trace.walls_ns("process_decoded_batch")
    if not walls:
        return None
    return sum(trace.busy_ns(s, e, "Memcpy HtoD") for s, e, _ in walls) / len(walls) / 1e6
