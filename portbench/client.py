#!/usr/bin/env python3
"""The load generator of the live-session cells, run in a process of its
own: one connection a request, each request timed from when it was due (an
open loop), so that a stall shows in the latency of every request behind
it.

    python3 portbench/client.py <job.json> <results.json>

It reads its job, prints ``ready``, waits for ``go`` and the server's
address on standard input, sends the schedule, waits for every answer (a
minute past the window at most), writes the results and prints ``done``.
It imports the standard library only.

Job ``posts``: ``sessions`` slots, each opening a live session, posting its
texts one every ``period_s`` and closing it, then opening the next; slot
``s`` starts at ``s * period_s / sessions``.  A slot sends a post at its
due time or when its previous answer came, whichever is later.
"""

from __future__ import annotations

import http.client
import json
import pathlib
import sys
import threading
import time

TAIL_S = 60.0


def call(addr, method: str, path: str, body: bytes | None = None) -> tuple[int, dict | None]:
    conn = http.client.HTTPConnection(addr[0], addr[1], timeout=TAIL_S + 60)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        status, raw = resp.status, resp.read()
    finally:
        conn.close()
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, None


def timed(addr, t0: float, due: float, method: str, path: str, body=None) -> dict:
    """One request: due time, how late it was sent and its latency from
    the due time (seconds), status, answer."""
    late = time.perf_counter() - t0 - due
    try:
        status, out = call(addr, method, path, body)
    except OSError as e:
        status, out = 0, {"error": str(e)}
    return {"due": due, "late": late, "latency": time.perf_counter() - t0 - due,
            "status": status, "answer": out}


def sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def wait_for_go() -> tuple[str, int]:
    """Block until the benchmark sends ``go <host> <port>``: the server's
    address, at the window's start."""
    _, host, port = sys.stdin.readline().split()
    return host, int(port)


def run_posts(job: dict, t0: float) -> list[dict]:
    n, period, seconds = job["sessions"], job["period_s"], job["seconds"]
    texts = job["texts"]                       # [instance][post] -> body
    per_slot = len(texts) // n
    out: list[dict] = []
    lock = threading.Lock()
    print("ready", flush=True)
    addr = wait_for_go()
    t0 = time.perf_counter()

    def slot(s: int) -> None:
        start = s * period / n
        for j in range(per_slot):
            inst = s * per_slot + j
            begin = start + j * len(texts[inst]) * period
            if begin >= seconds:
                return
            sleep_until(t0 + begin)
            opened = timed(addr, t0, begin, "POST", "/stream/open")
            sid = (opened["answer"] or {}).get("session") if opened["status"] == 200 else None
            for k, body in enumerate(texts[inst]):
                due = begin + k * period
                if due >= seconds:
                    break
                sleep_until(t0 + due)
                if sid is None:
                    rec = {"due": due, "late": 0.0, "latency": float("inf"),
                           "status": opened["status"], "answer": opened["answer"]}
                else:
                    rec = timed(addr, t0, due, "POST", f"/stream/{sid}", body.encode("ascii"))
                with lock:
                    out.append(dict(rec, instance=inst, post=k))
            if sid is not None:
                timed(addr, t0, 0.0, "POST", f"/stream/{sid}/close")

    threads = [threading.Thread(target=slot, args=(s,)) for s in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(seconds + TAIL_S + 120)
    return sorted(out, key=lambda r: (r["instance"], r["post"]))


def main(argv) -> int:
    job = json.loads(pathlib.Path(argv[1]).read_text())
    runner = {"posts": run_posts}[job["kind"]]
    results = runner(job, time.perf_counter())
    pathlib.Path(argv[2]).write_text(json.dumps(results))
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
