"""Serving side of the HTTP cells: the program's ``IdentificationServer``
in a thread of the benchmark's process, and the load generator
(``portbench/client.py``) in a process of its own."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import threading

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent


class Server:
    """``make_server(service)`` on 127.0.0.1 at a free port, served from a
    thread until :meth:`stop`."""

    def __init__(self, service):
        from lbaudiodetective_torch.serving import make_server

        self.srv = make_server(service, "127.0.0.1", 0)
        self.addr = list(self.srv.server_address[:2])
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()

    def stop(self) -> None:
        if self.srv is None:
            return
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=60)
        self.srv = None


class Client:
    """The load generator: started in set-up (it makes its payloads while
    the benchmark sets up the rest), :meth:`ready` when they are made,
    released by :meth:`go` at the window's start, joined by :meth:`wait`."""

    def __init__(self, job: dict, work_dir: pathlib.Path):
        self.job_path = work_dir / "client_job.json"
        self.out_path = work_dir / "client_results.json"
        self.job_path.write_text(json.dumps(job))
        self.out_path.unlink(missing_ok=True)
        self.seconds = job["seconds"]
        self.proc = subprocess.Popen(
            [sys.executable, str(HERE / "client.py"), str(self.job_path), str(self.out_path)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def ready(self) -> None:
        line = self.proc.stdout.readline().strip()
        if line != "ready":
            self.proc.kill()
            self.proc.wait()
            raise RuntimeError(f"load generator did not start: {line!r}")

    def go(self, addr) -> None:
        self.proc.stdin.write(f"go {addr[0]} {addr[1]}\n")
        self.proc.stdin.flush()

    def wait(self) -> list[dict]:
        try:
            self.proc.wait(timeout=self.seconds + 240)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        if self.proc.returncode != 0:
            raise RuntimeError(f"load generator exited {self.proc.returncode}")
        return json.loads(self.out_path.read_text())


def summary(records: list[dict], seconds: float) -> str:
    """Median latency, the generator's lateness, the answered rate and the
    latency of the window's first and last thirds (a growing backlog shows
    as a later third slower than the first), for standard error."""
    ok = [r for r in records if r["status"] == 200]
    if not ok:
        return "no answers"
    lat = np.array([r["latency"] for r in ok]) * 1e3
    due = np.array([r["due"] for r in ok])
    first, last = lat[due < seconds / 3], lat[due >= 2 * seconds / 3]
    return (f"answered {len(ok)}/{len(records)} ({len(ok) / seconds:.2f}/s), "
            f"p50 {np.median(lat):.3f} ms, p95 {np.percentile(lat, 95):.3f} ms, "
            f"late p95 {np.percentile([r['late'] for r in ok], 95) * 1e3:.3f} ms, "
            f"mean first third {first.mean() if len(first) else float('nan'):.3f} ms, "
            f"last third {last.mean() if len(last) else float('nan'):.3f} ms; "
            f"p95 a second of due time {[round(float(np.percentile(lat[(due >= s) & (due < s + 1)], 95)), 1) for s in range(int(seconds)) if ((due >= s) & (due < s + 1)).any()]}")


def p95_ms(records: list[dict]) -> float:
    """95th percentile of the latencies, in ms; a failed request counts as
    over every limit (infinite)."""
    lat = np.array([r["latency"] if r["status"] == 200 else np.inf for r in records])
    if not len(lat):
        return float("inf")
    return float(np.percentile(lat, 95, method="higher")) * 1e3
