#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (inputs and library from the seed on the device, the program's
objects, a warm-up of the cell's own shapes) is timed from process start as
``setup_s``; then the cell's traffic runs for ``--seconds``.  With
``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` the window runs under ``torch.profiler`` with the program's
public calls wrapped in spans, and the result carries the per-layer metrics,
the device's busy time and a breakdown.  Once the window has closed, the
peak device memory is read, the program's state is freed, and what the
window produced is checked against the plain reference in
``portbench/reference``: each number compared is printed beside its limit
on standard error and under ``checks``, the last key of the result, which
is the last line of standard output.

Exits 2 without a result when CUDA is missing or has fewer cards than the
cell asks for, and 3 when a forbidden module (JAX or the JAX package) was
loaded.
"""

from __future__ import annotations

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def smi(fields: str) -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return ""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None, root: pathlib.Path = ROOT, device=None, start: float | None = None,
         control: bool = False) -> int:
    """Run a cell; returns the exit code.  ``device`` other than None skips
    the look for a card (the harness's CPU tests); ``start`` is when set-up
    began (default: when this module was loaded, at process start).
    ``control`` puts the driver's control (the reference a precision step
    down) in the place of the program's timed calls from set-up to the
    window's close (``portbench/control.py``; the benchmark's runs never
    pass it)."""
    start = _START if start is None else start
    args = parse(argv)
    cell = harness.Cell.find(args.workload, root)
    import torch

    if device is None:
        chips = int(cell.workload.get("chips", 1))
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"portbench: cell {cell.name} needs {chips} CUDA card(s); "
                f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = torch.device("cuda:0")
    device = torch.device(device)
    work_dir = root / "build" / "portbench" / cell.name
    work_dir.mkdir(parents=True, exist_ok=True)
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace), device, work_dir)
    driver = harness.load_module(cell.driver_path()).Driver(run)
    cuda = device.type == "cuda"
    restore = driver.control() if control else None

    driver.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - start
    log(f"portbench: {cell.name} seed {args.seed}: set-up {setup_s:.3f} s")

    tracer = harness.Tracer() if args.trace else None
    if tracer:
        driver.wrap(tracer)
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function("pb:window"):
                driver.window(args.seconds)
                if cuda:
                    torch.cuda.synchronize(device)
        tracer.unwrap()
    else:
        driver.window(args.seconds)
    if cuda:
        torch.cuda.synchronize(device)
        peak = max(torch.cuda.max_memory_allocated(d) for d in range(torch.cuda.device_count()))
    else:
        peak = 0
    if restore:
        restore()
    bad = harness.forbidden_modules()
    if bad:
        log(f"portbench: forbidden modules loaded: {', '.join(bad)}")
        return 3

    attempted, failed = driver.counts()
    metrics, extra = {}, {}
    if tracer:
        device_events, span_ns, window = harness.device_events(prof)
        for name, spans in tracer.spans.items():
            for sp in spans:
                if sp["id"] in span_ns:
                    sp["start_ns"], sp["end_ns"] = span_ns[sp["id"]]
        sms = torch.cuda.get_device_properties(device).multi_processor_count if cuda else 0
        sm_mhz = float(smi("clocks.max.sm") or 0) if cuda else 0.0
        trace = harness.Trace(window or (0, 0), device_events, tracer.spans,
                              driver.counters(), cell, sms, sm_mhz)
        for m in cell.per_layer:
            value = harness.load_module(cell.metric_path(m["name"])).read(trace)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        extra = {"busy_s": trace.busy_ns() / 1e9, "window_s": trace.window_s}
        bd = harness.breakdown(trace)
    else:
        values = {"setup_s": setup_s, **driver.end_to_end()}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    driver.release()
    checks = driver.check()
    correct = all(value <= limit for _, value, limit in checks)
    if cuda:
        log(f"portbench: card {smi('name,power.limit,clocks.max.sm')}")
    for name, value, limit in checks:
        log(f"check {name} {value!r} limit {limit!r}")
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": 1, "memory_peak_bytes": int(peak), **extra}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if tracer:
        result["breakdown"] = bd
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    bad = harness.forbidden_modules()
    if bad:
        log(f"portbench: forbidden modules loaded: {', '.join(bad)}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
