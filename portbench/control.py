#!/usr/bin/env python3
"""The control of a cell's correctness check: a whole run of the cell with
the plain reference in the place of the program's timed calls, a precision
step below what the configuration states (TF32 for the float32 extraction,
bfloat16 for the float32 scores), at the cell's own size on the card, for
``control_seconds`` of its traffic, and judged by the run's own check.
Each run should read ``correct`` false: a control that passed would show
that the check cannot tell the program from a cheaper computation.  The
benchmark's runs never run it.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

Prints each run's result line, with its workload and seed.
"""

from __future__ import annotations

import argparse
import io
import json
import pathlib
import sys
import time
from contextlib import redirect_stdout

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, run  # noqa: E402


def result(workload: str, seed: int, root: pathlib.Path = ROOT, device=None) -> dict:
    """The result line of the control's run of ``workload`` on ``seed``."""
    seconds = harness.Cell.find(workload, root).traffic["control_seconds"]
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds)],
                      root=root, device=device, start=time.perf_counter(), control=True)
    if rc != 0:
        raise RuntimeError(f"the control's run of {workload} exited {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **result(args.workload, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
