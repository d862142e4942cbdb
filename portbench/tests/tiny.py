"""A copy of the benchmark at sizes a CPU test holds: the same files, the
configurations' libraries and the traffic cut down, written next to a
``BENCHMARK.json`` of the same cells in a temporary root."""

from __future__ import annotations

import json
import pathlib
import shutil

PB = pathlib.Path(__file__).resolve().parents[1]
ROOT = PB.parent

CONFIGS = {
    "birds_live64k": {"library": {"tracks": 256, "rows": 24, "min_count": 8, "max_count": 24}},
}
TRAFFIC = {
    "enroll_b256": {"batch": 3, "distinct_batches": 2, "clip_seconds": 3.0, "checked": 4,
                    "control_seconds": 1.5, "control_block": 2},
    "posts_pooled": {"sessions": 3, "period_s": 0.3, "posts": 2, "post_rows": 4, "checked": 4,
                     "control_seconds": 1.5},
}


def make_root(tmp: pathlib.Path) -> pathlib.Path:
    """A root holding ``BENCHMARK.json`` and ``portbench/`` with tiny
    configurations and traffic."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(PB, tmp / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    for name, changes in CONFIGS.items():
        path = tmp / "portbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        for key, value in changes.items():
            cfg[key] = {**cfg.get(key, {}), **value}
        path.write_text(json.dumps(cfg))
    for name, changes in TRAFFIC.items():
        path = tmp / "portbench" / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **changes}))
    return tmp
