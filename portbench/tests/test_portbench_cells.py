"""Every cell's driver run end to end on the CPU at a tiny size, through
the port's CPU path, and held to the reference (``correct`` true); then
with the timed path broken underneath in each way the cell can break, and
``correct`` false.  The control (the reference a precision step down in the
program's place, judged by the run's own check) runs here through the same
path, and on the card at each cell's own size, where ``correct`` has to
come out false."""

from __future__ import annotations

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from portbench import control, run
from portbench.tests import tiny

CELLS = [w["name"] for w in json.loads((tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("portbench"))


def run_cell(root, workload: str, seed: int = 2**31 + 77) -> dict:
    out = io.StringIO()
    with redirect_stdout(out):
        assert run.main(["--workload", workload, "--seed", str(seed), "--seconds", "1.5"],
                        root=root, device="cpu") == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_on_the_port_cpu_path_is_correct(root, workload):
    line = run_cell(root, workload)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


def _alter_fingerprints(monkeypatch):
    from lbaudiodetective_torch.models.detective import AudioDetective
    from lbaudiodetective_torch.models.fingerprint import Fingerprint

    orig = AudioDetective.process_decoded_batch

    def altered(self, clips):
        out = []
        for fp in orig(self, clips):
            pos, neg = fp.pos.copy(), fp.neg.copy()
            pos[0], neg[0] = neg[0], pos[0]
            out.append(Fingerprint(pos, neg))
        return out

    monkeypatch.setattr(AudioDetective, "process_decoded_batch", altered)


def _half_batch(monkeypatch):
    from lbaudiodetective_torch.models.detective import AudioDetective
    from lbaudiodetective_torch.models.fingerprint import Fingerprint

    orig = AudioDetective.process_decoded_batch

    def half(self, clips):
        done = orig(self, clips[:len(clips) // 2])
        empty = Fingerprint(np.zeros_like(done[0].pos), np.zeros_like(done[0].neg))
        return done + [empty] * (len(clips) - len(done))

    monkeypatch.setattr(AudioDetective, "process_decoded_batch", half)


def _posts_unchanged(monkeypatch):
    from lbaudiodetective_torch.streaming.incremental import StreamSessionPool

    def dropped(self):
        self._pending.clear()
        return 0

    monkeypatch.setattr(StreamSessionPool, "flush", dropped)


def _posts_altered(monkeypatch):
    from lbaudiodetective_torch.serving import IdentificationService

    orig = IdentificationService.stream_update

    def altered(self, sid, payload):
        out = orig(self, sid, payload)
        for entry in out["top"]:
            entry["score"] += 1e-3
        return out

    monkeypatch.setattr(IdentificationService, "stream_update", altered)


def _posts_half(monkeypatch):
    from lbaudiodetective_torch.streaming.incremental import StreamSessionPool

    orig = StreamSessionPool.flush

    def half(self):
        for sid in sorted(self._pending)[len(self._pending) // 2:]:
            del self._pending[sid]
        return orig(self)

    monkeypatch.setattr(StreamSessionPool, "flush", half)


FAULTS = [
    ("enroll_b256", "an answer altered where it is produced", _alter_fingerprints),
    ("enroll_b256", "half of the batch left out", _half_batch),
    ("posts_pooled", "a step that returns its state unchanged", _posts_unchanged),
    ("posts_pooled", "half of the batch left out", _posts_half),
    ("posts_pooled", "an answer altered where it is produced", _posts_altered),
]


@pytest.mark.parametrize("workload,fault,plant", FAULTS, ids=[f"{w}-{f}" for w, f, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, workload, fault, plant):
    plant(monkeypatch)
    line = run_cell(root, workload, seed=2**31 + 91)
    assert not line["correct"], (fault, line["checks"])


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_runs_through_the_cell_check(root, workload):
    line = control.result(workload, 2**31 + 101, root=root, device="cpu")
    assert line["attempted"] > 0 and set(line["checks"]) == set(run_cell(root, workload)["checks"])
    if workload == "posts_pooled":      # bfloat16 is bfloat16 on the CPU too; TF32 is not
        assert not line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct_at_the_cell_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size, on a CUDA card")
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        line = control.result(workload, seed)
        print(json.dumps({"workload": workload, "seed": seed, "correct": line["correct"],
                          "checks": line["checks"]}))
        assert not line["correct"], line["checks"]
