"""The harness: ``BENCHMARK.json`` against the benchmark's contract, every
file found by name, a cell added by files alone, the result line's keys,
the check for JAX, and the reference against the port's CPU path."""

from __future__ import annotations

import hashlib
import io
import json
import pathlib
import re
import shutil
import subprocess
import sys
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from portbench import harness, run
from portbench.reference import extract, match
from portbench.reference.geometry import Geometry
from portbench.tests import tiny

ROOT = tiny.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        reports = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reports) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(workload):
    cell = harness.Cell.find(workload, ROOT)
    assert hasattr(harness.load_module(cell.driver_path()), "Driver")
    assert cell.end_to_end and cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.load_module(cell.metric_path(m["name"])).read)


def _digests(root: pathlib.Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_a_config_and_a_metric_are_added_by_files_alone(tmp_path):
    root = tiny.make_root(tmp_path)
    before = _digests(root)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "birds_enroll.json").read_text())
    (pb / "configs" / "birds_small.json").write_text(json.dumps({**cfg, "name": "birds_small"}))
    traffic = json.loads((pb / "traffic" / "enroll_b256.json").read_text())
    (pb / "traffic" / "enroll_b2.json").write_text(json.dumps({**traffic, "batch": 2}))
    (pb / "metrics" / "batches.enroll2.py").write_text(
        "def read(trace):\n    return trace.counters['batches']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "birds_small", "source": "x",
                             "file": "portbench/configs/birds_small.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "enroll_b2", "config": "birds_small",
                               "traffic": "enroll_b2", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("enroll_b2")
    bench["per_layer"].append({"name": "batches.enroll2", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "kernels",
                               "moves": "clips_per_s", "workloads": ["enroll_b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.Cell.find("enroll_b2", root)
    assert cell.traffic["batch"] == 2 and cell.config["name"] == "birds_small"
    assert [m["name"] for m in cell.per_layer] == ["batches.enroll2"]
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())
    out = io.StringIO()
    with redirect_stdout(out):
        assert run.main(["--workload", "enroll_b2", "--seed", "7", "--seconds", "0.5",
                         "--trace", "1"], root=root, device="cpu") == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["metrics"]["batches.enroll2"]["value"] >= 1


@pytest.mark.parametrize("trace", [0, 1])
def test_the_last_line_has_the_contract_keys(tmp_path, trace):
    root = tiny.make_root(tmp_path)
    out = io.StringIO()
    with redirect_stdout(out):
        assert run.main(["--workload", "enroll_b256", "--seed", str(2**31 + 12345),
                         "--seconds", "0.5", "--trace", str(trace)], root=root, device="cpu") == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(line) == keys + ["checks"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    wanted = {m["name"] for m in BENCH["end_to_end"]
              if "enroll_b256" in m.get("workloads", ["enroll_b256"])}
    if not trace:
        assert set(line["metrics"]) == wanted
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules({"jax.numpy": 0, "numpy": 0}) == ["jax"]
    assert harness.forbidden_modules({"lbaudiodetective_tpu.ops": 0}) == ["lbaudiodetective_tpu"]
    assert harness.forbidden_modules({"jaxlib": 0, "flax.linen": 0}) == ["flax", "jaxlib"]
    assert harness.forbidden_modules({"lbaudiodetective_torch.ops": 0, "jaxtyping": 0,
                                      "lbaudiodetective_tpu_extra": 0}) == []


@pytest.mark.parametrize("name", ["jax", "lbaudiodetective_tpu"])
def test_a_run_that_loaded_jax_fails_without_a_result(tmp_path, monkeypatch, name):
    root = tiny.make_root(tmp_path)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "enroll_b256", "--seed", "1", "--seconds", "0.2"],
                      root=root, device="cpu")
    assert rc == 3 and out.getvalue() == ""


def test_a_run_of_the_port_alone_imports_no_jax(tmp_path):
    root = tiny.make_root(tmp_path)
    code = ("import sys, io, contextlib; sys.path.insert(0, {root!r}); sys.path.insert(1, {repo!r})\n"
            "from portbench import run, harness\n"
            "with contextlib.redirect_stdout(io.StringIO()):\n"
            "    rc = run.main(['--workload', 'enroll_b256', '--seed', '3', '--seconds', '0.2'],"
            " root=__import__('pathlib').Path({root!r}), device='cpu')\n"
            "assert 'lbaudiodetective_torch' in sys.modules\n"
            "print(rc, harness.forbidden_modules())\n").format(root=str(root), repo=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "0 []", out.stderr[-2000:]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, {repo!r})\n"
            "import portbench.reference.extract, portbench.reference.match, "
            "portbench.work, portbench.payloads, portbench.gen, portbench.client\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('lbaudiodetective_torch', 'lbaudiodetective_tpu', 'jax', 'jaxlib', 'flax')))\n"
            ).format(repo=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_a_run_without_a_card_exits_without_a_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    root = tiny.make_root(tmp_path)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "enroll_b256", "--seed", "1", "--seconds", "1"], root=root)
    assert rc == 2 and out.getvalue() == ""


def test_a_run_in_a_folder_of_the_benchmark_alone_fails_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.remove({repo!r}) if {repo!r} in sys.path else None\n"
            "sys.argv = ['run.py', '--workload', 'enroll_b256', '--seed', '1', '--seconds', '1']\n"
            "sys.path.insert(0, {root!r})\n"
            "from portbench import run\n"
            "sys.exit(run.main(device='cpu'))\n").format(repo=str(ROOT), root=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


GEOM = Geometry(5512.0, 2048, 64, 32, 128, 200, 318.0, "file", 44100.0, True)


def test_the_reference_extraction_matches_the_port_cpu_path():
    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch.io.decode import DecodedAudio
    from lbaudiodetective_torch.ops.extract import extract_fingerprint_batch

    from portbench import gen

    audio = gen.brown_noise(11, 1, 3, 2 * 5512, "cpu")
    clips = [DecodedAudio(a.numpy(), 5512.0, 2 * 44100, 44100.0) for a in audio]
    pos, neg, n = extract_fingerprint_batch(clips, FingerprintConfig(), device="cpu")
    assert list(n) == [GEOM.n_sub(2 * 44100, 2 * 5512)] * 3
    ref = extract.fingerprints(audio, int(n[0]), GEOM)
    off = extract.pairs_off(torch.from_numpy(pos[:, :n[0]]), torch.from_numpy(neg[:, :n[0]]), *ref)
    assert float(off.max()) <= 0.01


def test_the_reference_scores_match_the_port_cpu_matcher():
    from lbaudiodetective_torch.ops.match_packed import match_one_vs_many_packed

    from portbench import gen

    pos_w, neg_w, counts = gen.random_words(5, 1, "cpu", 24, 12, 100, 3, 12)
    q_pos_w, q_neg_w, nq = gen.random_words(6, 1, "cpu", 3, 12, 100, 2, 12)
    port = match_one_vs_many_packed(q_pos_w, q_neg_w, nq, pos_w, neg_w, counts, 100)
    ref = match.scores(match.unpack(q_pos_w, 100), match.unpack(q_neg_w, 100), nq,
                       match.unpack(pos_w, 100), match.unpack(neg_w, 100), counts, 100)
    assert torch.allclose(port.double(), ref, atol=1e-6, rtol=0)
    low = match.scores(match.unpack(q_pos_w, 100), match.unpack(q_neg_w, 100), nq,
                       match.unpack(pos_w, 100), match.unpack(neg_w, 100), counts, 100,
                       dtype=torch.bfloat16)
    assert float((low - ref).abs().max()) > 1e-4


def test_packing_round_trips():
    planes = (np.random.default_rng(3).random((4, 7, 100)) < 0.5).astype(np.uint8)
    words = torch.from_numpy(match.pack(planes))
    assert torch.equal(match.unpack(words, 100), torch.from_numpy(planes))
