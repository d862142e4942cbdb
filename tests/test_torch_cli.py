"""The port's CLI (``python -m lbaudiodetective_torch``) vs the JAX
package's on WAV files written from a seed: enroll, then identify with
and without ``--top-k``; compare, also ``--algorithm maa``; ``dedup`` on
one slot and on a ring of CPU slots; ``serve``'s flags (``--shard-library``
too) and ``--sessions-dir``, and ``client``/``listen`` against a server in
a thread; on the CPU (``--device cpu``).

Tolerance: the printed scores (rounded to 4 digits) within 1e-4 of the
JAX CLI's; the same track named; MAA counts and server answers equal."""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_tpu.__main__ import main as jax_main  # noqa: E402
from lbaudiodetective_tpu.io.wav import write_wav  # noqa: E402
from lbaudiodetective_torch.__main__ import main  # noqa: E402
from tests._torch_common import brown_noise  # noqa: E402

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Three 3 s tracks in ``tracks/``, a second batch of one in ``more/``,
    and crops of tracks ``b`` and ``d`` that start near a subfingerprint
    boundary (128 rows of 8 samples at 5512 Hz: ~8192.7 samples at
    44.1 kHz)."""
    root = tmp_path_factory.mktemp("clips")
    sig = brown_noise(80, 4, 3 * 44100)
    sig = 0.5 * sig / np.abs(sig).max(axis=1, keepdims=True)
    (root / "tracks").mkdir()
    (root / "more").mkdir()
    for name, x in zip("abc", sig):
        write_wav(str(root / "tracks" / f"{name}.wav"), x, 44100)
    write_wav(str(root / "more" / "d.wav"), sig[3], 44100)
    write_wav(str(root / "crop_b.wav"), sig[1][16385:126000], 44100)
    write_wav(str(root / "crop_d.wav"), sig[3][8193:110000], 44100)
    return root


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_enroll_identify_equals_jax_cli(clips, tmp_path, capsys):
    lib, jlib = str(tmp_path / "lib"), str(tmp_path / "jlib.npz")
    assert main(["enroll", str(clips / "tracks"), "-o", lib, *CPU]) == 0
    assert (tmp_path / "lib.npz").exists()
    assert json.loads((tmp_path / "lib.names.json").read_text()) == ["a", "b", "c"]
    assert jax_main(["enroll", str(clips / "tracks"), "-o", jlib]) == 0
    capsys.readouterr()
    crop = str(clips / "crop_b.wav")
    for extra in ([], ["--all-scores"], ["--top-k", "2"]):
        assert main(["identify", crop, "--library", lib + ".npz", *extra, *CPU]) == 0
        got = last_json(capsys)
        assert jax_main(["identify", crop, "--library", jlib, *extra]) == 0
        exp = last_json(capsys)
        assert got["track"] == exp["track"] == "b"
        assert got["score"] == pytest.approx(exp["score"], abs=1e-4)
        assert set(got) == set(exp)
        if "scores" in exp:
            assert got["scores"] == pytest.approx(exp["scores"], abs=1e-4)
        if "top" in exp:
            assert [e["track"] for e in got["top"]] == [e["track"] for e in exp["top"]]
            assert [e["score"] for e in got["top"]] == pytest.approx(
                [e["score"] for e in exp["top"]], abs=1e-4)
    # Each CLI reads the other's library.
    assert main(["identify", crop, "--library", jlib, *CPU]) == 0
    assert last_json(capsys)["track"] == "b"
    assert jax_main(["identify", crop, "--library", lib + ".npz"]) == 0
    assert last_json(capsys)["track"] == "b"


def test_enroll_append_grows_library_and_sidecar(clips, tmp_path, capsys):
    lib = str(tmp_path / "lib.npz")
    assert main(["enroll", str(clips / "tracks"), "-o", lib, *CPU]) == 0
    assert main(["enroll", str(clips / "more"), "-o", lib, "--append", *CPU]) == 0
    assert json.loads((tmp_path / "lib.names.json").read_text()) == ["a", "b", "c", "d"]
    capsys.readouterr()
    assert main(["identify", str(clips / "crop_d.wav"), "--library", lib,
                 "--all-scores", *CPU]) == 0
    out = last_json(capsys)
    assert out["track"] == "d" and set(out["scores"]) == {"a", "b", "c", "d"}
    assert main(["identify", str(clips / "crop_d.wav"), "--library", lib,
                 "--top-k", "9", *CPU]) == 0
    out = last_json(capsys)
    assert out["track"] == "d" and len(out["top"]) == 4


def test_fingerprint_compare_and_refusals(clips, tmp_path, capsys):
    a = str(clips / "tracks" / "a.wav")
    assert main(["fingerprint", a, *CPU]) == 0
    s = capsys.readouterr().out.strip()
    assert set(s) <= {"0", "1", "+"} and s.count("+") > 0
    assert main(["compare", a, a, *CPU]) == 0
    assert capsys.readouterr().out.strip() == "1.0000"
    assert main(["enroll", str(tmp_path), "-o", str(tmp_path / "x.npz"), *CPU]) == 2
    assert main(["identify", a, "--library", "unused.npz", "--top-k", "-1", *CPU]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["compare", a, a])               # the default device is cuda


def test_compare_maa_equals_jax_cli(clips, capsys):
    a, crop = str(clips / "tracks" / "b.wav"), str(clips / "crop_b.wav")
    assert main(["compare", a, crop, "--algorithm", "maa", *CPU]) == 0
    got = capsys.readouterr().out.strip()
    assert jax_main(["compare", a, crop, "--algorithm", "maa"]) == 0
    assert got == capsys.readouterr().out.strip()
    assert int(got) >= 0
    assert main(["compare", a, a, "--algorithm", "afa", *CPU]) == 0
    assert capsys.readouterr().out.strip() == "1.0000"


def test_serve_flags_reach_service(clips, tmp_path, monkeypatch):
    from lbaudiodetective_torch import serving

    lib = str(tmp_path / "lib.npz")
    assert main(["enroll", str(clips / "tracks"), "-o", lib, *CPU]) == 0
    captured = {}

    def fake_serve_forever(service, host="0.0.0.0", port=8080):
        captured.update(svc=service, host=host, port=port)

    monkeypatch.setattr(serving, "serve_forever", fake_serve_forever)
    assert main(["serve", "--library", lib, "--port", "9999", "--batch-window", "0.25",
                 "--max-batch", "4", "--n-sub-cap", "48", "--search-threshold", "2",
                 "--top-k", "3", "--stream-pool", "--stream-flush-window", "0.1", *CPU]) == 0
    svc = captured["svc"]
    assert captured["port"] == 9999 and svc.names == ["a", "b", "c"]
    assert (svc.batch_window_s, svc.max_batch, svc.n_sub_cap) == (0.25, 4, 48)
    assert (svc.search_threshold, svc.top_k) == (2, 3)
    assert svc.stream_pool and svc.stream_flush_window_s == 0.1
    assert svc.device == torch.device("cpu")
    assert main(["serve", "--library", lib, "--shard-library", "2", "--search-threshold",
                 "2", *CPU]) == 0                      # boots on a 2-way sharded library
    sharded = captured["svc"]
    assert sharded.library.mesh.shape == {"data": 1, "library": 2}
    assert len(sharded.library) == 3 and sharded.device == torch.device("cpu")
    plain = serving.IdentificationService(svc.library, svc.names, search_threshold=2,
                                          device="cpu")
    payload = (clips / "crop_b.wav").read_bytes()
    assert sharded.identify(payload) == plain.identify(payload)
    assert sharded.identify(payload)["track"] == "b"


def test_dedup_equals_jax_cli(clips, tmp_path, capsys):
    """``dedup`` on the port's library file: equal candidates and scores to
    the JAX CLI's on one slot, and the same on a ring of 2 and 3 CPU slots
    (3 pads the library axis)."""
    lib = str(tmp_path / "lib.npz")
    assert main(["enroll", str(clips / "tracks"), "-o", lib, *CPU]) == 0
    assert main(["enroll", str(clips / "more"), "-o", lib, "--append", *CPU]) == 0
    capsys.readouterr()
    outs = {}
    for devices in ("1", "2", "3"):
        assert main(["dedup", "--library", lib, "--top-k", "2", "--compact",
                     "--devices", devices, *CPU]) == 0
        outs[devices] = last_json(capsys)
    assert jax_main(["dedup", "--library", lib, "--top-k", "2", "--compact"]) == 0
    ref = last_json(capsys)
    assert outs["1"] == outs["2"] == outs["3"] == ref
    assert [e["track"] for e in ref] == ["a", "b", "c", "d"]
    assert all(len(e["candidates"]) == 2 for e in ref)
    assert main(["dedup", "--library", lib, "--threshold", "2", *CPU]) == 0
    assert json.loads(capsys.readouterr().out) == []
    assert main(["dedup", "--library", lib, "--top-k", "0", *CPU]) == 2
    assert main(["dedup", "--library", lib, "--devices", "0", *CPU]) == 2


def test_serve_sessions_dir_roundtrip(clips, tmp_path, monkeypatch):
    from lbaudiodetective_torch import serving

    lib = str(tmp_path / "lib.npz")
    assert main(["enroll", str(clips / "tracks"), "-o", lib, *CPU]) == 0
    sess_dir = str(tmp_path / "sessions")
    state = {}

    def serve_and_open(service, host="0.0.0.0", port=8080):
        state["sid"] = service.stream_open()["session"]
        service.stream_update(state["sid"], ("01" * 100).encode())

    def serve_and_check(service, host="0.0.0.0", port=8080):
        state["n"] = service._sessions[state["sid"]]["m"].n

    monkeypatch.setattr(serving, "serve_forever", serve_and_open)
    assert main(["serve", "--library", lib, "--sessions-dir", sess_dir, *CPU]) == 0
    monkeypatch.setattr(serving, "serve_forever", serve_and_check)
    assert main(["serve", "--library", lib, "--sessions-dir", sess_dir, *CPU]) == 0
    assert state["n"] == 1


def test_client_and_listen_against_a_server(clips, tmp_path, capsys):
    """The port's client and listen, and the JAX package's client, against
    the port's server in a thread: equal answers, the streamed result equal
    to the one-shot identification."""
    from lbaudiodetective_torch.__main__ import _load_library
    from lbaudiodetective_torch.serving import IdentificationService, make_server

    lib_path = str(tmp_path / "lib.npz")
    assert main(["enroll", str(clips / "tracks"), "-o", lib_path, *CPU]) == 0
    srv = make_server(IdentificationService(*_load_library(lib_path, "cpu"), device="cpu"))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    crop = str(clips / "crop_b.wav")
    try:
        capsys.readouterr()
        assert main(["client", crop, "--url", url, *CPU]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["track"] == "b" and set(out["scores"]) == {"a", "b", "c"}
        assert jax_main(["client", crop, "--url", url]) == 0
        assert json.loads(capsys.readouterr().out) == out
        assert main(["client", crop, "--url", url, "--fingerprint", *CPU]) == 0
        fp = json.loads(capsys.readouterr().out)
        assert fp["n"] > 0 and set(fp["fingerprint"]) <= {"0", "1", "+"}
        assert main(["client", crop, "--url", url, "--local-extract", *CPU]) == 0
        assert json.loads(capsys.readouterr().out) == out
        assert main(["listen", crop, "--url", url, "--chunk", "3", *CPU]) == 0
        streamed = json.loads(capsys.readouterr().out)
        assert streamed["track"] == "b" and streamed["score"] == out["score"]
        assert streamed["n"] == fp["n"]
        assert main(["client", crop, "--url", url + "/nope", *CPU]) == 1
        for cmd in ("client", "listen"):
            assert main([cmd, crop, "--url", "http://127.0.0.1:1", "--timeout", "2",
                         *CPU]) == 2
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
