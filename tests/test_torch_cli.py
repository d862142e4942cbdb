"""The port's CLI (``python -m lbaudiodetective_torch``) vs the JAX
package's on WAV files written from a seed: enroll, then identify with
and without ``--top-k``, on the CPU (``--device cpu``).

Tolerance: the printed scores (rounded to 4 digits) within 1e-4 of the
JAX CLI's; the same track named."""

import json

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
