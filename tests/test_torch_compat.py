"""The port's C-API name layer (``lbaudiodetective_torch/compat.py``) against
the JAX package's (``lbaudiodetective_tpu/compat.py``) on the CPU: the same
public names, setters that round-trip, fingerprints of written WAVs at the
default config and after the setters that reach the band-rows kernel's
geometries on CUDA (>= 99.9 % of bits), scores within 1e-6, container and
frame functions equal, and the streaming names on the port's
StreamingDetective."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_tpu import compat as jax_compat  # noqa: E402
from lbaudiodetective_torch import compat  # noqa: E402
from lbaudiodetective_torch.io.wav import write_wav  # noqa: E402
from lbaudiodetective_torch.streaming import StreamingDetective  # noqa: E402
from tests._torch_common import bit_agreement, brown_noise, jax_fp, port_fp  # noqa: E402

PUBLIC = re.compile(r"^(LBAudioDetective|kLBAudioDetective|stringFromFingerprint)")
SETTERS = {"default": (), "pitch_16": (("SetNumberOfPitchSteps", 16),),
           "length_300": (("SetSubfingerprintLength", 300),),
           "stride_32": (("SetAnalysisStride", 32),)}


def _wavs(tmp_path, seconds=5.0):
    sig = brown_noise(41, 2, int(seconds * 44100))
    sig = 0.5 * sig / np.abs(sig).max(axis=1, keepdims=True)
    sig[1] = sig[0] + 0.01 * np.random.default_rng(42).standard_normal(sig.shape[1])
    paths = [str(tmp_path / f"clip{i}.wav") for i in range(2)]
    for p, x in zip(paths, sig):
        write_wav(p, x.astype(np.float32), 44100)
    return paths


def _detectives(setters):
    port, ref = compat.LBAudioDetectiveNew(device="cpu"), jax_compat.LBAudioDetectiveNew()
    for name, value in setters:
        getattr(compat, "LBAudioDetective" + name)(port, value)
        getattr(jax_compat, "LBAudioDetective" + name)(ref, value)
    return port, ref


def test_every_public_name_of_the_jax_module():
    names = {n for n in vars(jax_compat) if PUBLIC.match(n)}
    assert len(names) >= 50
    missing = sorted(n for n in names if not hasattr(compat, n))
    assert not missing, missing
    for n in names:
        if n.startswith("k"):
            assert getattr(compat, n) == getattr(jax_compat, n), n


def test_device_is_explicit_and_cuda_by_default():
    d = compat.LBAudioDetectiveNew(device="cpu")
    assert d.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            compat.LBAudioDetectiveNew()
        fp = compat.LBAudioDetectiveFingerprintNew(2)
        with pytest.raises(RuntimeError, match="CUDA"):
            compat.LBAudioDetectiveFingerprintCompareToFingerprint(fp, fp, 2)


def test_setters_round_trip():
    d = compat.LBAudioDetectiveNew(device="cpu")
    for name, value in (("ProcessingSampleRate", 8000.0), ("NumberOfPitchSteps", 16),
                        ("SubfingerprintLength", 300), ("WindowSize", 1024),
                        ("AnalysisStride", 32), ("RecordingSampleRate", 48000.0)):
        getattr(compat, "LBAudioDetectiveSet" + name)(d, value)
        assert getattr(compat, "LBAudioDetectiveGet" + name)(d) == value
    assert d.config.pitch_step_count == 16 and d.config.subfingerprint_length == 300
    with pytest.raises(Exception):
        compat.LBAudioDetectiveSetWindowSize(d, 1000)
    assert compat.LBAudioDetectiveDefaultProcessingSampleRate() == 5512.0
    assert (compat.LBAudioDetectiveDefaultProcessingFormat()
            == jax_compat.LBAudioDetectiveDefaultProcessingFormat())
    assert (compat.LBAudioDetectiveDefaultRecordingFormat()
            == jax_compat.LBAudioDetectiveDefaultRecordingFormat())


@pytest.mark.parametrize("case", sorted(SETTERS))
def test_process_and_compare_urls_match_jax(case, tmp_path):
    a, b = _wavs(tmp_path)
    port, ref = _detectives(SETTERS[case])
    assert compat.LBAudioDetectiveGetFingerprint(port) is None
    fp = compat.LBAudioDetectiveProcessAudioURL(port, a)
    jfp = jax_compat.LBAudioDetectiveProcessAudioURL(ref, a)
    assert compat.LBAudioDetectiveGetFingerprint(port) == fp
    assert fp.num_subfingerprints == jfp.num_subfingerprints > 0
    assert fp.subfingerprint_length == jfp.subfingerprint_length
    assert bit_agreement(fp.pos, fp.neg, jfp.pos, jfp.neg) >= 0.999
    score = compat.LBAudioDetectiveCompareAudioURLs(port, a, b)
    fb = compat.LBAudioDetectiveGetFingerprint(port)
    jscore = jax_compat.LBAudioDetectiveCompareAudioURLs(ref, a, b)
    jfb = jax_compat.LBAudioDetectiveGetFingerprint(ref)
    assert bit_agreement(fb.pos, fb.neg, jfb.pos, jfb.neg) >= 0.999
    # Range 0 compares whole subfingerprints; on the same fingerprints
    # (carried over as numpy planes) the JAX package's matcher gives the same
    # score.
    jax_a, jax_b = jax_fp(fp), jax_fp(fb)
    same = jax_compat.LBAudioDetectiveFingerprintCompareToFingerprint(
        jax_a, jax_b, fp.subfingerprint_length)
    assert 0.0 < score <= 1.0 and abs(score - same) <= 1e-6
    if fp == port_fp(jfp) and fb == port_fp(jfb):
        assert abs(score - jscore) <= 1e-6
    # The raw compare on the same fingerprints (range 0 compares nothing).
    for rng in (0, 100, 37):
        got = compat.LBAudioDetectiveFingerprintCompareToFingerprint(fp, fb, rng, device="cpu")
        exp = jax_compat.LBAudioDetectiveFingerprintCompareToFingerprint(jax_a, jax_b, rng)
        assert abs(got - exp) <= 1e-6
    with pytest.raises(Exception):
        compat.LBAudioDetectiveProcessAudioURL(port, None)


def test_container_functions_equal_jax():
    rng = np.random.default_rng(43)
    subs = [rng.integers(0, 2, 12).astype(np.uint8) for _ in range(3)]
    built = []
    for mod in (compat, jax_compat):
        fp = mod.LBAudioDetectiveFingerprintNew(0)
        assert mod.LBAudioDetectiveFingerprintSetSubfingerprintLength(fp, 10) == (True, 10)
        for s in subs:
            mod.LBAudioDetectiveFingerprintAddSubfingerprint(fp, s)
        assert mod.LBAudioDetectiveFingerprintSetSubfingerprintLength(fp, 8) == (False, 10)
        built.append(fp)
    p, j = built
    assert compat.stringFromFingerprint(p) == jax_compat.stringFromFingerprint(j)
    assert compat.LBAudioDetectiveFingerprintGetNumberOfSubfingerprints(p) == 3
    assert compat.LBAudioDetectiveFingerprintGetSubfingerprintLength(p) == 10
    for i in range(3):
        np.testing.assert_array_equal(
            compat.LBAudioDetectiveFingerprintGetSubfingerprintAtIndex(p, i),
            jax_compat.LBAudioDetectiveFingerprintGetSubfingerprintAtIndex(j, i))
    assert (compat.LBAudioDetectiveFingerprintCompareSubfingerprints(p, subs[0], subs[1], 10)
            == jax_compat.LBAudioDetectiveFingerprintCompareSubfingerprints(
                j, subs[0], subs[1], 10))
    frozen = p.freeze()
    assert compat.LBAudioDetectiveFingerprintEqualToFingerprint(
        compat.LBAudioDetectiveFingerprintCopy(frozen), frozen)
    compat.LBAudioDetectiveFingerprintDispose(p)
    compat.LBAudioDetectiveFingerprintDispose(None)
    assert compat.LBAudioDetectiveFingerprintGetNumberOfSubfingerprints(p) == 0
    with pytest.raises(Exception):
        compat.LBAudioDetectiveFingerprintAddSubfingerprint(frozen, subs[0])


def test_frame_functions_equal_jax():
    rng = np.random.default_rng(44)
    rows = rng.standard_normal((4, 8)).astype(np.float32)
    frames = []
    for mod in (compat, jax_compat):
        f = mod.LBAudioDetectiveFrameNew(4)
        for i, row in enumerate(rows):
            assert mod.LBAudioDetectiveFrameSetRow(f, row, i, 8)
        assert mod.LBAudioDetectiveFrameFull(f)
        frames.append(f)
    p, j = frames
    assert compat.LBAudioDetectiveFrameEqualToFrame(compat.LBAudioDetectiveFrameCopy(p), p)
    np.testing.assert_array_equal(compat.LBAudioDetectiveFrameGetRow(p, 2),
                                  jax_compat.LBAudioDetectiveFrameGetRow(j, 2))
    assert compat.LBAudioDetectiveFrameGetValue(p, 1, 3) == rows[1, 3]
    assert (compat.LBAudioDetectiveFrameFingerprintLength(p)
            == jax_compat.LBAudioDetectiveFrameFingerprintLength(j))
    assert (compat.LBAudioDetectiveFrameFingerprintSize(p)
            == jax_compat.LBAudioDetectiveFrameFingerprintSize(j))
    compat.LBAudioDetectiveFrameDecompose(p)
    jax_compat.LBAudioDetectiveFrameDecompose(j)
    np.testing.assert_array_equal(compat.LBAudioDetectiveFrameExtractFingerprint(p, 5),
                                  jax_compat.LBAudioDetectiveFrameExtractFingerprint(j, 5))
    compat.LBAudioDetectiveFrameDispose(p)
    compat.LBAudioDetectiveFrameDispose(None)
    assert compat.LBAudioDetectiveFrameGetNumberOfRows(p) == 0


def test_streaming_names_drive_the_port():
    det = StreamingDetective(chunk_size=1024, device="cpu")
    done = []
    compat.LBAudioDetectiveProcess(det, 1, done.append)
    rng = np.random.default_rng(80)
    det.process_samples((rng.standard_normal(2048) * 0.1).astype(np.float32))
    assert not done
    compat.LBAudioDetectivePauseProcessing(det)
    det.process_samples(np.zeros(8192, np.float32))       # ignored while paused
    compat.LBAudioDetectiveResumeProcessing(det)
    det.process_samples((rng.standard_normal(4096) * 0.1).astype(np.float32))
    assert len(done) == 1
    fp = compat.LBAudioDetectiveStopProcessing(det)
    assert fp.num_subfingerprints >= 1 and fp == done[0]
    compat.LBAudioDetectiveStartProcessing(det, 2)
    det.process_samples((rng.standard_normal(8192) * 0.1).astype(np.float32))
    assert compat.LBAudioDetectiveStopProcessing(det).num_subfingerprints == 2


def test_compat_and_streaming_import_no_jax():
    """The C-API layer and the streaming runtime run without JAX (the card's
    host has none): a fresh interpreter drives both, with a frame, a
    fingerprint container and a written WAV through the native decoder, and
    finds neither JAX nor the JAX package in ``sys.modules``."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    script = (
        "import sys, tempfile, numpy as np\n"
        "from lbaudiodetective_torch import compat, StreamingExtractor, FingerprintConfig\n"
        "from lbaudiodetective_torch.io.wav import write_wav\n"
        "f = compat.LBAudioDetectiveFrameNew(2)\n"
        "compat.LBAudioDetectiveFrameSetRow(f, np.ones(4, np.float32), 0, 4)\n"
        "c = compat.LBAudioDetectiveFingerprintNew(4)\n"
        "compat.LBAudioDetectiveFingerprintAddSubfingerprint(c, np.ones(4, np.uint8))\n"
        "d = compat.LBAudioDetectiveNew(device='cpu')\n"
        "compat.LBAudioDetectiveSetNumberOfPitchSteps(d, 16)\n"
        "ext = StreamingExtractor(2, 1024, FingerprintConfig(integer_hop=False), 'cpu')\n"
        "x = np.cumsum(np.random.default_rng(0).standard_normal((2, 4096)), 1) * 0.005\n"
        "[ext.feed(x[:, i:i + 1024].astype(np.float32)) for i in range(0, 4096, 1024)]\n"
        "assert ext.fingerprints()[0].num_subfingerprints == 2\n"
        "path = tempfile.mkdtemp() + '/a.wav'\n"
        "y = np.cumsum(np.random.default_rng(1).standard_normal(3 * 44100)) * 0.001\n"
        "write_wav(path, (0.5 * y / np.abs(y).max()).astype(np.float32), 44100)\n"
        "assert compat.LBAudioDetectiveProcessAudioURL(d, path).num_subfingerprints > 0\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'lbaudiodetective_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(repo)] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and "NO_JAX_OK" in out.stdout, out.stderr[-2000:]
