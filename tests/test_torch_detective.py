"""The port's AudioDetective vs the JAX package's on written WAV files, the
no-JAX import rule, and no silent CPU fallback for a CUDA detective."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_torch.io.wav import write_wav  # noqa: E402
from lbaudiodetective_torch.models.detective import AudioDetective  # noqa: E402
from tests._torch_common import bit_agreement, brown_noise, jax_fp, port_fp  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Three 44.1 kHz WAVs: a 4 s clip, a noisy copy of it, another clip."""
    d = tmp_path_factory.mktemp("wavs")
    sig = brown_noise(60, 2, 4 * 44100)
    sig = 0.5 * sig / np.abs(sig).max(axis=1, keepdims=True)
    noisy = sig[0] + 0.002 * np.random.default_rng(61).standard_normal(sig.shape[1])
    paths = {"a": d / "a.wav", "a_noisy": d / "a_noisy.wav", "b": d / "b.wav"}
    for p, x in zip(paths.values(), (sig[0], noisy, sig[1])):
        write_wav(str(p), x.astype(np.float32), 44100)
    return {k: str(v) for k, v in paths.items()}


def test_detective_matches_jax_detective(wavs):
    from lbaudiodetective_tpu.models.detective import AudioDetective as JaxDetective

    det, jdet = AudioDetective(device="cpu"), JaxDetective()
    fps, jfps = {}, {}
    for name, path in wavs.items():
        fps[name], jfps[name] = det.process_audio_file(path), jdet.process_audio_file(path)
        f, j = fps[name], jfps[name]
        assert f.num_subfingerprints == j.num_subfingerprints > 0
        assert bit_agreement(f.pos, f.neg, j.pos, j.neg) >= 0.999
    assert det.last_fingerprint == fps["b"]

    # Scores: the port's matcher on the JAX fingerprints (carried over as
    # numpy planes) equals JAX's within 1e-6; the end-to-end compare does too
    # where the fingerprints are equal.
    carried = {name: port_fp(j) for name, j in jfps.items()}
    for p1, p2 in (("a", "a_noisy"), ("a", "b")):
        jscore = jdet.compare_fingerprints(jfps[p1], jfps[p2])
        assert abs(det.compare_fingerprints(carried[p1], carried[p2]) - jscore) <= 1e-6
        score = det.compare_audio_files(wavs[p1], wavs[p2])
        if fps[p1] == carried[p1] and fps[p2] == carried[p2]:
            assert abs(score - jscore) <= 1e-6
    assert det.compare_audio_files(wavs["a"], wavs["a_noisy"]) > \
        det.compare_audio_files(wavs["a"], wavs["b"])

    names = ("b", "a_noisy", "a")
    got = det.match_against_library(carried["a"], [carried[n] for n in names])
    exp = jdet.match_against_library(jfps["a"], [jfps[n] for n in names])
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6)
    assert int(np.argmax(got)) == 2
    assert det.match_against_library(carried["a"], []).shape == (0,)

    batch = det.process_batch([wavs["a"], wavs["b"]])
    assert batch[0] == fps["a"] and batch[1] == fps["b"]


@pytest.mark.parametrize("comparison_range", [0, 37])
def test_match_against_library_equals_jax_on_ragged_entries(comparison_range):
    """The port's match_against_library (packed matcher) vs the JAX
    detective's (unpacked matcher) on ragged entries: empty, shorter than
    the query, equal to it, longer.  Tolerance 1e-6 (f32 sums, added in
    the same order)."""
    from lbaudiodetective_tpu.models.detective import AudioDetective as JaxDetective
    from lbaudiodetective_torch.models.fingerprint import Fingerprint
    from tests._torch_common import ragged_case

    q_pos, q_neg, nq, lib_pos, lib_neg, n_lib = ragged_case(41, 100, l=40)
    query = Fingerprint(q_pos[:nq], q_neg[:nq])
    library = [Fingerprint(p[:n], q[:n]) for p, q, n in zip(lib_pos, lib_neg, n_lib)]
    got = AudioDetective(device="cpu").match_against_library(query, library,
                                                             comparison_range)
    exp = JaxDetective().match_against_library(jax_fp(query), [jax_fp(f) for f in library],
                                               comparison_range)
    assert got.shape == (40,) and got.dtype == np.float32 and got[0] == 0.0
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6)


def test_detective_preferences_replace_config():
    det = AudioDetective(device="cpu")
    assert (det.processing_sample_rate, det.window_size, det.analysis_stride,
            det.number_of_pitch_steps, det.subfingerprint_length) == (5512.0, 2048, 64, 32, 200)
    det.analysis_stride = 32
    assert det.config.analysis_stride == 32
    with pytest.raises(ValueError):
        det.window_size = 2000


#: Imported in a fresh interpreter: every module of the port, then a CPU
#: extraction, a library match, the CLI's ``fingerprint`` on a written WAV and
#: the native decoder; neither JAX nor the JAX package may have been loaded.
NO_JAX_SCRIPT = """
import importlib, pkgutil, sys, numpy as np
import lbaudiodetective_torch
for m in pkgutil.walk_packages(lbaudiodetective_torch.__path__, "lbaudiodetective_torch."):
    importlib.import_module(m.name)
from lbaudiodetective_torch import AudioDetective, FingerprintConfig
from lbaudiodetective_torch.io.decode import DecodedAudio
from lbaudiodetective_torch.io.wav import write_wav
cfg = FingerprintConfig()
x = np.cumsum(np.random.default_rng(0).standard_normal(11024)).astype(np.float32)
clip = DecodedAudio(x * 0.005, 5512.0, 88200, 44100.0)
det = AudioDetective(cfg, device='cpu')
fp = det.process_decoded(clip)
assert fp.num_subfingerprints > 0
assert det.compare_fingerprints(fp, fp) == 1.0
import lbaudiodetective_torch.__main__ as cli
from lbaudiodetective_torch.models.library import FingerprintLibrary
assert lbaudiodetective_torch.FingerprintLibrary is FingerprintLibrary
lib = FingerprintLibrary.from_fingerprints([fp, fp], cfg, device='cpu')
assert lib.identify(fp) == (0, 1.0)
assert lib.search(fp, top_k=1, shortlist=1)[1][0] == 1.0
cli.build_parser().parse_args(['identify', 'x.wav', '--library', 'l.npz'])
y = np.cumsum(np.random.default_rng(1).standard_normal(3 * 44100)) * 0.001
write_wav('clip.wav', (0.5 * y / np.abs(y).max()).astype(np.float32), 44100)
assert cli.main(['fingerprint', 'clip.wav', '--device', 'cpu']) == 0
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lbaudiodetective_tpu'))
assert not bad, bad
print('NO_JAX_OK')
"""


def test_port_imports_no_jax(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", NO_JAX_SCRIPT], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "NO_JAX_OK" in proc.stdout, proc.stderr[-3000:]


def test_cuda_detective_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AudioDetective(device="cuda")


def test_process_decoded_batch_records_its_span_tree():
    """Inside ``recording()`` a batch is a ``detective.batch`` root over the
    padding, the copies, the launch and the wrapping, with the counts of
    each (the CPU takes a batch in one chunk, copied from pageable memory);
    the fingerprints are those of an unrecorded call."""
    from lbaudiodetective_torch.io.decode import DecodedAudio
    from lbaudiodetective_torch.ops.extract import (
        bucket_subfingerprints, required_padded_length, rows_for_subfingerprints)
    from lbaudiodetective_torch.utils import profiling

    det = AudioDetective(device="cpu")
    cfg = det.config
    sig = brown_noise(62, 3, 3 * 5512).astype(np.float32)
    lengths = (3 * 5512, 2 * 5512, 5512)
    clips = [DecodedAudio(x[:n], cfg.processing_sample_rate, n * 8, 44100.0)
             for x, n in zip(sig, lengths)]
    plain = det.process_decoded_batch(clips)
    with profiling.recording() as rec:
        fps = det.process_decoded_batch(clips)
    assert fps == plain
    spans = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["extract.pad", "extract.h2d", "extract.launch",
                                           "extract.d2h", "fingerprint.wrap", "detective.batch"]
    root = spans["detective.batch"]
    assert root.parent is None and root.attrs == {"clips": 3}
    for s in rec.spans[:-1]:
        assert s.parent == root.id and s.request == root.id and s.thread == root.thread
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    n_sub = max(cfg.num_subfingerprints(c.file_frames, c.proc_frames) for c in clips)
    n_rows = rows_for_subfingerprints(cfg, bucket_subfingerprints(n_sub))
    t_pad = required_padded_length(cfg, n_rows)
    one = {"chunk": 0, "chunks": 1}
    assert spans["extract.pad"].attrs == {"clips": 3, "samples_padded": 3 * t_pad,
                                          "samples_valid": sum(min(n, t_pad) for n in lengths),
                                          **one}
    assert spans["extract.h2d"].attrs == {"bytes": 3 * t_pad * 4, "pinned": False, **one}
    assert spans["extract.launch"].attrs == one
    assert spans["fingerprint.wrap"].attrs == {"clips": 3}


def test_chunked_batch_records_a_span_a_chunk(monkeypatch):
    """A batch in chunks records ``extract.pad``, ``extract.h2d`` and
    ``extract.launch`` a chunk, each with its ``chunk`` and the count
    ``chunks`` (``pinned`` False on the CPU), and one ``extract.d2h``; the
    chunks' counts add up to the batch's."""
    from lbaudiodetective_torch.io.decode import DecodedAudio
    from lbaudiodetective_torch.ops import extract
    from lbaudiodetective_torch.utils import profiling

    monkeypatch.setattr(extract, "_wave_clips", lambda route, n_tiles, device: 2)
    det = AudioDetective(device="cpu")
    cfg = det.config
    sig = brown_noise(63, 5, 2 * 5512).astype(np.float32)
    clips = [DecodedAudio(x[:n], cfg.processing_sample_rate, n * 8, 44100.0)
             for x, n in zip(sig, (2 * 5512, 5512, 2 * 5512, 3 * 2756, 5512))]
    with profiling.recording() as rec:
        det.process_decoded_batch(clips)
    names = [s.name for s in rec.spans]
    chunk = ["extract.pad", "extract.h2d", "extract.launch"]
    assert names == chunk * 3 + ["extract.d2h", "fingerprint.wrap", "detective.batch"]
    per_chunk = rec.spans[:9]
    assert [(s.attrs["chunk"], s.attrs["chunks"]) for s in per_chunk] == [
        (c, 3) for c in range(3) for _ in chunk]
    assert all(s.attrs["pinned"] is False for s in per_chunk if s.name == "extract.h2d")
    pads = [s for s in per_chunk if s.name == "extract.pad"]
    assert [s.attrs["clips"] for s in pads] == [2, 2, 1]
    assert sum(s.attrs["samples_valid"] for s in pads) == sum(c.samples.shape[0] for c in clips)
    h2d = [s.attrs["bytes"] for s in per_chunk if s.name == "extract.h2d"]
    assert h2d == [p.attrs["samples_padded"] * 4 for p in pads]
    assert "chunk" not in rec.spans[9].attrs
