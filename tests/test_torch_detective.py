"""The port's AudioDetective vs the JAX package's on written WAV files, the
no-JAX import rule, and no silent CPU fallback for a CUDA detective."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_tpu.io.wav import write_wav  # noqa: E402
from lbaudiodetective_torch.models.detective import AudioDetective  # noqa: E402
from tests._torch_common import bit_agreement, brown_noise  # noqa: E402

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

    # Scores: the port's matcher on the JAX fingerprints equals JAX's within
    # 1e-6; the end-to-end compare does too where the fingerprints are equal.
    for p1, p2 in (("a", "a_noisy"), ("a", "b")):
        jscore = jdet.compare_fingerprints(jfps[p1], jfps[p2])
        assert abs(det.compare_fingerprints(jfps[p1], jfps[p2]) - jscore) <= 1e-6
        score = det.compare_audio_files(wavs[p1], wavs[p2])
        if fps[p1] == jfps[p1] and fps[p2] == jfps[p2]:
            assert abs(score - jscore) <= 1e-6
    assert det.compare_audio_files(wavs["a"], wavs["a_noisy"]) > \
        det.compare_audio_files(wavs["a"], wavs["b"])

    library = [jfps["b"], jfps["a_noisy"], jfps["a"]]
    got = det.match_against_library(jfps["a"], library)
    exp = jdet.match_against_library(jfps["a"], library)
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6)
    assert int(np.argmax(got)) == 2
    assert det.match_against_library(jfps["a"], []).shape == (0,)

    batch = det.process_batch([wavs["a"], wavs["b"]])
    assert batch[0] == fps["a"] and batch[1] == fps["b"]


@pytest.mark.parametrize("comparison_range", [0, 37])
def test_match_against_library_equals_jax_on_ragged_entries(comparison_range):
    """The port's match_against_library (packed matcher) vs the JAX
    detective's (unpacked matcher) on ragged entries: empty, shorter than
    the query, equal to it, longer.  Tolerance 1e-6 (f32 sums, added in
    the same order)."""
    from lbaudiodetective_tpu.models.detective import AudioDetective as JaxDetective
    from lbaudiodetective_tpu.models.fingerprint import Fingerprint
    from tests._torch_common import ragged_case

    q_pos, q_neg, nq, lib_pos, lib_neg, n_lib = ragged_case(41, 100, l=40)
    query = Fingerprint(q_pos[:nq], q_neg[:nq])
    library = [Fingerprint(p[:n], q[:n]) for p, q, n in zip(lib_pos, lib_neg, n_lib)]
    got = AudioDetective(device="cpu").match_against_library(query, library,
                                                             comparison_range)
    exp = JaxDetective().match_against_library(query, library, comparison_range)
    assert got.shape == (40,) and got.dtype == np.float32 and got[0] == 0.0
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6)


def test_detective_preferences_replace_config():
    det = AudioDetective()
    assert (det.processing_sample_rate, det.window_size, det.analysis_stride,
            det.number_of_pitch_steps, det.subfingerprint_length) == (5512.0, 2048, 64, 32, 200)
    det.analysis_stride = 32
    assert det.config.analysis_stride == 32
    with pytest.raises(ValueError):
        det.window_size = 2000


def test_port_imports_no_jax(tmp_path):
    script = (
        "import sys, numpy as np\n"
        "import lbaudiodetective_torch\n"
        "from lbaudiodetective_torch import AudioDetective, FingerprintConfig\n"
        "from lbaudiodetective_tpu.io.decode import DecodedAudio\n"
        "cfg = FingerprintConfig()\n"
        "x = np.cumsum(np.random.default_rng(0).standard_normal(11024)).astype(np.float32)\n"
        "clip = DecodedAudio(x * 0.005, 5512.0, 88200, 44100.0)\n"
        "det = AudioDetective(cfg, device='cpu')\n"
        "fp = det.process_decoded(clip)\n"
        "assert fp.num_subfingerprints > 0\n"
        "assert det.compare_fingerprints(fp, fp) == 1.0\n"
        "import lbaudiodetective_torch.__main__ as cli\n"
        "from lbaudiodetective_torch.ops import match_packed\n"
        "from lbaudiodetective_torch.models.library import FingerprintLibrary\n"
        "assert lbaudiodetective_torch.FingerprintLibrary is FingerprintLibrary\n"
        "lib = FingerprintLibrary.from_fingerprints([fp, fp], cfg)\n"
        "assert lib.identify(fp) == (0, 1.0)\n"
        "assert lib.search(fp, top_k=1, shortlist=1)[1][0] == 1.0\n"
        "cli.build_parser().parse_args(['identify', 'x.wav', '--library', 'l.npz'])\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "NO_JAX_OK" in proc.stdout, proc.stderr[-3000:]


def test_cuda_detective_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AudioDetective(device="cuda")
