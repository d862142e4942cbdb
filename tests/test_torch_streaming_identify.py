"""The port's streaming identifier (``streaming/identify.py``) vs the JAX
package's on the CPU, on seeded synthetic audio (the corpus is absent).

Four streams of 3 s are fed in 1,024-sample chunks (the aligned step)
against a library of 5 %-flipped copies of their offline fingerprints and
seeded distractors.  After every chunk the running winners and scores of
the port's ``rematch="full"`` (the packed matcher: one call for all
streams) and ``"incremental"`` (running diagonal sums) modes equal each
other and the JAX package's ``StreamingIdentifier`` in both modes, bit for
bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_tpu.config import FingerprintConfig as JaxConfig  # noqa: E402
from lbaudiodetective_tpu.models.library import FingerprintLibrary as JaxLibrary  # noqa: E402
from lbaudiodetective_tpu.streaming import StreamingIdentifier as JaxIdentifier  # noqa: E402
from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.io.decode import DecodedAudio  # noqa: E402
from lbaudiodetective_torch.models.fingerprint import Fingerprint  # noqa: E402
from lbaudiodetective_torch.models.library import FingerprintLibrary  # noqa: E402
from lbaudiodetective_torch.ops.extract import extract_fingerprint_batch  # noqa: E402
from lbaudiodetective_torch.streaming import StreamingIdentifier, StreamMatch  # noqa: E402
from tests._torch_common import brown_noise, jax_fp  # noqa: E402

B = 4
CHUNK = 1024
SECONDS = 3.0
#: Library entry of stream b (the rest are distractors).
PLANTED = [5, 0, 9, 3]


@pytest.fixture(scope="module")
def case():
    cfg = FingerprintConfig()
    n = int(SECONDS * cfg.processing_sample_rate)
    audio = brown_noise(21, 12, n)
    clips = [DecodedAudio(a, cfg.processing_sample_rate, int(SECONDS * cfg.file_sample_rate),
                          cfg.file_sample_rate) for a in audio]
    pos, neg, ns = extract_fingerprint_batch(clips, cfg, device="cpu")
    rng = np.random.default_rng(4)
    entries = []
    for i in range(len(clips)):
        p, q = pos[i, :ns[i]], neg[i, :ns[i]]
        flips = rng.random(p.shape) < 0.05
        p = np.where(flips, 1 - p, p).astype(np.uint8)
        entries.append(Fingerprint(p, (q * (1 - p)).astype(np.uint8)))
    others = iter(entries[B:])                   # stream b's copy at PLANTED[b]
    entries = [entries[PLANTED.index(i)] if i in PLANTED else next(others)
               for i in range(len(clips))]
    lib = FingerprintLibrary.from_fingerprints(entries, cfg, device="cpu")
    jlib = JaxLibrary.from_fingerprints([jax_fp(f) for f in entries], JaxConfig())
    return lib, jlib, audio[:B]


def _run(ident, audio):
    """Per-chunk (track, score, n) histories, then the finalized winners."""
    hist = []
    for s in range(audio.shape[1] // CHUNK):
        ident.feed(np.ascontiguousarray(audio[:, s * CHUNK:(s + 1) * CHUNK]))
        hist.append([(m.track, m.score, m.n_subfingerprints) for m in ident.best()])
    hist.append([(m.track, m.score, m.n_subfingerprints) for m in ident.finalize()])
    return hist


@pytest.fixture(scope="module")
def histories(case):
    lib, jlib, audio = case
    port = {mode: _run(StreamingIdentifier(lib, B, CHUNK, match_every=4, rematch=mode,
                                           match_stream_group=2, n_cap=4, device="cpu"),
                       audio)
            for mode in ("full", "incremental")}
    jax = {mode: _run(JaxIdentifier(jlib, B, CHUNK, JaxConfig(), match_every=4, rematch=mode,
                                    match_stream_group=2, n_cap=4), audio)
           for mode in ("full", "incremental")}
    return port, jax


@pytest.mark.parametrize("mode", ["full", "incremental"])
def test_port_modes_equal_jax_identifier_every_chunk(histories, mode):
    port, jax = histories
    assert port[mode] == jax[mode]
    assert port[mode] == port["full"]


def test_streams_name_their_tracks(histories):
    port, _ = histories
    final = port["incremental"][-1]
    assert [t for t, _, _ in final] == PLANTED
    assert all(0.8 < s < 1.0 for _, s, _ in final)     # flipped copies: below 1
    assert len({n for _, _, n in final}) == 1 and final[0][2] > 8
    assert port["full"][0] == [(-1, 0.0, 0)] * B       # no match before 4 subs


def test_full_mode_scores_equal_the_library_on_the_streamed_fingerprints(case):
    lib, _, audio = case
    ident = StreamingIdentifier(lib, B, CHUNK, device="cpu")
    _run(ident, audio)
    fps = ident.extractor.fingerprints()
    scores = lib.match_many(fps)               # 3 s streams fit the library's rows
    best = scores.argmax(axis=1)
    assert [(m.track, m.score) for m in ident.best()] == [
        (int(i), float(scores[b, i])) for b, i in enumerate(best)]


def test_identifier_refuses_bad_arguments(case):
    lib, _, _ = case
    with pytest.raises(ValueError, match="rematch"):
        StreamingIdentifier(lib, B, rematch="sometimes", device="cpu")
    with pytest.raises(ValueError, match="divide"):
        StreamingIdentifier(lib, B, match_stream_group=3, device="cpu")
    with pytest.raises(ValueError, match="not on meta"):
        StreamingIdentifier(lib, B, device="meta")
    assert StreamMatch(-1, 0.0, 0).track == -1
