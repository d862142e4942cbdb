"""The port's entry points run on the card unless the caller asks for the
CPU: each one's ``device`` defaults to ``"cuda"``, and without CUDA building
or calling one with that default raises ``RuntimeError`` (none falls back to
the CPU).  The CPU tests pass ``device="cpu"``."""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_torch import compat  # noqa: E402
from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.models.detective import AudioDetective  # noqa: E402
from lbaudiodetective_torch.models.fingerprint import Fingerprint  # noqa: E402
from lbaudiodetective_torch.models.library import FingerprintLibrary  # noqa: E402
from lbaudiodetective_torch.ops.extract import (  # noqa: E402
    FingerprintExtractor, extract_fingerprint, extract_fingerprint_batch, get_extractor)
from lbaudiodetective_torch.ops.match import match_fingerprints  # noqa: E402
from lbaudiodetective_torch.streaming import StreamingDetective, StreamingExtractor  # noqa: E402
from lbaudiodetective_torch.models import maa  # noqa: E402
from lbaudiodetective_torch.ops.match import (  # noqa: E402
    match_long_hierarchical, match_long_padded)
from lbaudiodetective_torch.serving import IdentificationService  # noqa: E402
from lbaudiodetective_torch.streaming import StreamingIdentifier  # noqa: E402
from lbaudiodetective_torch.streaming.incremental import (  # noqa: E402
    IncrementalLibraryMatcher, StreamSessionPool)
from lbaudiodetective_torch.parallel import distributed  # noqa: E402
from lbaudiodetective_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from lbaudiodetective_torch.parallel.mesh import make_mesh  # noqa: E402
from lbaudiodetective_torch.parallel.pipeline import PipelinedIdentifier  # noqa: E402
from tests._torch_common import synth_clip  # noqa: E402


def _fp(seed: int = 3, n: int = 6) -> Fingerprint:
    rng = np.random.default_rng(seed)
    cls = rng.choice(3, size=(n, 100))
    return Fingerprint((cls == 1).astype(np.uint8), (cls == 2).astype(np.uint8))


def _library_file(tmp_path) -> str:
    path = str(tmp_path / "lib.npz")
    FingerprintLibrary.from_fingerprints([_fp(), _fp(4)], device="cpu").save(path)
    return path


def _cpu_library() -> FingerprintLibrary:
    return FingerprintLibrary.from_fingerprints([_fp(), _fp(4)], device="cpu")


def _long_args():
    fp1, fp2 = _fp(5, 16), _fp(6, 4)
    return (fp1.pos, fp1.neg, 16, fp2.pos, fp2.neg, 4)


def _wav(tmp) -> str:
    from lbaudiodetective_torch.io.wav import write_wav

    path = str(tmp / "tone.wav")
    write_wav(path, np.sin(np.arange(44100) * 0.1).astype(np.float32), 44100)
    return path


#: name: (function whose ``device`` default is checked, a call with that default)
ENTRY_POINTS = {
    "AudioDetective": (AudioDetective, lambda tmp: AudioDetective()),
    "FingerprintExtractor": (FingerprintExtractor, lambda tmp: FingerprintExtractor()),
    "get_extractor": (get_extractor.__wrapped__, lambda tmp: get_extractor(FingerprintConfig())),
    "extract_fingerprint": (extract_fingerprint, lambda tmp: extract_fingerprint(
        synth_clip(5, 2.0, FingerprintConfig()), FingerprintConfig())),
    "extract_fingerprint_batch": (extract_fingerprint_batch, lambda tmp: extract_fingerprint_batch(
        [synth_clip(5, 2.0, FingerprintConfig())], FingerprintConfig())),
    "match_fingerprints": (match_fingerprints, lambda tmp: match_fingerprints(
        (_fp().pos, _fp().neg), (_fp(4).pos, _fp(4).neg))),
    "FingerprintLibrary.from_arrays": (FingerprintLibrary.from_arrays,
                                       lambda tmp: FingerprintLibrary.from_arrays(
                                           *(w[None] for w in _fp().packed()), np.array([6]), 100)),
    "FingerprintLibrary.from_fingerprints": (FingerprintLibrary.from_fingerprints,
                                             lambda tmp: FingerprintLibrary.from_fingerprints(
                                                 [_fp()])),
    "FingerprintLibrary.load": (FingerprintLibrary.load,
                                lambda tmp: FingerprintLibrary.load(_library_file(tmp))),
    "StreamingExtractor": (StreamingExtractor, lambda tmp: StreamingExtractor(batch=1)),
    "StreamingDetective": (StreamingDetective, lambda tmp: StreamingDetective()),
    "compat.LBAudioDetectiveNew": (compat.LBAudioDetectiveNew,
                                   lambda tmp: compat.LBAudioDetectiveNew()),
    "compat.LBAudioDetectiveFingerprintCompareToFingerprint": (
        compat.LBAudioDetectiveFingerprintCompareToFingerprint,
        lambda tmp: compat.LBAudioDetectiveFingerprintCompareToFingerprint(_fp(), _fp(4), 37)),
    "Fingerprint.compare": (Fingerprint.compare, lambda tmp: _fp().compare(_fp(4))),
    "IncrementalLibraryMatcher": (IncrementalLibraryMatcher, lambda tmp: IncrementalLibraryMatcher(
        _cpu_library(), batch=1)),
    "StreamSessionPool": (StreamSessionPool, lambda tmp: StreamSessionPool(_cpu_library())),
    "StreamingIdentifier": (StreamingIdentifier, lambda tmp: StreamingIdentifier(
        _cpu_library(), batch=1)),
    "IdentificationService": (IdentificationService, lambda tmp: IdentificationService(
        _cpu_library(), ["a", "b"])),
    "match_long_padded": (match_long_padded, lambda tmp: match_long_padded(
        *_long_args(), chunk=16)),
    "match_long_hierarchical": (match_long_hierarchical, lambda tmp: match_long_hierarchical(
        *_long_args())),
    "maa.maa_subfingerprints": (maa.maa_subfingerprints, lambda tmp: maa.maa_subfingerprints(
        np.zeros(2048, np.float32), 44100.0)),
    "maa.maa_match_count": (maa.maa_match_count, lambda tmp: maa.maa_match_count(
        np.zeros((3, 5)), np.zeros((2, 5)))),
    "maa.maa_fingerprint_file": (maa.maa_fingerprint_file, lambda tmp: maa.maa_fingerprint_file(
        _wav(tmp))),
    "maa.maa_compare_audio_files": (maa.maa_compare_audio_files,
                                    lambda tmp: maa.maa_compare_audio_files(_wav(tmp), _wav(tmp))),
    "parallel.make_mesh": (make_mesh, lambda tmp: make_mesh(2)),
    "parallel.PipelinedIdentifier": (PipelinedIdentifier, lambda tmp: PipelinedIdentifier(
        _fp().pos[None], _fp().neg[None], np.array([6]))),
    "parallel.distributed.initialize": (distributed.initialize,
                                        lambda tmp: distributed.initialize("h:1", 2, 0)),
    "parallel.dryrun_multichip": (dryrun_multichip, lambda tmp: dryrun_multichip(2)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name, tmp_path):
    fn, call = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return                                  # the default runs there
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(tmp_path)
