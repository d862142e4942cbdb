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
from tests._torch_common import synth_clip  # noqa: E402


def _fp(seed: int = 3, n: int = 6) -> Fingerprint:
    rng = np.random.default_rng(seed)
    cls = rng.choice(3, size=(n, 100))
    return Fingerprint((cls == 1).astype(np.uint8), (cls == 2).astype(np.uint8))


def _library_file(tmp_path) -> str:
    path = str(tmp_path / "lib.npz")
    FingerprintLibrary.from_fingerprints([_fp(), _fp(4)], device="cpu").save(path)
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
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name, tmp_path):
    fn, call = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return                                  # the default runs there
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(tmp_path)
