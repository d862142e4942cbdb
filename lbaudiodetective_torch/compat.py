"""C-API name layer: the reference's public functions under their own names
(port of the JAX package's ``compat.py``), on this package's
:class:`AudioDetective` and :class:`StreamingDetective`.

Every public name of the JAX package's module is here.  Out-parameters
become return values; OSStatus codes become the typed exceptions of
``lbaudiodetective_torch.errors``.  A function that runs device code and takes
no detective (``LBAudioDetectiveNew`` and
``LBAudioDetectiveFingerprintCompareToFingerprint``) takes a keyword-only
``device``, ``"cuda"`` by default as the port's CLI; it raises when CUDA is
absent and never falls back to the CPU.  A detective carries its own device.  The container and frame
functions are host code (NumPy), copies of the JAX package's.

    detective = LBAudioDetectiveNew()                  # on CUDA
    match = LBAudioDetectiveCompareAudioURLs(detective, url1, url2, 0)
    LBAudioDetectiveDispose(detective)
"""

from __future__ import annotations

import numpy as np
import torch

from lbaudiodetective_torch.config import (
    DEFAULT_ANALYSIS_STRIDE,
    DEFAULT_PITCH_STEP_COUNT,
    DEFAULT_PROCESSING_SAMPLE_RATE,
    DEFAULT_ROWS_PER_FRAME,
    DEFAULT_SUBFINGERPRINT_LENGTH,
    DEFAULT_WINDOW_SIZE,
)
from lbaudiodetective_torch.device import DEFAULT_DEVICE, resolve_device
from lbaudiodetective_torch.errors import InvalidArgumentError
from lbaudiodetective_torch.models.fingerprint import (
    Fingerprint, FingerprintBuilder, compare_subfingerprint_booleans)
from lbaudiodetective_torch.models.frame import Frame
from lbaudiodetective_torch.models.detective import AudioDetective
from lbaudiodetective_torch.ops.match import match_fingerprints

# Constants (LBAudioDetective.m:20-26)
kLBAudioDetectiveArgumentInvalid = 1  # OSStatus analogue; raised as errors.InvalidArgumentError
kLBAudioDetectiveDefaultWindowSize = DEFAULT_WINDOW_SIZE
kLBAudioDetectiveDefaultAnalysisStride = DEFAULT_ANALYSIS_STRIDE
kLBAudioDetectiveDefaultNumberOfPitchSteps = DEFAULT_PITCH_STEP_COUNT
kLBAudioDetectiveDefaultNumberOfRowsPerFrame = DEFAULT_ROWS_PER_FRAME
kLBAudioDetectiveDefaultSubfingerprintLength = DEFAULT_SUBFINGERPRINT_LENGTH


# -- detective lifecycle (LBAudioDetective.h:41-56) -------------------------

def LBAudioDetectiveNew(*, device: torch.device | str = DEFAULT_DEVICE) -> AudioDetective:
    return AudioDetective(device=device)


def LBAudioDetectiveDispose(detective: AudioDetective) -> None:
    if detective is None:
        raise InvalidArgumentError("invalid argument: detective is None")
    detective.dispose()


def LBAudioDetectiveDefaultProcessingSampleRate() -> float:
    return DEFAULT_PROCESSING_SAMPLE_RATE


def LBAudioDetectiveDefaultProcessingFormat() -> dict:
    """AudioStreamBasicDescription analogue (LBAudioDetective.m:116-131):
    packed mono float32 at the processing rate."""
    return {"sample_rate": DEFAULT_PROCESSING_SAMPLE_RATE,
            "format": "lpcm", "float": True, "signed_integer": False,
            "bits_per_channel": 32, "channels_per_frame": 1,
            "frames_per_packet": 1, "bytes_per_frame": 4,
            "bytes_per_packet": 4, "packed": True}


def LBAudioDetectiveDefaultRecordingFormat() -> dict:
    """Recording-format default: packed mono signed-int16 PCM at the capture
    rate (the streaming runtime's int16 ingest, ``feed_pcm16``)."""
    return {"sample_rate": 44100.0,
            "format": "lpcm", "float": False, "signed_integer": True,
            "bits_per_channel": 16, "channels_per_frame": 1,
            "frames_per_packet": 1, "bytes_per_frame": 2,
            "bytes_per_packet": 2, "packed": True}


# -- getters (LBAudioDetective.h:63-122) ------------------------------------

def LBAudioDetectiveGetProcessingSampleRate(d: AudioDetective) -> float:
    return d.processing_sample_rate


def LBAudioDetectiveGetNumberOfPitchSteps(d: AudioDetective) -> int:
    return d.number_of_pitch_steps


def LBAudioDetectiveGetSubfingerprintLength(d: AudioDetective) -> int:
    return d.subfingerprint_length


def LBAudioDetectiveGetWindowSize(d: AudioDetective) -> int:
    return d.window_size


def LBAudioDetectiveGetAnalysisStride(d: AudioDetective) -> int:
    return d.analysis_stride


def LBAudioDetectiveGetRecordingSampleRate(d: AudioDetective) -> float:
    return d.recording_sample_rate


def LBAudioDetectiveGetFingerprint(d: AudioDetective):
    """The detective's most recent fingerprint (after CompareAudioURLs, the
    second file's); None before any processing."""
    return d.last_fingerprint


# -- setters (LBAudioDetective.h:144-201) -----------------------------------

def LBAudioDetectiveSetProcessingSampleRate(d: AudioDetective, rate: float) -> None:
    d.processing_sample_rate = rate


def LBAudioDetectiveSetNumberOfPitchSteps(d: AudioDetective, steps: int) -> None:
    d.number_of_pitch_steps = steps


def LBAudioDetectiveSetSubfingerprintLength(d: AudioDetective, length: int) -> None:
    d.subfingerprint_length = length


def LBAudioDetectiveSetWindowSize(d: AudioDetective, size: int) -> None:
    # Spec-corrected Q4: raises on a size that is not a power of two.
    d.window_size = size


def LBAudioDetectiveSetAnalysisStride(d: AudioDetective, stride: int) -> None:
    d.analysis_stride = stride


def LBAudioDetectiveSetRecordingSampleRate(d: AudioDetective, rate: float) -> None:
    """Recording stays signed-int PCM (h:135); only the rate is tunable."""
    d.recording_sample_rate = float(rate)


# -- processing (LBAudioDetective.h:210-235) --------------------------------

def LBAudioDetectiveProcessAudioURL(d: AudioDetective, url: str) -> Fingerprint:
    if url is None:
        raise InvalidArgumentError("invalid argument: url is None")
    return d.process_audio_file(url)


def LBAudioDetectiveCompareAudioURLs(d: AudioDetective, url1: str, url2: str,
                                     comparison_range: int = 0) -> float:
    return d.compare_audio_files(url1, url2, comparison_range)


# -- fingerprint container (LBAudioDetectiveFingerprint.h) ------------------
# The builder functions return the reference package's mutable
# FingerprintBuilder, which reads like the immutable Fingerprint, so every
# container function below accepts either.

def LBAudioDetectiveFingerprintNew(subfingerprint_length: int = 0) -> FingerprintBuilder:
    return FingerprintBuilder(subfingerprint_length)


def LBAudioDetectiveFingerprintDispose(fp) -> None:
    """NULL-tolerant like the reference (Fingerprint.m:28-31)."""
    if isinstance(fp, FingerprintBuilder):
        fp.clear()


def LBAudioDetectiveFingerprintSetSubfingerprintLength(
        fp: FingerprintBuilder, subfingerprint_length: int) -> tuple[bool, int]:
    """Returns ``(accepted, effective_length)``: refused once any
    subfingerprint was added (Fingerprint.m:81-89)."""
    if not isinstance(fp, FingerprintBuilder):
        raise InvalidArgumentError(
            "SetSubfingerprintLength requires a builder fingerprint "
            "(LBAudioDetectiveFingerprintNew); extracted Fingerprints are "
            "immutable value types")
    return fp.set_subfingerprint_length(subfingerprint_length)


def LBAudioDetectiveFingerprintAddSubfingerprint(
        fp: FingerprintBuilder, subfingerprint: np.ndarray) -> None:
    """Appends a copy of the first ``subfingerprint_length`` booleans
    (Fingerprint.m:91-100; quirk Q1)."""
    if not isinstance(fp, FingerprintBuilder):
        raise InvalidArgumentError(
            "AddSubfingerprint requires a builder fingerprint "
            "(LBAudioDetectiveFingerprintNew)")
    fp.add_subfingerprint(subfingerprint)


def LBAudioDetectiveFingerprintCompareSubfingerprints(
        fp, subfingerprint1: np.ndarray, subfingerprint2: np.ndarray,
        comparison_range: int) -> float:
    """Quirk-Q10 similarity of two raw interleaved boolean buffers; ``fp``
    contributes only its subfingerprint length cap."""
    return compare_subfingerprint_booleans(
        subfingerprint1, subfingerprint2, comparison_range,
        fp.subfingerprint_length)


def LBAudioDetectiveFingerprintCopy(fp: Fingerprint) -> Fingerprint:
    return fp.copy()


def LBAudioDetectiveFingerprintGetSubfingerprintLength(fp: Fingerprint) -> int:
    return fp.subfingerprint_length


def LBAudioDetectiveFingerprintGetNumberOfSubfingerprints(fp: Fingerprint) -> int:
    return fp.num_subfingerprints


def LBAudioDetectiveFingerprintGetSubfingerprintAtIndex(fp: Fingerprint, index: int) -> np.ndarray:
    return fp.subfingerprint_booleans(index)


def LBAudioDetectiveFingerprintEqualToFingerprint(fp1: Fingerprint, fp2: Fingerprint) -> bool:
    return fp1 == fp2


def stringFromFingerprint(fp: Fingerprint) -> str:
    """The reference test harness's golden serializer: '0'/'1' per stored
    boolean, subfingerprints joined by '+'."""
    return fp.to_string()


def LBAudioDetectiveFingerprintCompareToFingerprint(
        fp1: Fingerprint, fp2: Fingerprint, comparison_range: int = 0, *,
        device: torch.device | str = DEFAULT_DEVICE) -> float:
    """Offset-sliding match on ``device``.  As in the reference, range 0
    compares zero booleans, so the match is 0.0 (Fingerprint.m:155,171-175);
    only CompareAudioURLs turns range 0 into the subfingerprint length."""
    device = resolve_device(device, "LBAudioDetectiveFingerprintCompareToFingerprint")
    if comparison_range == 0:
        return 0.0
    return match_fingerprints((fp1.pos, fp1.neg), (fp2.pos, fp2.neg),
                              comparison_range, fp1.subfingerprint_length,
                              device=device)


# -- frame (LBAudioDetectiveFrame.h, private in the reference) ---------------

def LBAudioDetectiveFrameNew(max_row_count: int) -> Frame:
    return Frame(max_row_count)


def LBAudioDetectiveFrameCopy(frame: Frame) -> Frame:
    return frame.copy()


def LBAudioDetectiveFrameGetNumberOfRows(frame: Frame) -> int:
    return frame.number_of_rows


def LBAudioDetectiveFrameGetValue(frame: Frame, row: int, col: int) -> float:
    return frame.get_value(row, col)


def LBAudioDetectiveFrameFull(frame: Frame) -> bool:
    return frame.full()


def LBAudioDetectiveFrameSetRow(frame: Frame, row, index: int, count: int) -> bool:
    return frame.set_row(np.asarray(row, np.float32)[:count], index)


def LBAudioDetectiveFrameDecompose(frame: Frame) -> None:
    frame.decompose()


def LBAudioDetectiveFrameExtractFingerprint(frame: Frame, number_of_wavelets: int):
    return frame.extract_fingerprint(number_of_wavelets)


def LBAudioDetectiveFrameEqualToFrame(frame1: Frame, frame2: Frame) -> bool:
    return frame1 == frame2


def LBAudioDetectiveFrameDispose(frame) -> None:
    """NULL-tolerant like the reference (Frame.m:33-43)."""
    if frame is not None:
        frame.clear()


def LBAudioDetectiveFrameGetRow(frame: Frame, row: int) -> np.ndarray:
    return frame.get_row(row)


def LBAudioDetectiveFrameFingerprintLength(frame: Frame) -> int:
    """numberOfRows * rowLength * 2 booleans (Frame.m:159-161)."""
    return frame.fingerprint_length


def LBAudioDetectiveFrameFingerprintSize(frame: Frame) -> int:
    """Byte size of the extraction buffer (Frame.m:155-157)."""
    return frame.fingerprint_size


# -- streaming (the essay's Appendix E names) --------------------------------
# The detective argument is this package's streaming.StreamingDetective.

def LBAudioDetectiveProcess(detective, max_number_of_subfingerprints: int,
                            callback) -> None:
    """Start streaming recognition; ``callback`` fires once
    ``max_number_of_subfingerprints`` frames are fingerprinted."""
    detective.start_processing(max_number_of_subfingerprints, callback)


def LBAudioDetectiveStartProcessing(detective, max_number_of_subfingerprints: int,
                                    callback=None) -> None:
    detective.start_processing(max_number_of_subfingerprints, callback)


def LBAudioDetectiveStopProcessing(detective):
    return detective.stop_processing()


def LBAudioDetectivePauseProcessing(detective) -> None:
    detective.pause_processing()


def LBAudioDetectiveResumeProcessing(detective) -> None:
    detective.resume_processing()
