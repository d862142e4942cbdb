"""AudioDetective: the end-to-end pipeline object (port of
the JAX package's ``models/detective.py``).

Decode on the host -> extract on ``device`` -> match on ``device``.
``AudioDetective(config)`` runs the kernels on CUDA and raises when CUDA is
absent; it never falls back to the CPU.  CPU use passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from lbaudiodetective_torch.config import FingerprintConfig
from lbaudiodetective_torch.device import DEFAULT_DEVICE, resolve_device
from lbaudiodetective_torch.io.decode import DecodedAudio, decode_audio_file
from lbaudiodetective_torch.models.fingerprint import Fingerprint
from lbaudiodetective_torch.utils.packing import words_per_plane
from lbaudiodetective_torch.models.library import pack_fingerprints
from lbaudiodetective_torch.ops.extract import (
    bucket_subfingerprints, extract_fingerprint, extract_fingerprint_batch)
from lbaudiodetective_torch.ops.match import match_fingerprints
from lbaudiodetective_torch.ops.match_packed import match_one_vs_many_packed
from lbaudiodetective_torch.utils import profiling


class AudioDetective:
    """Decode -> extract -> match pipeline with reference-compatible knobs."""

    def __init__(self, config: FingerprintConfig | None = None,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.device = resolve_device(device, "AudioDetective")
        self.config = config or FingerprintConfig()
        #: Recording-format preference (only the sample rate is tunable).
        self.recording_sample_rate = 44100.0
        #: The most recent fingerprint (after compare_audio_files: the second).
        self.last_fingerprint: Fingerprint | None = None

    def __enter__(self) -> "AudioDetective":
        return self

    def __exit__(self, *exc) -> None:
        self.dispose()

    def dispose(self) -> None:
        """No-op; kept for API parity with LBAudioDetectiveDispose."""

    # -- preferences (LBAudioDetective.h:63-201) ----------------------------

    @property
    def processing_sample_rate(self) -> float:
        return self.config.processing_sample_rate

    @processing_sample_rate.setter
    def processing_sample_rate(self, value: float) -> None:
        self.config = self.config.with_updates(processing_sample_rate=float(value))

    @property
    def number_of_pitch_steps(self) -> int:
        return self.config.pitch_step_count

    @number_of_pitch_steps.setter
    def number_of_pitch_steps(self, value: int) -> None:
        self.config = self.config.with_updates(pitch_step_count=int(value))

    @property
    def subfingerprint_length(self) -> int:
        return self.config.subfingerprint_length

    @subfingerprint_length.setter
    def subfingerprint_length(self, value: int) -> None:
        self.config = self.config.with_updates(subfingerprint_length=int(value))

    @property
    def window_size(self) -> int:
        return self.config.window_size

    @window_size.setter
    def window_size(self, value: int) -> None:
        self.config = self.config.with_updates(window_size=int(value))

    @property
    def analysis_stride(self) -> int:
        return self.config.analysis_stride

    @analysis_stride.setter
    def analysis_stride(self, value: int) -> None:
        self.config = self.config.with_updates(analysis_stride=int(value))

    # -- processing ---------------------------------------------------------

    def process_audio_file(self, path: str) -> Fingerprint:
        if path is None:
            from lbaudiodetective_torch.errors import InvalidArgumentError

            raise InvalidArgumentError(
                "path must not be None (kLBAudioDetectiveArgumentInvalid)")
        audio = decode_audio_file(path, self.config.processing_sample_rate)
        return self.process_decoded(audio)

    def process_decoded(self, audio: DecodedAudio) -> Fingerprint:
        pos, neg, n_sub = extract_fingerprint(audio, self.config, device=self.device)
        fp = Fingerprint.from_planes(pos[:n_sub], neg[:n_sub],
                                     self.config.subfingerprint_length)
        self.last_fingerprint = fp
        return fp

    def process_batch(self, paths: list[str]) -> list[Fingerprint]:
        """All clips in one padded device dispatch."""
        clips = [decode_audio_file(p, self.config.processing_sample_rate) for p in paths]
        return self.process_decoded_batch(clips)

    def process_decoded_batch(self, clips: list[DecodedAudio]) -> list[Fingerprint]:
        """All clips in one padded batch, launched in chunks
        (``ops.extract.FingerprintExtractor.extract_clips``): the span
        ``detective.batch`` (``clips``) over the extraction's spans and
        ``fingerprint.wrap``, inside ``utils.profiling.recording()``."""
        with profiling.stage("detective.batch", clips=len(clips)):
            pos, neg, n_subs = extract_fingerprint_batch(clips, self.config,
                                                         device=self.device)
            with profiling.stage("fingerprint.wrap", clips=len(n_subs)):
                return [Fingerprint.from_planes(pos[i, :n], neg[i, :n],
                                                self.config.subfingerprint_length)
                        for i, n in enumerate(n_subs)]

    def compare_audio_files(self, path1: str, path2: str,
                            comparison_range: int = 0) -> float:
        fp1 = self.process_audio_file(path1)
        fp2 = self.process_audio_file(path2)
        return self.compare_fingerprints(fp1, fp2, comparison_range)

    def compare_fingerprints(self, fp1: Fingerprint, fp2: Fingerprint,
                             comparison_range: int = 0) -> float:
        return match_fingerprints((fp1.pos, fp1.neg), (fp2.pos, fp2.neg),
                                  comparison_range, self.config.subfingerprint_length,
                                  device=self.device)

    def match_against_library(self, query: Fingerprint,
                              library: list[Fingerprint],
                              comparison_range: int = 0) -> np.ndarray:
        """One-vs-many: returns ``[len(library)]`` match scores.  The
        planes are packed on the host and scored by the packed matcher (the
        match kernel on CUDA, one launch), whose scores equal the
        reference's unpacked ``match_one_vs_many_padded`` to the bit."""
        if not library:
            return np.zeros(0, dtype=np.float32)
        s_max = bucket_subfingerprints(max(max(f.num_subfingerprints for f in library),
                                           query.num_subfingerprints, 1))
        w = words_per_plane(query.pairs)
        dev = self.device
        lib_pos, lib_neg, n_lib = (torch.from_numpy(a.view(np.int32)).to(dev)
                                   for a in pack_fingerprints(library, s_max, w))
        q_pos, q_neg, n_q = (torch.from_numpy(a.view(np.int32)).to(dev)
                             for a in pack_fingerprints([query], s_max, w))
        scores = match_one_vs_many_packed(
            q_pos, q_neg, n_q, lib_pos, lib_neg, n_lib, query.pairs,
            comparison_range, self.config.subfingerprint_length)
        return scores[0].cpu().numpy()
