"""Guarded external-decoder shim for perceptual codecs (MP3/AAC/ALAC/...).

The reference accepts anything AudioToolbox can open — on iOS that includes
perceptual codecs (LBAudioDetective.m:224 via ExtAudioFileOpenURL;
LBAudioDetective.h:210-235 documents the URL-based surface).  This framework
ships self-contained codecs for CAF/WAV/AIFF/AU only (no codec licenses and
decode is a host-side concern); when a system ``ffmpeg`` is present, this
shim closes the breadth gap by transcoding unknown containers to float32
WAV in a scratch file and re-reading them through our own validated WAV
reader.  Without a decoder on PATH the caller gets a typed
:class:`~lbaudiodetective_torch.errors.UnsupportedFormatError` — never a
silent wrong decode.

The subprocess runs with a timeout and without a shell; the input path is
passed as a single argv element (no injection surface).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np

from lbaudiodetective_torch.errors import DecodeError, UnsupportedFormatError

#: Candidate decoder commands, in preference order.  Each entry maps the
#: command name to the argv template producing a float32 WAV at ``{out}``.
_DECODERS = (
    ("ffmpeg", lambda src, dst: ["ffmpeg", "-v", "error", "-nostdin", "-y",
                                 "-i", src, "-map", "a:0", "-c:a", "pcm_f32le",
                                 "-f", "wav", dst]),
    ("avconv", lambda src, dst: ["avconv", "-v", "error", "-y", "-i", src,
                                 "-c:a", "pcm_f32le", "-f", "wav", dst]),
)

_cached: tuple | None | bool = False  # False = not probed yet


def find_external_decoder():
    """The first available decoder as ``(name, argv_builder)``, or None.

    Probed once per process (PATH lookups are cheap but this also keeps
    behaviour stable within a run)."""
    global _cached
    if _cached is False:
        _cached = None
        for name, build in _DECODERS:
            if shutil.which(name):
                _cached = (name, build)
                break
    return _cached


def available() -> bool:
    return find_external_decoder() is not None


def decode_via_external(path: str, timeout_s: float = 120.0
                        ) -> tuple[np.ndarray, float]:
    """Decode ``path`` with the system decoder -> (mono float32, rate).

    Raises :class:`UnsupportedFormatError` when no decoder is installed and
    :class:`DecodeError` when the decoder itself rejects the file.
    """
    dec = find_external_decoder()
    if dec is None:
        raise UnsupportedFormatError(
            f"no built-in codec for {path!r} and no external decoder "
            "(ffmpeg) on PATH")
    name, build = dec
    fd, tmp = tempfile.mkstemp(suffix=".wav")
    os.close(fd)
    try:
        try:
            proc = subprocess.run(build(path, tmp), capture_output=True,
                                  text=True, timeout=timeout_s)
        except subprocess.TimeoutExpired:
            raise DecodeError(f"{name} timed out decoding {path!r}") from None
        if proc.returncode != 0:
            detail = (proc.stderr or "").strip()[-300:]
            raise DecodeError(
                f"{name} could not decode {path!r}: {detail or 'unknown error'}")
        from lbaudiodetective_torch.io.wav import read_wav

        return read_wav(tmp)
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
