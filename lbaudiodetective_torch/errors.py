"""Typed exception hierarchy mirroring the reference's OSStatus semantics.

The reference reports errors via OSStatus return codes checked by
``LBErrorCheck`` — which logs the 4CC/int code to stderr and CONTINUES
(LBAudioDetective.m:53-72) — plus one domain constant
``kLBAudioDetectiveArgumentInvalid`` (m:20, h:14).  Spec correction (SURVEY
§5): this framework raises typed exceptions instead of continuing past
failures; each type carries a ``status`` attribute preserving the numeric
OSStatus analogue for callers porting 4CC-based error handling.

Each class also inherits the builtin exception the framework raised for the
same condition before this hierarchy existed (ValueError /
NotImplementedError), so ``except ValueError`` call sites keep working.
"""

from __future__ import annotations

#: OSStatus analogue of kLBAudioDetectiveArgumentInvalid (LBAudioDetective.m:20).
ARGUMENT_INVALID = 1
#: Decode failures have no reference constant (ExtAudioFile returned Apple
#: OSStatus codes); a framework-domain code is assigned.
DECODE_FAILED = 2
UNSUPPORTED_FORMAT = 3
RESOURCE_EXHAUSTED = 4


class AudioDetectiveError(Exception):
    """Base class; ``status`` is the OSStatus-analogue numeric code."""

    status: int = -1


class InvalidArgumentError(AudioDetectiveError, ValueError):
    """kLBAudioDetectiveArgumentInvalid: NULL/invalid API argument
    (LBAudioDetective.m:211-214 raises it for a NULL URL)."""

    status = ARGUMENT_INVALID


class DecodeError(AudioDetectiveError, ValueError):
    """Malformed container / corrupt stream (the analogue of a failing
    ExtAudioFileOpenURL/Read, LBAudioDetective.m:224,275)."""

    status = DECODE_FAILED


class UnsupportedFormatError(DecodeError, NotImplementedError):
    """Well-formed file in a codec/layout this framework does not decode."""

    status = UNSUPPORTED_FORMAT


class ResourceExhaustedError(AudioDetectiveError, RuntimeError):
    """A server-side capacity bound was hit (live-session slots full of
    active sessions, a serving mode refused at the configured library-size
    bound).  Retryable; the HTTP edge maps it to 429 rather than 400."""

    status = RESOURCE_EXHAUSTED
