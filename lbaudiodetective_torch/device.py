"""The device an entry point runs on: the card unless the caller asks for
the CPU.

Every entry point (``AudioDetective``, ``FingerprintExtractor`` and the
extraction functions, ``match_fingerprints``, ``FingerprintLibrary``'s
constructors, ``StreamingExtractor``, ``StreamingDetective``, the C-API
names and the CLI) takes ``device``, ``"cuda"`` by default, and raises
``RuntimeError`` when CUDA is absent: none falls back to the CPU.  CPU use
passes ``device="cpu"``."""

from __future__ import annotations

import torch

#: The default ``device`` of every entry point.
DEFAULT_DEVICE = "cuda"


def resolve_device(device: torch.device | str, what: str) -> torch.device:
    """``device`` as a ``torch.device``; ``RuntimeError`` naming ``what``
    for a CUDA device when CUDA is not available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}(device={str(device)!r}): CUDA is not available")
    return device


def library_device(library, device: torch.device | str, what: str) -> torch.device:
    """The device of ``library`` once ``device`` (resolved as
    :func:`resolve_device` does) is checked to be it: ``ValueError`` when
    the caller's device and the library's differ."""
    device = resolve_device(device, what)
    lib_dev = library.device
    if device.type != lib_dev.type or device.index not in (None, lib_dev.index):
        raise ValueError(f"{what}: the library is on {lib_dev}, not on {device}")
    return lib_dev
