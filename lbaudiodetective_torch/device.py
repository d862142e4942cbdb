"""The device an entry point runs on: the card unless the caller asks for
the CPU.

Every entry point (``AudioDetective``, ``FingerprintExtractor`` and the
extraction functions, ``match_fingerprints``, ``FingerprintLibrary``'s
constructors, ``StreamingExtractor``, ``StreamingDetective``, the C-API
names and the CLI) takes ``device``, ``"cuda"`` by default, and raises
``RuntimeError`` when CUDA is absent: none falls back to the CPU.  CPU use
passes ``device="cpu"``."""

from __future__ import annotations

import numpy as np
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
    the caller's device and the library's differ.  A library sharded over a
    mesh (``library.mesh``) needs every slot on the caller's device type
    (and card, where ``device`` names one); its device is its first
    slot's."""
    device = resolve_device(device, what)
    mesh = getattr(library, "mesh", None)
    slot_devs = [library.device] if mesh is None else [s.device for s in mesh.slots.flat]
    for lib_dev in slot_devs:
        if device.type != lib_dev.type or device.index not in (None, lib_dev.index):
            raise ValueError(f"{what}: the library is on {lib_dev}, not on {device}")
    return library.device


def to_device(x, device: torch.device) -> torch.Tensor:
    """A NumPy array or tensor on ``device``.  A host array goes through
    pinned memory with a non-blocking copy, so the host does not wait for
    the device's queue."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
