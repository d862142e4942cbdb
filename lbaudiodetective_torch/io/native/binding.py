"""ctypes binding for the native CAF decoder / resampler.

Builds the shared library on demand with g++ (no pip dependencies); all
callers fall back to the NumPy implementations if the toolchain or build is
unavailable.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

from lbaudiodetective_torch.errors import DecodeError

_DIR = pathlib.Path(__file__).resolve().parent
_SO = _DIR / "build" / "libcaf_decoder.so"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        # A prebuilt .so from an older source tree may predate symbols the
        # binding now requires; detecting that AFTER CDLL would be too late
        # (dlopen caches by path), so check the export strings on disk and
        # force a rebuild.  make -B is a no-op risk only when the toolchain
        # is absent — and then a stale library could not be fixed anyway.
        stale = (_SO.exists()
                 and b"lbad_read_audio" not in _SO.read_bytes())
        if stale or not _SO.exists():
            subprocess.run(["make", "-B", "-C", str(_DIR)], check=True,
                           capture_output=True, timeout=120)
        lib = ctypes.CDLL(str(_SO))
        lib.lbad_read_caf.restype = ctypes.c_int
        lib.lbad_read_caf.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)]
        lib.lbad_read_audio.restype = ctypes.c_int
        lib.lbad_read_audio.argtypes = lib.lbad_read_caf.argtypes
        lib.lbad_resample.restype = ctypes.c_int
        lib.lbad_resample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.lbad_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _read_via(fn_name: str, path: str) -> tuple[np.ndarray, float]:
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    ptr = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rate = ctypes.c_double()
    status = getattr(lib, fn_name)(path.encode(), ctypes.byref(ptr),
                                   ctypes.byref(n), ctypes.byref(rate))
    if status != 0:
        raise DecodeError(f"native decode failed (status {status}) for {path}")
    try:
        samples = np.ctypeslib.as_array(ptr, shape=(n.value,)).copy()
    finally:
        lib.lbad_free(ptr)
    return samples, rate.value


def read_caf(path: str) -> tuple[np.ndarray, float]:
    return _read_via("lbad_read_caf", path)


def read_audio(path: str) -> tuple[np.ndarray, float]:
    """Container-dispatching native decode (CAF/WAV/AIFF/AU by magic).

    Raises on unsupported codecs (e.g. ADPCM WAV) so callers fall back to
    the NumPy readers — the behavioural source of truth."""
    return _read_via("lbad_read_audio", path)


def resample(x: np.ndarray, bank: np.ndarray, up: int, down: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    x = np.ascontiguousarray(x, np.float32)
    bank = np.ascontiguousarray(bank, np.float32)
    n_out = (len(x) * up) // down
    out = np.empty(n_out, np.float32)
    status = lib.lbad_resample(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
        bank.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        up, down, bank.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_out)
    if status != 0:
        raise ValueError(f"native resample failed (status {status})")
    return out
