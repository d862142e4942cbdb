"""Build and load the port's CUDA kernels.

The sources under ``lbaudiodetective_torch/csrc/`` are compiled by ``nvcc``
for ``sm_90a`` (H100), one process per ``.cu`` file, all started together,
and linked into one shared library with a plain C interface, which is
loaded with ``ctypes``.  The build runs on first use, never at import,
into ``build/torch_kernels/`` beside the package; the file name carries a
hash of the sources, so an edited source is rebuilt.  ``ptxas -v``'s report
(registers, spills, shared memory of each kernel) is kept beside the
library (``ptxas_report``).  A timing ablation builds and loads copies with
extra ``-D`` macros (``load_library(flags)``), each under its own hash.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_flags: tuple[str, ...] = ()


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path(flags: tuple[str, ...] = ()) -> pathlib.Path:
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *flags]).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"liblbad_kernels_{h.hexdigest()[:12]}.so"


def build(flags: tuple[str, ...] = ()) -> pathlib.Path:
    """Compile the kernels, with extra nvcc ``flags`` if given (the ``-D``
    macros of a timing ablation), unless the library for these sources and
    flags exists."""
    so = library_path(flags)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp.with_suffix(f".{src.stem}.o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *flags, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors, report = [], []
    for src, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name} ({proc.returncode}):\n{err}")
        report.append(f"== {src.name}\n{err}")
    try:
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        so.with_suffix(".ptxas.txt").write_text("".join(report))
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return so


def ptxas_report(flags: tuple[str, ...] = ()) -> str:
    """``ptxas -v``'s output for each source of the built library."""
    path = build(flags).with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def load_library(flags: tuple[str, ...] | None = None) -> ctypes.CDLL:
    """The kernels' shared library, built on first use, with every entry
    point's argument and return types declared.  ``flags`` switches every
    wrapper, from then on, to the library built with those extra nvcc flags
    (``()`` back to the plain build); None keeps the one loaded."""
    global _lib, _lib_flags
    with _lock:
        if flags is not None and tuple(flags) != _lib_flags:
            _lib, _lib_flags = None, tuple(flags)
        if _lib is None:
            lib = ctypes.CDLL(str(build(_lib_flags)))
            p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
            lib.lbad_select_sign_classes.argtypes = [p, i, p, p]
            lib.lbad_select_sign_classes.restype = i
            lib.lbad_fused_rows.argtypes = [p, i, ll, i, i, p, p, p, p, i, p, p, f,
                                            p, p, p]
            lib.lbad_fused_rows.restype = i
            lib.lbad_fused_rows_smem_bytes.argtypes = [i]
            lib.lbad_fused_rows_smem_bytes.restype = i
            lib.lbad_band_rows.argtypes = [p, i, ll, p, i, i, i, i, i, i, p, p, p, p, p,
                                           p, f, p, p]
            lib.lbad_band_rows.restype = i
            lib.lbad_band_rows_smem_bytes.argtypes = [i, i, i, i]
            lib.lbad_band_rows_smem_bytes.restype = ll
            lib.lbad_band_rows_smem_limit.argtypes = []
            lib.lbad_band_rows_smem_limit.restype = ll
            lib.lbad_match_packed.argtypes = [p, p, p, i, i, p, p, p, ll, i, i, i, i, i, i,
                                              p, p]
            lib.lbad_match_packed.restype = i
            lib.lbad_match_packed_smem_bytes.argtypes = [i, i, i, i, i]
            lib.lbad_match_packed_smem_bytes.restype = ll
            lib.lbad_slot_fold.argtypes = [p, p, i, ll, i, i, p, p, p, p, i, i, i, p, p, p, p,
                                           p, i, p]
            lib.lbad_slot_fold.restype = i
            _lib = lib
        return _lib


def check(status: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")
