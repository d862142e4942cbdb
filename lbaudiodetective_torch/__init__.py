"""LBAudioDetective on PyTorch and CUDA: the port of the JAX package.

The extract -> match path, the packed library, the streaming runtime and
identifier (``streaming``, with the incremental matcher), the HTTP
identification service (``serving``), MAA (``models.maa``), the long
matchers (``ops.match``), the profiling hooks (``utils.profiling``), the
C-API name layer (``compat``) and the multi-device layer (``parallel``: a
mesh of device slots, sharded matching, search, ring dedup and the sharded
library) run on a torch device; on CUDA the extraction
and the library's matcher go through hand-written Hopper kernels
(``ops.kernels``).  Decoding, resampling, the configuration,
the Fingerprint value type, the library file format and the NumPy oracle are
this package's own copies of the JAX package's host-only modules
(``config``, ``errors``, ``io``, ``models.fingerprint``, ``models.frame``,
``utils``, ``oracle``).  This package imports neither JAX nor the JAX
package.

    FingerprintConfig   -- frozen, hashable pipeline configuration
    Fingerprint         -- value type holding subfingerprint bits
    AudioDetective      -- decode -> extract -> match on one device
    FingerprintLibrary  -- packed, device-resident library: match, search
    StreamingExtractor  -- incremental extraction for B lockstep streams
    StreamingDetective  -- single-stream Start/Stop/Pause/Resume API
    StreamingIdentifier -- B streams identified against a library
    IdentificationService -- the HTTP edge's request -> response core
    ShardedFingerprintLibrary -- a FingerprintLibrary split over a mesh
    extract_fingerprint -- single-clip extraction
    match_fingerprints  -- offset-sliding matcher

Imports are lazy (PEP 562).
"""

__version__ = "0.1.0"

_EXPORTS = {
    "FingerprintConfig": "lbaudiodetective_torch.config",
    "Fingerprint": "lbaudiodetective_torch.models.fingerprint",
    "FingerprintBuilder": "lbaudiodetective_torch.models.fingerprint",
    "AudioDetective": "lbaudiodetective_torch.models.detective",
    "FingerprintLibrary": "lbaudiodetective_torch.models.library",
    "FingerprintExtractor": "lbaudiodetective_torch.ops.extract",
    "extract_fingerprint": "lbaudiodetective_torch.ops.extract",
    "match_fingerprints": "lbaudiodetective_torch.ops.match",
    "StreamingExtractor": "lbaudiodetective_torch.streaming.runtime",
    "StreamingDetective": "lbaudiodetective_torch.streaming.runtime",
    "StreamingIdentifier": "lbaudiodetective_torch.streaming.identify",
    "IdentificationService": "lbaudiodetective_torch.serving",
    "ShardedFingerprintLibrary": "lbaudiodetective_torch.parallel.sharded_library",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        module = importlib.import_module(_EXPORTS[name])
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
