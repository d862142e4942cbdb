"""Shared helpers of the PyTorch port's tests (``tests/test_torch_*.py``).

Inputs are made from a seed with numpy and handed to both the JAX package
and the port.  Each package takes its own configs, clips and fingerprints:
``jax_config``, ``jax_clip``, ``jax_fp`` and ``port_fp`` carry one across the
boundary as numpy arrays and field values.  Tests of a CUDA kernel take the
``cuda_device`` fixture and carry the ``cuda`` marker: they skip where no card
is present, deciding so inside the fixture, never at import."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: Shared memory a block may opt in to on an H100 (227 KB).
H100_SMEM_BYTES = 232448


def band_rows_layout(sub: int, bands: int, span_pad: int, frame_floats: int) -> int:
    """``csrc/band_rows.cu``'s shared-memory layout in bytes, restated for
    the CPU tests of ``band_rows.tile_plan``; tests/test_torch_cuda.py holds
    it to the kernel's own ``lbad_band_rows_smem_bytes``.  Regions, in
    floats: the audio span; G, 2 x 16 x 32 a slab of 16 windows; two chunks'
    twiddle fragments (2 x 6144); the rows or the frame (the larger of
    frame_floats and sub x bands, rounded up to 4); a pass's projection
    weights (48 x bands); the stage-1 matrices (2 x 16 x 16); residue-0
    offsets and window offsets (128 each).  -1 past 128 windows, or for a
    span_pad below one window or not a multiple of 4."""
    if not 1 <= sub <= 128 or bands < 1 or span_pad < 2048 or span_pad % 4 or frame_floats < 0:
        return -1
    rows = -(-max(frame_floats, sub * bands) // 4) * 4
    return 4 * (span_pad + -(-sub // 16) * 2 * 16 * 32 + 2 * 6144 + rows + 48 * bands
                + 2 * 16 * 16 + 2 * 128)


def match_packed_layout(bg: int, sq: int, e: int, sl: int, w: int) -> int:
    """``csrc/match_packed.cu``'s shared-memory layout in bytes, restated
    for the CPU test of ``match_packed.launch_plan``; tests/test_torch_cuda.py
    holds it to the kernel's own ``lbad_match_packed_smem_bytes``.  Regions,
    in words rounded up to 4: the query group's pos and neg rows, their
    inv_q, counts and overlap flags; two chunk buffers of pos and neg entry
    rows, inv_lib, counts and overlap flags; the raw counts of two chunks;
    each (query, entry)'s best score and the prefix sum; the reciprocal
    table (32 w + 1)."""
    def r4(n):
        return -(-n // 4) * 4

    query = 2 * r4(bg * sq * w) + r4(bg * sq) + r4(2 * bg)
    chunk = 2 * r4(e * sl * w) + r4(e * sl) + r4(2 * e)
    return 4 * (query + 2 * chunk + r4(2 * e) + r4(bg * e) + r4(bg * e + 1) + r4(32 * w + 1))


def brown_noise(seed: int, batch: int, n: int) -> np.ndarray:
    """Brown-spectrum noise with non-zero energy in every band."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n)).astype(np.float32) * 0.1
    return (np.cumsum(x, axis=1) * 0.05).astype(np.float32)


def non_finite_audio(audio: np.ndarray, hop: int) -> np.ndarray:
    """``audio`` (two or more clips) with NaN at the first sample of clip 0's
    second 128-window tile and +inf at clip 1's first sample: only the
    windows holding one lose their energies (non-finite -> 0), and the
    coefficients stay finite."""
    audio = audio.copy()
    audio[0, 128 * hop] = np.nan
    audio[1, 0] = np.inf
    return audio


def synth_clip(seed: int, seconds: float, config):
    """A decoded ``seconds``-long clip, as the port's decode_audio_file
    returns it."""
    from lbaudiodetective_torch.io.decode import DecodedAudio

    n = int(seconds * config.processing_sample_rate)
    return DecodedAudio(brown_noise(seed, 1, n)[0], config.processing_sample_rate,
                        int(seconds * config.file_sample_rate),
                        config.file_sample_rate)


def jax_config(cfg):
    """The JAX package's FingerprintConfig with the fields of ``cfg``."""
    from lbaudiodetective_tpu.config import FingerprintConfig

    return FingerprintConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def jax_clip(clip):
    """The JAX package's DecodedAudio holding the samples of ``clip``."""
    from lbaudiodetective_tpu.io.decode import DecodedAudio

    return DecodedAudio(np.asarray(clip.samples), clip.processing_rate, clip.file_frames,
                        clip.file_rate)


def jax_fp(fp):
    """The JAX package's Fingerprint with the bit planes of ``fp``."""
    from lbaudiodetective_tpu.models.fingerprint import Fingerprint

    return Fingerprint(np.asarray(fp.pos), np.asarray(fp.neg), fp.subfingerprint_length)


def port_fp(fp):
    """The port's Fingerprint with the bit planes of ``fp``."""
    from lbaudiodetective_torch.models.fingerprint import Fingerprint

    return Fingerprint(np.asarray(fp.pos), np.asarray(fp.neg), fp.subfingerprint_length)


def bit_agreement(pos_a, neg_a, pos_b, neg_b) -> float:
    return float(((pos_a == pos_b).mean() + (neg_a == neg_b).mean()) / 2)


def select_cases() -> dict[str, np.ndarray]:
    """The six frame sets of tests/test_select_signs.py."""
    rng = np.random.default_rng(0)
    cases = {"random": rng.standard_normal((64, 4096)).astype(np.float32)}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 4096)).astype(np.float32)
    x[:, 1::2] = -x[:, ::2]
    cases["plus_minus_tie_pairs"] = x
    x = np.zeros((64, 4096), np.float32)
    x[:, :50] = 1.5
    x[:, 100:160] = -1.5
    cases["k_boundary_ties"] = x
    rng = np.random.default_rng(2)
    x = rng.choice(np.float32([0.5, -0.5, 2.0, -2.0, 0.0]), size=(32, 4096))
    x[0] = 0.0
    x[1, ::3] = -0.0
    cases["zeros_and_few_values"] = x.astype(np.float32)
    rng = np.random.default_rng(3)
    cases["padding"] = rng.standard_normal((36, 4096)).astype(np.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((32, 4096)).astype(np.float32)
    x[:, 7] = np.nan
    x[:, 11] = np.inf
    x[:, 13] = -np.inf
    cases["nan_and_inf"] = x
    return cases


def numpy_select(x: np.ndarray, k: int = 128) -> np.ndarray:
    """Stable argsort on ~(bits & 0x7FFFFFFF): the reference order."""
    keys = ~(x.view(np.uint32) & 0x7FFFFFFF)
    cls = (x > 0).astype(np.int32) + 2 * (x < 0).astype(np.int32)
    order = np.argsort(keys, axis=-1, kind="stable")
    return np.take_along_axis(cls, order, axis=-1)[:, :k]


def sign_planes(rng, shape):
    """Random disjoint (pos, neg) {0,1} uint8 planes."""
    cls = rng.choice(3, size=shape)
    return (cls == 1).astype(np.uint8), (cls == 2).astype(np.uint8)


def ragged_case(seed: int, pairs: int, l: int = 128, nq: int = 32, s: int = 64):
    """The packed-matcher cases of tests/test_match_fused.py: ragged counts,
    including an empty entry, one shorter than the query (orientation B)
    and one equal to it (a single offset); planes zero past each count."""
    rng = np.random.default_rng(seed)
    lib_pos, lib_neg = sign_planes(rng, (l, s, pairs))
    q_pos, q_neg = sign_planes(rng, (s, pairs))
    n_lib = rng.integers(1, s + 1, size=l).astype(np.int32)
    n_lib[:3] = (0, 5, nq)
    for i in range(l):
        lib_pos[i, n_lib[i]:] = 0
        lib_neg[i, n_lib[i]:] = 0
    q_pos[nq:] = 0
    q_neg[nq:] = 0
    return q_pos, q_neg, nq, lib_pos, lib_neg, n_lib


def synthetic_library(seed: int = 7, n: int = 64, s: int = 48, pairs: int = 100):
    """tests/test_library.py's perturbed-variant library: entry 11 is the
    least perturbed copy of the query."""
    rng = np.random.default_rng(seed)
    base_pos = (rng.random((s, pairs)) < 0.45).astype(np.uint8)
    base_neg = ((rng.random((s, pairs)) < 0.45) & (base_pos == 0)).astype(np.uint8)
    pos, neg = [], []
    for i in range(n):
        flips = rng.random((s, pairs)) < (0.02 if i == 11 else 0.30)
        p = np.where(flips, 1 - base_pos, base_pos).astype(np.uint8)
        pos.append(p)
        neg.append(np.where(flips & (p == 0), 1 - base_neg, base_neg * (1 - p)).astype(np.uint8))
    return base_pos, base_neg, np.stack(pos), np.stack(neg)
