#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's extract -> match path once on one GPU.

    python3 chip_smoke.py

Phases (each failed check raises, and the script exits non-zero):

1. Device report: ``nvidia-smi`` name and power limit, torch/CUDA/nvcc.
2. Build the kernels from ``lbaudiodetective_torch/csrc/`` with nvcc.
3. Select kernel vs its plain version: element-exact on six cases, timed
   at the main-path shape [14336, 4096].
4. Rows kernel vs its plain version at hop 8, 64 and 128 (batch 4):
   coefficients within rtol 5e-4, atol 3e-6 * max|coeff|; classes
   element-exact against the select kernel on the rows kernel's own
   coefficients; two runs bit-identical; >= 99.9% of bits against the NumPy
   oracle on two clips.
5. Main path through ``AudioDetective(device="cuda")``: 256 ten-second
   clips in parity mode, a written WAV, a compare of two written WAVs, and
   one query against a 16,384-entry library.  Scores on a 256-entry
   sub-library equal the CPU path's within 1e-6; both kernels' launch
   counts over this phase are > 0.

The last three lines are the kernels' JSON record, the ``nvidia-smi`` name
and power limit, and the device JSON.
Needs one CUDA card; without one it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
N_CLIPS = 256
CLIP_SECONDS = 10.0
N_LIBRARY = 16384
SELECT_SHAPE = (14336, 4096)     # 256 clips x 56 frames
ROWS_TOL = dict(rtol=5e-4, atol_scale=3e-6)


class CheckFailed(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)
    print(f"  ok: {what}", flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def brown_noise(rng, batch: int, n: int):
    import numpy as np

    x = rng.standard_normal((batch, n)).astype(np.float32) * 0.1
    return (np.cumsum(x, axis=1) * 0.05).astype(np.float32)


def synth_clips(rng, cfg, n: int, seconds: float):
    """Decoded clips of brown noise at the processing rate, as decode_audio_file
    would return for ``seconds``-long files at the config's file rate."""
    from lbaudiodetective_tpu.io.decode import DecodedAudio

    proc = int(seconds * cfg.processing_sample_rate)
    x = brown_noise(rng, n, proc)
    return [DecodedAudio(x[i], cfg.processing_sample_rate,
                         int(seconds * cfg.file_sample_rate), cfg.file_sample_rate)
            for i in range(n)]


def select_cases(rng):
    """The six cases of the reference's select tests."""
    import numpy as np

    tie = rng.standard_normal((64, 4096)).astype(np.float32)
    tie[:, 1::2] = -tie[:, ::2]
    kb = np.zeros((64, 4096), np.float32)
    kb[:, :50] = 1.5
    kb[:, 100:160] = -1.5
    few = rng.choice(np.float32([0.5, -0.5, 2.0, -2.0, 0.0]), size=(32, 4096))
    few[0] = 0.0
    few[1, ::3] = -0.0
    nan = rng.standard_normal((32, 4096)).astype(np.float32)
    nan[:, 7] = np.nan
    nan[:, 11] = np.inf
    nan[:, 13] = -np.inf
    return {"random": rng.standard_normal((64, 4096)).astype(np.float32),
            "tie_pairs": tie, "k_boundary_ties": kb,
            "zeros_and_few_values": few.astype(np.float32),
            "padding_36_frames": rng.standard_normal((36, 4096)).astype(np.float32),
            "nan_inf": nan}


def numpy_select(x):
    import numpy as np

    keys = ~(x.view(np.uint32) & 0x7FFFFFFF)
    cls = (x > 0).astype(np.int32) + 2 * (x < 0).astype(np.int32)
    order = np.argsort(keys, axis=-1, kind="stable")
    return np.take_along_axis(cls, order, axis=-1)[:, :128]


def phase_select(dev, rng) -> dict:
    import numpy as np
    import torch

    from lbaudiodetective_torch.ops.kernels.select_signs import (
        select_sign_classes, select_sign_classes_plain)

    print("[3] select kernel vs plain", flush=True)
    for name, x in select_cases(rng).items():
        xt = torch.from_numpy(x).to(dev)
        got = select_sign_classes(xt).cpu().numpy()
        plain = select_sign_classes_plain(xt).cpu().numpy()
        check(np.array_equal(got, plain) and np.array_equal(got, numpy_select(x)),
              f"select {name}: element-exact vs plain and numpy stable sort")
    x = torch.randn(SELECT_SHAPE, device=dev)
    got = select_sign_classes(x)
    plain = select_sign_classes_plain(x)
    err = int((got - plain).abs().max())
    check(err == 0, f"select at {list(SELECT_SHAPE)}: element-exact")
    ms = cuda_ms(lambda: select_sign_classes(x))
    plain_ms = cuda_ms(lambda: select_sign_classes_plain(x))
    print(f"  select {list(SELECT_SHAPE)}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms",
          flush=True)
    return {"name": "select_sign_classes", "route": "cuda",
            "source": "lbaudiodetective_torch/csrc/select_signs.cu",
            "replaces": "lbaudiodetective_tpu/ops/pallas/select_signs.py:164",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_rows(dev, rng, batch: int = 4, n_sub: int = 56) -> dict:
    import numpy as np
    import torch

    from lbaudiodetective_tpu.config import FingerprintConfig
    from lbaudiodetective_tpu.oracle.pipeline import oracle_fingerprint
    from lbaudiodetective_torch.ops.constants import constants_to_tensors
    from lbaudiodetective_torch.ops.extract import (
        extract_fingerprint_batch, required_padded_length)
    from lbaudiodetective_torch.ops.kernels.fused_rows import (
        fused_band_rows, fused_band_rows_plain, rows_arrays)
    from lbaudiodetective_torch.ops.kernels.select_signs import select_sign_classes

    print("[4] rows kernel vs plain", flush=True)
    n_rows = n_sub * 128
    record = None
    for kw in (dict(), dict(hop_domain="proc"),
               dict(hop_domain="proc", analysis_stride=128)):
        cfg = FingerprintConfig(**kw)
        hop = int(cfg.hop_in_processing_samples)
        consts = constants_to_tensors(rows_arrays(cfg), dev)
        audio = torch.from_numpy(brown_noise(
            rng, batch, required_padded_length(cfg, n_rows))).to(dev)
        got = fused_band_rows(audio, cfg, n_rows, consts, emit="coeffs")
        exp = fused_band_rows_plain(audio, cfg, n_rows, consts, emit="coeffs")
        scale = float(exp.abs().max())
        err = float((got - exp).abs().max())
        ok = bool(((got - exp).abs() <= ROWS_TOL["atol_scale"] * scale
                   + ROWS_TOL["rtol"] * exp.abs()).all())
        check(ok, f"hop {hop}: coefficients within rtol 5e-4, atol 3e-6*max "
                  f"(max abs err {err:.3e}, max|coeff| {scale:.3e})")
        cls = fused_band_rows(audio, cfg, n_rows, consts, emit="classes")
        cls_a = select_sign_classes(got.reshape(-1, 4096)).reshape(cls.shape)
        check(torch.equal(cls, cls_a), f"hop {hop}: classes element-exact vs "
                                       "select kernel on the kernel's coefficients")
        check(torch.equal(got, fused_band_rows(audio, cfg, n_rows, consts, "coeffs"))
              and torch.equal(cls, fused_band_rows(audio, cfg, n_rows, consts)),
              f"hop {hop}: two runs bit-identical")
        if hop == 8:
            ms = cuda_ms(lambda: fused_band_rows(audio, cfg, n_rows, consts))
            plain_ms = cuda_ms(lambda: fused_band_rows_plain(audio, cfg, n_rows, consts),
                               iters=5)
            print(f"  rows+select [{batch}, {n_rows} rows]: kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms", flush=True)
            main_audio = torch.from_numpy(brown_noise(
                rng, N_CLIPS, required_padded_length(cfg, n_rows))).to(dev)
            main_ms = cuda_ms(lambda: fused_band_rows(main_audio, cfg, n_rows, consts))
            print(f"  rows+select [{N_CLIPS}, {n_rows} rows] (main path): kernel "
                  f"{main_ms:.3f} ms", flush=True)
            record = {"name": "fused_band_rows", "route": "cuda",
                      "source": "lbaudiodetective_torch/csrc/fused_rows.cu",
                      "replaces": "lbaudiodetective_tpu/ops/pallas/fused_rows_v2.py:678",
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "main_shape_ms": main_ms}
    cfg = FingerprintConfig()
    clips = synth_clips(rng, cfg, 2, CLIP_SECONDS)
    pos, neg, n_subs = extract_fingerprint_batch(clips, cfg, device=dev)
    for i, clip in enumerate(clips):
        opos, oneg = oracle_fingerprint(clip, cfg)
        n = n_subs[i]
        check(n == opos.shape[0], f"oracle clip {i}: {n} subfingerprints")
        agree = ((pos[i, :n] == opos).mean() + (neg[i, :n] == oneg).mean()) / 2
        check(agree >= 0.999, f"oracle clip {i}: bit agreement {agree:.5f} >= 0.999")
    return record


def phase_main_path(dev, rng, n_clips: int = N_CLIPS, n_library: int = N_LIBRARY) -> dict:
    import numpy as np
    import torch

    from lbaudiodetective_tpu.config import FingerprintConfig
    from lbaudiodetective_tpu.io.wav import write_wav
    from lbaudiodetective_tpu.models.fingerprint import Fingerprint
    from lbaudiodetective_torch.models.detective import AudioDetective
    from lbaudiodetective_torch.ops.match import match_one_vs_many_padded

    print(f"[5] main path on {dev}", flush=True)
    cfg = FingerprintConfig()
    det = AudioDetective(cfg, device=dev)
    cpu = AudioDetective(cfg, device="cpu")
    clips = synth_clips(rng, cfg, n_clips, CLIP_SECONDS)
    out = {}

    t0 = time.perf_counter()
    fps = det.process_decoded_batch(clips)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["first_batch_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fps2 = det.process_decoded_batch(clips)
    out["batch_s"] = time.perf_counter() - t0
    out["clips_per_s"] = n_clips / out["batch_s"]
    check(len(fps) == n_clips and all(f.num_subfingerprints == 53 for f in fps),
          f"{n_clips} fingerprints of 53 subfingerprints")
    check(all(a == b for a, b in zip(fps, fps2)), "repeated batch bit-identical")
    print(f"  process_decoded_batch({n_clips} x {CLIP_SECONDS:g} s): "
          f"{out['batch_s'] * 1e3:.1f} ms warm ({out['clips_per_s']:.1f} clips/s), "
          f"first call {out['first_batch_s'] * 1e3:.1f} ms", flush=True)
    ref = cpu.process_decoded_batch(clips[:2])
    for i, f in enumerate(ref):
        agree = ((f.pos == fps[i].pos).mean() + (f.neg == fps[i].neg).mean()) / 2
        check(agree >= 0.999, f"clip {i}: {agree:.5f} of bits equal to the CPU path")

    with tempfile.TemporaryDirectory() as tmp:
        long_wav = f"{tmp}/long.wav"
        short_a, short_b = f"{tmp}/short_a.wav", f"{tmp}/short_b.wav"
        sig = brown_noise(rng, 1, int(CLIP_SECONDS * 44100))[0]
        sig = 0.5 * sig / np.abs(sig).max()
        write_wav(long_wav, sig, 44100)
        write_wav(short_a, sig[:66150], 44100)
        write_wav(short_b, sig[:66150] + 0.01 * rng.standard_normal(66150)
                  .astype(np.float32), 44100)
        fp_long = det.process_audio_file(long_wav)
        check(fp_long.num_subfingerprints == 53, "process_audio_file: 53 subfingerprints")
        score = det.compare_audio_files(short_a, short_b)
        cpu_score = cpu.compare_fingerprints(det.process_audio_file(short_a),
                                             det.process_audio_file(short_b))
        check(0.0 < score <= 1.0 and abs(score - cpu_score) <= 1e-6,
              f"compare_audio_files: {score:.6f} (CPU matcher {cpu_score:.6f})")

    query = fps[0]
    lib_rng = np.random.default_rng(7)
    library = [query]
    for i in range(1, n_library):
        f = fps[i % n_clips]
        cls = f.pos.astype(np.int8) + 2 * f.neg.astype(np.int8)
        flip = lib_rng.random(cls.shape) < 0.15
        cls = np.where(flip, lib_rng.integers(0, 3, cls.shape), cls)
        library.append(Fingerprint.from_planes(cls == 1, cls == 2, f.subfingerprint_length))
    t0 = time.perf_counter()
    scores = det.match_against_library(query, library)
    out["match_call_s"] = time.perf_counter() - t0
    check(scores.shape == (n_library,) and np.isfinite(scores).all(),
          f"{n_library} finite scores")
    check(int(np.argmax(scores)) == 0 and scores[0] == 1.0
          and scores[1:].max() < 1.0, "the query's own entry scores highest (1.0)")
    cpu_scores = cpu.match_against_library(query, library[:256])
    err = float(np.abs(cpu_scores - scores[:256]).max())
    check(err <= 1e-6, f"GPU scores equal CPU scores on 256 entries (max err {err:.2e})")

    s = 56
    lp = torch.zeros((n_library, s, query.pairs), dtype=torch.uint8)
    ln = torch.zeros_like(lp)
    for i, f in enumerate(library):
        lp[i, :f.num_subfingerprints] = torch.from_numpy(f.pos)
        ln[i, :f.num_subfingerprints] = torch.from_numpy(f.neg)
    n_lib = torch.tensor([f.num_subfingerprints for f in library]).to(dev)
    lp, ln = lp.to(dev), ln.to(dev)
    qp, qn = lp[0].clone(), ln[0].clone()
    nq = torch.tensor(query.num_subfingerprints, device=dev)
    if dev.type == "cuda":
        out["match_ms"] = cuda_ms(lambda: match_one_vs_many_padded(qp, qn, nq, lp, ln, n_lib))
    print(f"  match_against_library(1 x {n_library}): call {out['match_call_s'] * 1e3:.1f} ms"
          f"; device {out.get('match_ms', float('nan')):.3f} ms", flush=True)
    return out


def nvidia_smi_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True)
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("CUDA is not available: this script needs one GPU", file=sys.stderr)
        return 1
    if not (ROOT / "lbaudiodetective_torch").is_dir():
        print("lbaudiodetective_torch/ is missing beside chip_smoke.py", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from lbaudiodetective_torch.ops import kernels
    from lbaudiodetective_torch.ops.kernels._build import load_library

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(f"[1] nvidia-smi: {smi}", flush=True)
    nvcc = subprocess.run(["/usr/local/cuda/bin/nvcc", "--version"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc[-1] if nvcc else 'not found'}", flush=True)

    t0 = time.perf_counter()
    load_library()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(0)
    records = [phase_select(dev, rng), phase_rows(dev, rng)]

    kernels.reset_launch_counts()
    main_out = phase_main_path(dev, rng)
    counts = kernels.launch_counts()
    for name, n in counts.items():
        check(n > 0, f"main path launched {name} {n} times")
    for r in records:
        r["launches"] = counts[r["name"]]
    check("jax" not in sys.modules, "no JAX module was imported")
    print(f"  on {smi}: {main_out['clips_per_s']:.1f} clips/s at B={N_CLIPS}, "
          f"1 x {N_LIBRARY} match {main_out['match_ms']:.3f} ms", flush=True)

    print(json.dumps({"main_path": main_out}))
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
