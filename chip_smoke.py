#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's extract -> match path, its packed library
path, every extraction config, the C-API layer, 256-stream streaming, the
HTTP identification service with live sessions, the streaming identifier,
MAA, the long matchers and the sharded layer once on one GPU.

    python3 chip_smoke.py

Phases (each failed check raises, and the script exits non-zero):

1. Device report: ``nvidia-smi`` name and power limit, torch/CUDA/nvcc.
2. Build the kernels from ``lbaudiodetective_torch/csrc/`` with nvcc and
   print ``ptxas -v``'s registers, spills and shared memory of each kernel.
3. Select kernel vs its plain version: element-exact on eight cases (the
   six of the reference's tests, all zeros, 200 equal maxima), timed at the
   main-path shape [14336, 4096] beside ``torch.topk`` on the same int64
   keys (a yardstick the port never calls).
4. Rows kernel vs its plain version at hop 8, 64 and 128 (batch 4):
   coefficients within rtol 5e-4, atol 3e-6 * max|coeff| of the plain
   version evaluated in float64 (its float32 evaluation's distance printed
   beside it); classes
   element-exact against the select kernel on the rows kernel's own
   coefficients; two runs bit-identical; at hop 8 a NaN and a +inf sample
   zero only the windows that hold them; >= 99.9% of bits against the NumPy
   oracle on two clips; its time at batch 4 and at the main path's
   [256, 7168 rows] beside its bound and the plain version's (in slices of
   64 clips), and every clip of that shape within the bar of the plain
   version in float64.
5. Main path through ``AudioDetective(device="cuda")``: 256 ten-second
   clips in parity mode, a written WAV, a compare of two written WAVs, and
   one query against a 16,384-entry library (the packed match kernel).
   Scores on a 256-entry sub-library equal the CPU path's within 1e-6; the
   rows and match kernels' launch counts over this phase are > 0 (the rows
   kernel selects in place).
6. Library path on a 1,048,576-entry packed library (BASELINE config 5's
   1M tracks; 31-80 subfingerprints an entry, built on the card from a
   seed, with phase 5's fingerprints and near-duplicates planted).  First
   the match kernel vs its plain version on 4,096-entry slices (ranges 0,
   100, 37, 64; W=4 and W=2; ragged counts; and the coarse pass's shape:
   2 queries x 4 phases of 20 rows vs the strided library at range 64),
   bit-equal, and its time at 65,536 and 1M entries and for the coarse pass
   over 1M, each beside the bytes the scan needs and its __popc count (at
   16 a clock an SM).  Then, with the launch counts reset,
   ``FingerprintLibrary.match`` over 1M, ``search`` at the shipped
   defaults for 16 planted queries (top-1 = the full scan's argmax, score
   equal to its bit), ``search_many``/``match_many`` at B=8, ``extend``,
   ``save``/``load`` on a 16,384-entry sub-library, and the CLI's
   ``enroll`` + ``identify --top-k 3``; the match kernel's launch count
   over this part is > 0.

7. Every extraction config.  The band-rows kernel (``csrc/band_rows.cu``,
   3xTF32 stage 2) against its plain version evaluated in float64 at batch
   4 and 7,168 rows: rows mode at the four fractional-hop configs (kernel
   5), coefficients mode at pitch_step_count=16, rows_per_frame=256 and
   subfingerprint_length=300 (kernel 2 at other geometries), and rows and
   coefficients at hop 8 (kernel 4 with and without fuse_haar); within rtol
   5e-4, atol 3e-6 * max (the largest error printed as a share of its bar,
   and the float32 plain version's own share beside it), two runs
   bit-identical, a NaN and a +inf sample zeroing only their windows,
   >= 99.9% of bits against the NumPy oracle on two clips at
   integer_hop=False and at pitch_step_count=16; times at [4, 7168 rows]
   beside the plain version and the 3xTF32 bound, and at [256, 7168 rows],
   the main path's launch shape, where every clip is held against the
   plain version in float64 in slices of 16.  Then, with the launch counts
   reset, ``AudioDetective(integer_hop=False)`` on 256 ten-second clips
   and the C-API layer on the card
   (``LBAudioDetectiveNew(device="cuda")``, the geometry setters,
   ``ProcessAudioURL``/``CompareAudioURLs`` on written WAVs), their bits
   held to the NumPy oracle, their subfingerprint counts and scores to the
   CPU port; the band-rows kernel's launch count over this part is > 0.
8. Streaming, BASELINE config 4: ``StreamingExtractor(batch=256,
   device="cuda")`` fed 10 s a stream on the aligned path (chunk 1024,
   bit-equal to offline extraction on the card), the conv path (chunk 512)
   and the fractional-hop gather path (chunk 1024), >= 99.9% of bits
   against offline; ``torch.cuda.set_sync_debug_mode("error")`` while the
   streams are fed, so no step makes the host wait; the real-time factor of
   each; the essay's streaming names on a CUDA ``StreamingDetective``.  The
   select and rows kernels' launch counts over the timed feeds and the
   streaming names (not the offline references) are > 0.
9. The HTTP service (``serving.py``) at the default config: phase 5's
   16,384 entries (names ``track_<i>``; the 256 clips' fingerprints and 8
   written 10 s WAV clips' planted) behind ``make_server`` on 127.0.0.1 in
   a thread, batch window 0.02 s, max batch 8, so requests take the
   two-stage search.  8 concurrent ``/identify`` with the WAVs' bytes (each
   names its planted track; ``"top"`` equal to ``library.search`` bit for
   bit; fewer than 8 extraction dispatches), ``/identify-fingerprint``,
   ``/fingerprint`` of a 10 s and a 1.5 s clip (equal to
   ``process_decoded``; the short one's single-step dispatch runs the
   standalone select kernel), ``/healthz``, a malformed body and an
   unknown session (400); a 4,096-entry slice answering with every score
   (equal to ``library.match``).  Then 16 per-session and 64 pooled live
   sessions post planted fingerprints 8 subfingerprints at a time over
   HTTP; halfway, ``save_sessions`` -> a fresh service -> ``load_sessions``
   and posting goes on there.  After every post the top-1 equals the
   argmax of ``library.match_many`` on the accumulated fingerprint, score
   bit-equal.  Prints p50/p95 latency of ``/identify`` and of the posts,
   and posts/s.
10. The streaming identifier at BASELINE config 4's size: 256 streams x
   10 s (phase 5's clips) against the same library, chunk 1024, a match
   every 4 subfingerprints, ``rematch="full"`` (the match kernel, one
   launch a tick) and ``"incremental"`` (groups of 32): equal winners and
   bit-equal scores after every chunk, every stream naming its planted
   track; stream-seconds per second of each and its peak device memory.
   The rows, match and pooled fold kernels' launch counts over phases
   9-10 (requests and feeds, not the offline references) are > 0.
10b. The pooled fold kernel (``csrc/slot_fold.cu``) at the live cell's
   geometry (65,536 tracks of 31-80 rows, 64 slots): the whole state
   bit-equal to its plain version after a flush of 1, 8 and 64 posting
   slots of 8 rows, and each flush's time beside its bytes bound, the
   plain version's and the all-slot GEMM and per-arrival fold it replaced
   (``parent_fold``), which the kernel must not be slower than at 64.
11. ``maa_compare_audio_files`` on two written 44.1 kHz WAVs (a
   window-aligned crop: >= 90 % of windows match, equal to the CPU port),
   and ``match_long_padded`` over a one-hour fp1 (19,398 subfingerprints,
   chunks of 512) against a 10 s query planted with 10 % of its bits
   flipped: within 1e-6 of ``match_fingerprints``, and
   ``match_long_hierarchical`` finding the same peak.
12. The sharded layer (``parallel/``) on a mesh of 4 slots of the one card,
   each path held to its unsharded run: (a) phase 6's 1M library (rebuilt
   from its seed) as a 4-way
   ``ShardedFingerprintLibrary`` (the shards views): ``match`` of the 16
   planted queries bit-equal to ``FingerprintLibrary.match``; ``search``
   and ``search_many`` x8 with the library's top-1 and score, every score
   exact and none below the library's at its rank (each shard shortlists
   its own 1,024); walls and extra peak memory; (b) ring dedup (k = 8) of
   phase 9's 16,384 tracks: top-8 scores equal to one slot's, and scores
   and indices equal to the top-8 of one [16,384, 16,384] launch (itself
   equal to the plain matcher at 64 queries) taken in the ring's candidate
   order (an equal score to the earlier ring step, as ``lax.top_k`` folds
   it), every planted near-duplicate naming its original; (c) ring
   all-pairs on 4,096 entries equal to one launch; (d) data-parallel
   extraction of phase 5's clips bit-equal to its fingerprints; (e) the
   time-sharded long match within 1e-5 of phase 11's; (f)
   ``PipelinedIdentifier`` of 4 x 64 clips equal to ``match_many``, its
   submits' host walls beside a serial loop; (g) ``DeviceSplitPipeline``
   (extract on slots 0-1, match on 2-3) equal to (f); (h)
   ``StreamingExtractor(mesh=...)`` on the aligned and conv steps bit-equal
   to the unsharded extractor, no host wait, RTF beside phase 8's; (i) the
   streaming identifier (both modes) and 8 concurrent ``/identify`` on the
   sharded 16,384 library equal to phases 9-10.  The select, rows and
   match kernels each launch in phase 12's sharded calls (the unsharded
   references and plain versions are not counted).

The last three lines are the kernels' JSON record (each kernel's time,
its plain version's and, where one PyTorch call computes the same function,
that call's, beside ``bound_ms``: the larger of its bytes over 3.35 TB/s
and its operations over the H100's peak for their type, 67 TFLOP/s FP32,
495 TFLOP/s TF32; the match kernel's also at 1M entries and for the coarse
pass: ``ms_1m``, ``bound_ms_1m``, ``coarse_ms_1m``, ``coarse_bound_ms_1m``),
the ``nvidia-smi`` name and power limit, and the device JSON.
Needs one CUDA card; without one it exits 1 and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import json
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
N_CLIPS = 256
CLIP_SECONDS = 10.0
N_LIBRARY = 16384
N_BIG = 1 << 20                  # BASELINE config 5: 1M tracks
BIG_S = 80                       # subfingerprint bucket of 5-15 s clips
MATCH_TOL = 1e-6
SELECT_SHAPE = (14336, 4096)     # 256 clips x 56 frames
ROWS_TOL = dict(rtol=5e-4, atol_scale=3e-6)
ROWS_SLICE = 64                  # clips a plain-version slice of phase 4's main shape
#: H100 SXM peaks (NVIDIA's data sheet, dense, 700 W): device memory bytes/s,
#: FP32 FLOP/s outside the tensor cores, TF32 tensor-core FLOP/s.
PEAK = {"bytes": 3.35e12, "fp32": 67e12, "tf32": 495e12}


class CheckFailed(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)
    print(f"  ok: {what}", flush=True)


def check_quiet(cond: bool, what: str) -> None:
    """``check`` without the line printed when it holds (per-request checks)."""
    if not cond:
        raise CheckFailed(what)


def bound(n_bytes: float, **flops: float) -> dict:
    """The least time the card could take: the larger of ``n_bytes`` over
    the memory rate and each type's operations over its peak (pipes of
    different types overlapping)."""
    times = {"bytes": n_bytes / PEAK["bytes"] * 1e3}
    times.update({kind: n / PEAK[kind] * 1e3 for kind, n in flops.items()})
    by = max(times, key=times.get)
    return {"bound_ms": times[by], "bound_by": "bytes" if by == "bytes" else "operations"}


def rows_fma(cfg, n_windows: int, haar: bool) -> dict:
    """FMA of the rows kernels for ``n_windows`` windows at ``cfg``: the
    16-tap stage 1 (re, im) over window/16 values of b and 16 residues, the
    complex stage 2 over k_max slots a residue (4 real FMA a term), the band
    projection, and the frame's two Haar products."""
    from lbaudiodetective_torch.ops.constants import kernel_constants

    k_max = kernel_constants(cfg)[5]
    b_len, bands, rpf = cfg.window_size // 16, cfg.pitch_step_count, cfg.rows_per_frame
    out = {"stage1": n_windows * 16 * b_len * 16 * 2,
           "stage2": n_windows * b_len * k_max * 16 * 4,
           "projection": n_windows * 16 * k_max * bands}
    out["haar"] = n_windows * (bands * bands + rpf * bands) if haar else 0
    return out


def rows_bound(cfg, audio, n_rows: int, haar: bool = True,
               out_bytes: int | None = None) -> tuple[dict, float, float, float]:
    """Bound of a rows kernel on ``audio``: its stage 2 in 3xTF32 on the
    tensor cores, the rest FP32, the audio read once and the output written
    once (``out_bytes``; the fused kernel's classes by default).  Also the
    time if the two pipes do not overlap, and the TF32 and FP32 operations."""
    fma = rows_fma(cfg, audio.shape[0] * n_rows, haar=haar)
    tf32 = fma["stage2"] * 2 * 3
    fp32 = (fma["stage1"] + fma["projection"] + fma["haar"]) * 2
    if out_bytes is None:
        out_bytes = audio.shape[0] * n_rows * 4
    b = bound(audio.numel() * 4 + out_bytes, tf32=tf32, fp32=fp32)
    return b, (tf32 / PEAK["tf32"] + fp32 / PEAK["fp32"]) * 1e3, tf32, fp32


def band_rows_bound(cfg, audio, n_rows: int, coeffs: bool) -> tuple[dict, float]:
    """Bound of the band-rows kernel (its stage 2 in 3xTF32, as the fused
    kernel's) writing ``[B, n_rows, bands]`` float32, and the time if the
    tensor-core and FP32 pipes do not overlap."""
    b, serial_ms, _, _ = rows_bound(cfg, audio, n_rows, haar=coeffs,
                                    out_bytes=audio.shape[0] * n_rows * cfg.pitch_step_count * 4)
    return b, serial_ms


def scan_work(q_counts, lib_counts, w: int, mask_pairs: int) -> tuple[int, int]:
    """What a one-vs-many scan needs: the bytes (each entry's valid rows of
    the compared words of both planes, the counts, the query's valid rows,
    one score a (query, entry)) and the __popc (one a compared word for each
    row of each offset of the orientation the reference selects: a
    fingerprint row's pos and neg bits are disjoint, so one popc of
    (Pl & Pq) | (Nl & Nq) counts both planes' hits)."""
    wu = min(w, (mask_pairs + 31) // 32)
    nl = lib_counts.to("cpu").long()
    q = [int(x) for x in q_counts.to("cpu")]
    n_bytes = int(nl.sum()) * wu * 8 + nl.numel() * 4 + sum(q) * wu * 8 + len(q) * nl.numel() * 4
    popc = 0
    for nq in q:
        if nq > 0:
            n_off = ((nl - nq).abs() + 1) * (nl > 0)
            popc += int((n_off * nl.clamp(max=nq)).sum()) * wu
    return n_bytes, popc


def popc_ms(popc: int, sm_mhz: float) -> float:
    """Time of ``popc`` __popc on the CUDA cores at 16 a clock an SM."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return popc / (16 * sms * sm_mhz * 1e6) * 1e3


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
    from lbaudiodetective_torch.io.decode import DecodedAudio

    proc = int(seconds * cfg.processing_sample_rate)
    x = brown_noise(rng, n, proc)
    return [DecodedAudio(x[i], cfg.processing_sample_rate,
                         int(seconds * cfg.file_sample_rate), cfg.file_sample_rate)
            for i in range(n)]


def select_cases(rng):
    """The six cases of the reference's select tests, a frame set of all
    zeros and one with 200 equal maxima (ties across the 128th key)."""
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
    maxima = rng.standard_normal((16, 4096)).astype(np.float32)
    for f in maxima:
        f[rng.choice(4096, 200, replace=False)] = np.float32(9.5) * rng.choice([-1, 1], 200)
    return {"random": rng.standard_normal((64, 4096)).astype(np.float32),
            "tie_pairs": tie, "k_boundary_ties": kb,
            "zeros_and_few_values": few.astype(np.float32),
            "padding_36_frames": rng.standard_normal((36, 4096)).astype(np.float32),
            "nan_inf": nan, "all_zeros": np.zeros((8, 4096), np.float32),
            "ties_200_maxima": maxima}


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
    # The yardstick: torch.topk over the kernel's unique int64 keys
    # (abs_bits << 32 | (4095 - idx) << 1 | pos), built outside the timing.
    bits = x.view(torch.int32).to(torch.int64)
    abs_bits = bits & 0x7FFFFFFF
    pos = ((bits >= 0) & (abs_bits > 0)).to(torch.int64)
    keys = (abs_bits << 32) | ((4095 - torch.arange(4096, device=dev)) << 1) | pos
    top = torch.topk(keys, 128, dim=-1).values
    top_abs = top >> 32
    top_cls = torch.where((top_abs > 0) & (top_abs <= 0x7F800000), 2 - (top & 1), 0)
    check(torch.equal(top_cls.to(torch.int32), got), "torch.topk on the keys gives the "
                                                     "kernel's classes")
    ms = cuda_ms(lambda: select_sign_classes(x))
    plain_ms = cuda_ms(lambda: select_sign_classes_plain(x))
    library_ms = cuda_ms(lambda: torch.topk(keys, 128, dim=-1))
    b = bound(x.numel() * 4 + got.numel() * 4)
    print(f"  select {list(SELECT_SHAPE)}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"torch.topk on the keys {library_ms:.3f} ms, bound {b['bound_ms']:.3f} ms "
          f"({b['bound_by']})", flush=True)
    check(ms <= library_ms, f"select kernel ({ms:.3f} ms) no slower than torch.topk "
                            f"({library_ms:.3f} ms)")
    return {"name": "select_sign_classes", "route": "cuda",
            "source": "lbaudiodetective_torch/csrc/select_signs.cu",
            "replaces": "lbaudiodetective_tpu/ops/pallas/select_signs.py:164",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": library_ms}


def within_rows_tol(got, exp) -> tuple[bool, float, float]:
    scale = float(exp.abs().max())
    diff = (got - exp).abs()
    ok = bool((diff <= ROWS_TOL["atol_scale"] * scale + ROWS_TOL["rtol"] * exp.abs()).all())
    return ok, float(diff.max()), scale


def bar_share(got, exp) -> float:
    """The largest error as a share of its element's bar (<= 1 passes)."""
    bar = ROWS_TOL["atol_scale"] * float(exp.abs().max()) + ROWS_TOL["rtol"] * exp.abs()
    return float(((got - exp).abs() / bar).max())


def oracle_agreement(dev, rng, cfg, what: str) -> None:
    """Two ten-second clips extracted on the card vs the NumPy oracle."""
    from lbaudiodetective_torch.oracle.pipeline import oracle_fingerprint
    from lbaudiodetective_torch.ops.extract import extract_fingerprint_batch

    clips = synth_clips(rng, cfg, 2, CLIP_SECONDS)
    pos, neg, n_subs = extract_fingerprint_batch(clips, cfg, device=dev)
    for i, clip in enumerate(clips):
        opos, oneg = oracle_fingerprint(clip, cfg)
        n = n_subs[i]
        agree = ((pos[i, :n] == opos).mean() + (neg[i, :n] == oneg).mean()) / 2
        check(n == opos.shape[0] and agree >= 0.999,
              f"{what}: oracle clip {i}, {n} subfingerprints, bit agreement {agree:.5f}")


def phase_rows(dev, rng, batch: int = 4, n_sub: int = 56) -> dict:
    import torch

    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch.ops.constants import constants_to_tensors
    from lbaudiodetective_torch.ops.extract import required_padded_length
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
        # The plain version, evaluated in float64 and in float32.  The kernel
        # (3xTF32 stage 2 on the residue-0 remainder) is held to the float64
        # evaluation; the float32 one carries its own rounding of the
        # windows' large low-frequency content, shown beside it.
        exp = fused_band_rows_plain(audio.double(), cfg, n_rows,
                                    {k: v.double() for k, v in consts.items()}, emit="coeffs")
        exp32 = fused_band_rows_plain(audio, cfg, n_rows, consts, emit="coeffs").double()
        ok, err, scale = within_rows_tol(got.double(), exp)
        _, err32, _ = within_rows_tol(got.double(), exp32)
        _, plain_err, _ = within_rows_tol(exp32, exp)
        check(ok, f"hop {hop}: coefficients within rtol 5e-4, atol 3e-6*max of the plain "
                  f"version in float64 (max abs err {err:.3e}, max|coeff| {scale:.3e}, largest "
                  f"error {bar_share(got.double(), exp):.3f} of its bar; against the float32 "
                  f"evaluation {err32:.3e}, which is {plain_err:.3e} and "
                  f"{bar_share(exp32, exp):.3f} of the bar from float64)")
        cls = fused_band_rows(audio, cfg, n_rows, consts, emit="classes")
        cls_a = select_sign_classes(got.reshape(-1, 4096)).reshape(cls.shape)
        check(torch.equal(cls, cls_a), f"hop {hop}: classes element-exact vs "
                                       "select kernel on the kernel's coefficients")
        check(torch.equal(got, fused_band_rows(audio, cfg, n_rows, consts, "coeffs"))
              and torch.equal(cls, fused_band_rows(audio, cfg, n_rows, consts)),
              f"hop {hop}: two runs bit-identical")
        if hop != 8:
            continue
        # A NaN at a tile's first sample and +inf at a clip's first sample
        # zero only the windows that hold them, as in the plain version.
        bad = audio.clone()
        bad[0, 128 * hop] = float("nan")
        bad[1, 0] = float("inf")
        got_bad = fused_band_rows(bad, cfg, n_rows, consts, emit="coeffs")
        ok, e, _ = within_rows_tol(got_bad.double(), fused_band_rows_plain(
            bad.double(), cfg, n_rows, {k: v.double() for k, v in consts.items()}, "coeffs"))
        check(ok and bool(got_bad.isfinite().all()),
              f"hop {hop}, NaN and +inf samples: coefficients finite and within the bar of "
              f"the plain version in float64 (max abs err {e:.3e})")
        ms = cuda_ms(lambda: fused_band_rows(audio, cfg, n_rows, consts))
        plain_ms = cuda_ms(lambda: fused_band_rows_plain(audio, cfg, n_rows, consts), iters=5)
        b, _, _, _ = rows_bound(cfg, audio, n_rows)
        print(f"  rows+select [{batch}, {n_rows} rows]: kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']})",
              flush=True)
        main_audio = torch.from_numpy(brown_noise(
            rng, N_CLIPS, required_padded_length(cfg, n_rows))).to(dev)
        main_ms = cuda_ms(lambda: fused_band_rows(main_audio, cfg, n_rows, consts))
        main_plain_ms = sum(cuda_ms(lambda: fused_band_rows_plain(
            main_audio[i:i + ROWS_SLICE], cfg, n_rows, consts), iters=2, warmup=1)
            for i in range(0, N_CLIPS, ROWS_SLICE))
        main_b, serial_ms, tf32, fp32 = rows_bound(cfg, main_audio, n_rows)
        print(f"  rows+select [{N_CLIPS}, {n_rows} rows] (main path): kernel {main_ms:.3f} "
              f"ms, plain {main_plain_ms:.3f} ms ({N_CLIPS // ROWS_SLICE} slices of "
              f"{ROWS_SLICE}), bound {main_b['bound_ms']:.3f} ms ({main_b['bound_by']}: "
              f"{tf32 / 1e12:.3f} TFLOP TF32, {fp32 / 1e12:.3f} TFLOP FP32; {serial_ms:.3f} ms "
              f"if the pipes do not overlap)", flush=True)
        # The main path's launch shape, every clip against the plain version
        # in float64, slice by slice.
        got = fused_band_rows(main_audio, cfg, n_rows, consts, emit="coeffs")
        worst, share, failed = 0.0, 0.0, []
        for i in range(0, N_CLIPS, ROWS_SLICE):
            exp = fused_band_rows_plain(main_audio[i:i + ROWS_SLICE].double(), cfg, n_rows,
                                        {k: v.double() for k, v in consts.items()}, "coeffs")
            ok, e, _ = within_rows_tol(got[i:i + ROWS_SLICE].double(), exp)
            worst, share = max(worst, e), max(share, bar_share(got[i:i + ROWS_SLICE].double(),
                                                               exp))
            if not ok:
                failed.append(i)
        check(not failed, f"coefficients at [{N_CLIPS}, {n_rows} rows]: every clip within "
                          f"rtol 5e-4, atol 3e-6*max of its slice of the plain version in "
                          f"float64 (max abs err {worst:.3e}, largest error {share:.3f} of its "
                          f"bar; slices failing at clips {failed})")
        record = {"name": "fused_band_rows", "route": "cuda",
                  "source": "lbaudiodetective_torch/csrc/fused_rows.cu",
                  "replaces": "lbaudiodetective_tpu/ops/pallas/fused_rows_v2.py:678",
                  "max_abs_err": max(err, worst), "ms": ms, "plain_ms": plain_ms, **b,
                  "library_ms": None, "main_shape_ms": main_ms,
                  "main_shape_plain_ms": main_plain_ms,
                  "main_shape_bound_ms": main_b["bound_ms"],
                  "main_shape_bound_serial_ms": serial_ms}
    oracle_agreement(dev, rng, FingerprintConfig(), "parity")
    return record


def phase_main_path(dev, rng, n_clips: int = N_CLIPS, n_library: int = N_LIBRARY) -> tuple:
    import numpy as np
    import torch

    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch.io.wav import write_wav
    from lbaudiodetective_torch.models.fingerprint import Fingerprint
    from lbaudiodetective_torch.models.detective import AudioDetective

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

    print(f"  match_against_library(1 x {n_library}): call "
          f"{out['match_call_s'] * 1e3:.1f} ms", flush=True)
    return out, fps, library, clips


def time_library_match(dev, library) -> dict:
    """Device time of the call ``match_against_library`` makes on phase 5's
    library (one packed kernel launch), and of PR 1's unpacked plain-torch
    matcher on the same entries; run after phase 5's launch counts are read."""
    import numpy as np
    import torch

    from lbaudiodetective_torch.utils.packing import words_per_plane
    from lbaudiodetective_torch.models.library import pack_fingerprints
    from lbaudiodetective_torch.ops.extract import bucket_subfingerprints
    from lbaudiodetective_torch.ops.match import match_one_vs_many_padded
    from lbaudiodetective_torch.ops.match_packed import match_one_vs_many_packed

    s = bucket_subfingerprints(max(f.num_subfingerprints for f in library))
    pairs = library[0].pairs
    pw, nw, n_lib = (torch.from_numpy(a.view(np.int32)).to(dev)
                     for a in pack_fingerprints(library, s, words_per_plane(pairs)))
    out = {"match_ms": cuda_ms(lambda: match_one_vs_many_packed(
        pw[:1], nw[:1], n_lib[:1], pw, nw, n_lib, pairs))}
    lp = torch.zeros((len(library), s, pairs), dtype=torch.uint8)
    ln = torch.zeros_like(lp)
    for i, f in enumerate(library):
        lp[i, :f.num_subfingerprints] = torch.from_numpy(f.pos)
        ln[i, :f.num_subfingerprints] = torch.from_numpy(f.neg)
    lp, ln = lp.to(dev), ln.to(dev)
    out["unpacked_plain_match_ms"] = cuda_ms(lambda: match_one_vs_many_padded(
        lp[0], ln[0], n_lib[0], lp, ln, n_lib))
    print(f"  1 x {len(library)} match on the device: {out['match_ms']:.3f} ms (packed "
          f"kernel), {out['unpacked_plain_match_ms']:.3f} ms (unpacked plain matcher)",
          flush=True)
    return out


def random_words(gen, dev, n: int, s: int, pairs: int):
    """``[n, s, W]`` int32 (pos, neg) words and ``[n]`` counts in 31..80:
    signs at random, ~3 % of pairs zero, pos/neg disjoint, bits above
    ``pairs`` and rows past each count zero."""
    import numpy as np
    import torch

    from lbaudiodetective_torch.utils.packing import words_per_plane
    from lbaudiodetective_torch.ops.kernels.match_packed import prefix_mask_words

    w = words_per_plane(pairs)

    def rand():
        return torch.randint(0, 256, (n, s, 4 * w), dtype=torch.uint8, generator=gen,
                             device=dev).view(torch.int32)

    counts = torch.randint(31, 81, (n,), dtype=torch.int32, generator=gen, device=dev)
    sign = rand()
    nz = ~(rand() & rand() & rand() & rand() & rand())
    bits = torch.from_numpy(prefix_mask_words(pairs, w).view(np.int32)).to(dev)
    past = (torch.arange(s, device=dev) >= counts[:, None])[..., None]
    pos = (sign & nz & bits).masked_fill_(past, 0)
    neg = (~sign & nz & bits).masked_fill_(past, 0)
    return pos, neg, counts


def plant(lib, idx: int, fp) -> None:
    """Write fingerprint ``fp`` into entry ``idx`` of a library in place."""
    import torch

    pw, nw = fp.packed()
    n = fp.num_subfingerprints
    lib.pos_words[idx].zero_()
    lib.neg_words[idx].zero_()
    lib.pos_words[idx, :n] = torch.from_numpy(pw.view("int32")).to(lib.device)
    lib.neg_words[idx, :n] = torch.from_numpy(nw.view("int32")).to(lib.device)
    lib.counts[idx] = n


def flipped(fp, rng, rate: float = 0.05):
    import numpy as np

    from lbaudiodetective_torch.models.fingerprint import Fingerprint

    flips = rng.random(fp.pos.shape) < rate
    pos = np.where(flips, 1 - fp.pos, fp.pos).astype(np.uint8)
    return Fingerprint(pos, (fp.neg * (1 - pos)).astype(np.uint8))


def build_big_library(dev, fps):
    """The 1M-entry library with phase 5's fingerprints planted: the
    originals of clips 0-15, and for clips 0-7 crops at offsets 1-3 and a
    5 % bit-flip copy.  Returns the library, the 16 planted queries (5 %
    flips of clips 0-7 drawn anew, crops of clips 8-15 at offsets 1-3),
    each query's planted original and the clip of every planted entry."""
    import numpy as np
    import torch

    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch.models.fingerprint import Fingerprint
    from lbaudiodetective_torch.models.library import FingerprintLibrary

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    lib = FingerprintLibrary(*random_words(gen, dev, N_BIG, BIG_S, 100), 100,
                             FingerprintConfig())
    rng = np.random.default_rng(6)
    slots = rng.choice(N_BIG, size=16 + 8 * 4, replace=False)
    for i in range(16):
        plant(lib, int(slots[i]), fps[i])
    dups = [Fingerprint(fps[i].pos[k:], fps[i].neg[k:]) for i in range(8) for k in (1, 2, 3)]
    dups += [flipped(fps[i], rng) for i in range(8)]
    for slot, fp in zip(slots[16:], dups):
        plant(lib, int(slot), fp)
    queries = [flipped(fps[i], rng) for i in range(8)]
    queries += [Fingerprint(fps[i].pos[1 + i % 3:], fps[i].neg[1 + i % 3:])
                for i in range(8, 16)]
    clip_of = dict(zip(slots.tolist(), list(range(16)) + [i for i in range(8) for _ in "123"]
                       + list(range(8))))
    return lib, queries, [int(x) for x in slots[:16]], clip_of


def phase_match_kernel(dev, lib, queries, smi: str, sm_mhz: float) -> dict:
    """The match kernel against its plain version (bit-equal), and its
    times beside the bytes bound and the __popc count of each scan."""
    import numpy as np
    import torch

    from lbaudiodetective_torch.models.library import CHUNK, stack_query_planes
    from lbaudiodetective_torch.ops.kernels.match_packed import (
        match_one_vs_many_fused, match_one_vs_many_fused_plain)
    from lbaudiodetective_torch.ops.match_packed import (
        _mask_pairs, phase_strided_query_planes)

    print("[6a] match kernel vs plain", flush=True)
    err = 0.0
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    w2 = random_words(gen, dev, 4096, BIG_S, 64)
    for pairs, length, (lp, ln, nl), ranges in (
            (100, 200, (lib.pos_words[:4096], lib.neg_words[:4096], lib.counts[:4096]),
             (0, 100, 37, 64)),
            (64, 128, w2, (0, 37))):
        nl = nl.clone()
        nl[:3] = torch.tensor([0, 5, int(nl[3])])          # empty, shorter, equal
        qp, qn = lp[[3, 100]].contiguous(), ln[[3, 100]].contiguous()
        nq = nl[[3, 100]].contiguous()
        for cr in ranges:
            m = _mask_pairs(pairs, cr, length)
            got = match_one_vs_many_fused(qp, qn, nq, lp, ln, nl, m)
            exp = match_one_vs_many_fused_plain(qp, qn, nq, lp, ln, nl, m)
            e = float((got - exp).abs().max())
            err = max(err, e)
            check(torch.equal(got, exp), f"W={lp.shape[2]} range {cr}: kernel bit-equal to "
                                         f"plain on 4096 entries")
            if cr == 0:
                check(abs(float(got[0, 3]) - 1.0) <= MATCH_TOL and got[0, 0] == 0.0
                      and abs(float(got[1, 100]) - 1.0) <= MATCH_TOL,
                      f"W={lp.shape[2]}: self-matches 1.0, empty entry 0.0")
    # The coarse pass's shape, which most of a search's launches have: two
    # queries x 4 phases = 8 rows of Sc = 20 against the strided library
    # (the planes search uses), ragged counts, 64 booleans compared.
    lp_c, ln_c, cnt_c, _ = lib._coarse_planes(4, CHUNK)
    lp, ln, nl = lp_c[:4096], ln_c[:4096], cnt_c[:4096].clone()
    qp, qn, nq = stack_query_planes([queries[0], queries[8]], BIG_S)
    qcp, qcn, nc = phase_strided_query_planes(qp, qn, nq, 4)
    qcpw, qcnw = lib._query_words(qcp.reshape(8, *qcp.shape[2:]),
                                  qcn.reshape(8, *qcn.shape[2:]))
    nc = torch.from_numpy(nc.reshape(8)).to(dev)
    nl[:3] = torch.tensor([0, 2, int(nc[0])])              # empty, shorter, equal
    m = _mask_pairs(100, 64, 200)
    got = match_one_vs_many_fused(qcpw, qcnw, nc, lp, ln, nl, m)
    exp = match_one_vs_many_fused_plain(qcpw, qcnw, nc, lp, ln, nl, m)
    e = float((got - exp).abs().max())
    err = max(err, e)
    check(got.shape == (8, 4096) and torch.equal(got, exp),
          "coarse shape [8, 20, 4] x 4096 strided entries, range 64: kernel bit-equal to plain")
    qp, qn, nq = lib.pos_words[3:4], lib.neg_words[3:4], lib.counts[3:4]
    sub = (lib.pos_words[:65536], lib.neg_words[:65536], lib.counts[:65536])
    ms = cuda_ms(lambda: match_one_vs_many_fused(qp, qn, nq, *sub, 100))
    plain_ms = cuda_ms(lambda: match_one_vs_many_fused_plain(qp, qn, nq, *sub, 100),
                       iters=2, warmup=1)
    big_ms = cuda_ms(lambda: match_one_vs_many_fused(qp, qn, nq, lib.pos_words,
                                                     lib.neg_words, lib.counts, 100))
    coarse_ms = cuda_ms(lambda: match_one_vs_many_fused(qcpw[:4], qcnw[:4], nc[:4], lp_c,
                                                        ln_c, cnt_c, m))
    # The bytes each scan needs (the bound) and its __popc beside it.
    w = lib.pos_words.shape[2]
    work = {"65,536": scan_work(nq, sub[2], w, 100),
            f"{N_BIG:,}": scan_work(nq, lib.counts, w, 100),
            "coarse": scan_work(nc[:4], cnt_c[:N_BIG], w, m)}
    b, b_1m, b_coarse = (bound(n_bytes) for n_bytes, _ in work.values())
    print(f"  match 1 x 65,536 x {BIG_S} rows: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}); 1 x {N_BIG:,}: kernel "
          f"{big_ms:.3f} ms, bound {b_1m['bound_ms']:.4f} ms; coarse pass (4 phases x "
          f"{N_BIG:,} x 20 rows, range 64): kernel {coarse_ms:.3f} ms, bound "
          f"{b_coarse['bound_ms']:.4f} ms ({smi})", flush=True)
    for name, (n_bytes, popc) in work.items():
        print(f"  scan {name}: {n_bytes / 1e9:.4f} GB needed, {popc / 1e9:.4f} G __popc "
              f"({popc_ms(popc, sm_mhz):.4f} ms at 16 a clock an SM, {sm_mhz:g} MHz)", flush=True)
    return {"name": "match_one_vs_many_fused", "route": "cuda",
            "source": "lbaudiodetective_torch/csrc/match_packed.cu",
            "replaces": "lbaudiodetective_tpu/ops/pallas/match_fused.py:138",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None,
            "ms_1m": big_ms, "bound_ms_1m": b_1m["bound_ms"], "coarse_ms_1m": coarse_ms,
            "coarse_bound_ms_1m": b_coarse["bound_ms"]}


FOLD_SLOTS = (1, 8, 64)           # posting slots of a timed pooled flush
FOLD_ROWS = 8                     # rows each posts (the live cell's post)


def parent_fold(m, qp, qn, k_valid, base) -> None:
    """The pooled fold before ``csrc/slot_fold.cu`` (the yardstick it
    replaced): query planes of every slot to the card, one GEMM of their
    hits against the unpacked bf16 planes, then one in-place update of each
    arrival index and age, its slots' index copied to the card."""
    import numpy as np
    import torch

    from lbaudiodetective_torch.ops.kernels.slot_fold import fold_arrival, inv_possible

    sh, (d_a, d_b) = m._shards[0], m._state[0][0]
    g, k, pairs = qp.shape
    qp_d = torch.as_tensor(qp, device=sh.device)
    qn_d = torch.as_tensor(qn, device=sh.device)
    planes = sh.planes(m._dtype)
    q = torch.cat([qp_d, qn_d], dim=-1).reshape(g * k, 2 * pairs).to(planes.dtype)
    hits = torch.matmul(q, planes.T).reshape(g, k, sh.l, -1)
    inv_q = inv_possible(((qp_d + qn_d) * sh.mask).sum(-1, dtype=torch.int32).to(torch.float32))
    for t in range(k):
        live = np.flatnonzero(k_valid > t)
        for i in np.unique(base[live] + t):
            sel = live[base[live] + t == i]
            slots = slice(None) if sel.size == g else torch.from_numpy(sel).to(sh.device)
            fold_arrival(d_a, d_b, hits[slots, t], sh.inv_lib, sh.row_valid, inv_q[slots, t],
                         slots, int(i))


def fold_work(counts, base, k_valid, w: int) -> tuple[int, int]:
    """What a pooled fold needs: the bytes (each entry's valid rows of both
    planes and its inv_lib read once, and each posting slot's touched state
    read and written once: d_a's diagonals below n - b, d_b's from
    max(0, b - n + 1) to b + k - 1) and the __popc (one a word of each
    valid row for each new row)."""
    import numpy as np

    n = counts.to("cpu").numpy().astype(np.int64)
    n_bytes = int(n.sum()) * (w * 8 + 4) + n.size * 4
    for b, k in zip(base, k_valid):
        touched = np.maximum(n - b, 0) + np.where(n > 0, b + k - np.maximum(b - n + 1, 0), 0)
        n_bytes += int(touched.sum()) * 8
    return n_bytes, int(n.sum()) * w * int(np.sum(k_valid))


def phase_slot_fold(dev, smi: str, sm_mhz: float, n_entries: int = 65536) -> dict:
    """The pooled fold kernel against its plain version (bit-equal, the
    whole state) at 1, 8 and 64 posting slots of ``FOLD_ROWS`` rows at the
    live cell's geometry (``n_entries`` tracks of 31-80 rows, 64 slots at
    ages 0-48), and its time beside its bound, the plain version's and the
    parent's all-slot GEMM and per-arrival fold at the same flush."""
    import numpy as np
    import torch

    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch.models.library import FingerprintLibrary
    from lbaudiodetective_torch.ops.kernels.slot_fold import slot_fold, slot_fold_plain
    from lbaudiodetective_torch.streaming.incremental import IncrementalLibraryMatcher
    from lbaudiodetective_torch.utils.packing import pack_bits

    print("[10b] pooled fold kernel vs plain and the all-slot fold", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    lp, ln, counts = random_words(gen, dev, n_entries, BIG_S, 100)
    lib = FingerprintLibrary(lp, ln, counts, 100, FingerprintConfig())
    m = IncrementalLibraryMatcher(lib, batch=64, n_cap=256, device=dev)
    sh, (d_a, d_b) = m._shards[0], m._state[0][0]
    rng = np.random.default_rng(18)
    out = {}
    for n_post in FOLD_SLOTS:
        slots = np.sort(rng.choice(64, n_post, replace=False))
        base = rng.integers(0, 49, n_post)
        k = np.full(n_post, FOLD_ROWS)
        cls = rng.choice(3, size=(n_post, FOLD_ROWS, 100))
        qp, qn = (cls == 1).astype(np.uint8), (cls == 2).astype(np.uint8)
        words = [torch.from_numpy(pack_bits(x).view(np.int32)).to(dev) for x in (qp, qn)]
        table = [torch.from_numpy(x.astype(np.int32)).to(dev) for x in (slots, base, k)]
        args = (sh.pos_words, sh.neg_words, sh.n_lib, sh.inv_lib, sh.mask_pairs, *words,
                *table)
        ref_a, ref_b = d_a.clone(), d_b.clone()
        slot_fold(d_a, d_b, *args)
        slot_fold_plain(ref_a, ref_b, *args)
        check(torch.equal(d_a, ref_a) and torch.equal(d_b, ref_b),
              f"{n_post} posting slot(s) x {FOLD_ROWS} rows: kernel state bit-equal to plain")
        del ref_a, ref_b
        ms = cuda_ms(lambda: slot_fold(d_a, d_b, *args), iters=20)
        plain_ms = cuda_ms(lambda: slot_fold_plain(d_a, d_b, *args), iters=2, warmup=1)
        all_p, all_n = (np.zeros((64, FOLD_ROWS, 100), np.uint8) for _ in range(2))
        all_p[slots], all_n[slots] = qp, qn
        all_k, all_b = np.zeros(64, np.int64), np.zeros(64, np.int64)
        all_k[slots], all_b[slots] = k, base
        parent_ms = cuda_ms(lambda: parent_fold(m, all_p, all_n, all_k, all_b), iters=5)
        n_bytes, popc = fold_work(counts, base, k, lp.shape[2])
        b = bound(n_bytes)
        out[n_post] = {"ms": ms, "plain_ms": plain_ms, "parent_ms": parent_ms,
                       "bound_ms": b["bound_ms"], "gb": n_bytes / 1e9,
                       "popc_ms": popc_ms(popc, sm_mhz)}
        print(f"  {n_post} slot(s) x {FOLD_ROWS} rows vs {n_entries:,} x {BIG_S}: kernel "
              f"{ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({n_bytes / 1e9:.4f} GB; "
              f"{popc / 1e9:.4f} G __popc, {out[n_post]['popc_ms']:.4f} ms), plain "
              f"{plain_ms:.3f} ms, all-slot GEMM + per-arrival fold {parent_ms:.3f} ms ({smi})",
              flush=True)
    check(out[64]["ms"] <= out[64]["parent_ms"],
          "64 posting slots: the kernel no slower than the all-slot fold")
    del m, lib
    torch.cuda.empty_cache()
    return {"name": "slot_fold", "route": "cuda",
            "source": "lbaudiodetective_torch/csrc/slot_fold.cu", "replaces": None,
            "ms": out[1]["ms"], "plain_ms": out[1]["plain_ms"], "bound_ms": out[1]["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "by_slots": out}


def phase_library(dev, lib, queries, originals, clip_of, smi: str) -> dict:
    """The library path through FingerprintLibrary and the CLI."""
    import contextlib
    import io

    import numpy as np
    import torch

    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch.io.wav import write_wav
    from lbaudiodetective_torch.models.fingerprint import Fingerprint
    from lbaudiodetective_torch.__main__ import main as cli
    from lbaudiodetective_torch.models.library import FingerprintLibrary

    print(f"[6b] library path: {len(lib):,} entries", flush=True)
    out = {}
    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        scores = lib.match(queries[8])
        walls.append(time.perf_counter() - t0)
    out["match_1m_wall_ms"] = float(np.median(walls)) * 1e3
    check(scores.shape == (N_BIG,) and np.isfinite(scores).all()
          and int(np.argmax(scores)) == originals[8] and scores[originals[8]] == 1.0,
          f"match over {N_BIG:,}: the planted crop's original is the argmax (1.0)")

    brute = [lib.match(q) for q in queries]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    walls, device_ms, results = [], [], []
    for q in queries:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        results.append(lib.search(q))
        end.record()
        walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        device_ms.append(start.elapsed_time(end))
    out["search_wall_ms"] = float(np.median(walls)) * 1e3
    out["search_device_ms"] = float(np.median(device_ms))
    hits = sum(clip_of.get(int(idx[0])) == i for i, (idx, _) in enumerate(results))
    for i, ((idx, sc), b) in enumerate(zip(results, brute)):
        check(int(idx[0]) == int(np.argmax(b)) and sc[0] == b[idx[0]]
              and np.array_equal(sc, b[idx]),
              f"search query {i}: top-1 {int(idx[0])} = full-scan argmax, score "
              f"{sc[0]:.6f} equal to the bit")
    out["planted_found"] = hits
    check(hits == 16, f"{hits}/16 planted queries name an entry planted from their clip")
    many_idx, many_sc = lib.search_many(queries[:8])
    check(all(np.array_equal(many_idx[i], results[i][0])
              and np.array_equal(many_sc[i], results[i][1]) for i in range(8)),
          "search_many at B=8 equals per-query search")
    check(np.array_equal(lib.match_many(queries[:8]), np.stack(brute[:8])),
          "match_many at B=8 equals the stacked match")
    print(f"  match 1 x {N_BIG:,}: {out['match_1m_wall_ms']:.3f} ms wall; search (shortlist "
          f"1024, stride 4, range 64, all phases): {out['search_wall_ms']:.3f} ms wall, "
          f"{out['search_device_ms']:.3f} ms device span, median of 16 ({smi})", flush=True)

    n_sub = 16384
    pw = lib.pos_words[:n_sub].cpu().numpy().view(np.uint32)
    nw = lib.neg_words[:n_sub].cpu().numpy().view(np.uint32)
    counts = lib.counts[:n_sub].cpu().numpy()
    sub_fps = [Fingerprint.from_packed(pw[i, :n], nw[i, :n], 100)
               for i, n in enumerate(counts)]
    cfg = lib.config
    fresh = FingerprintLibrary.from_fingerprints(sub_fps, cfg, dev)
    grown = FingerprintLibrary.from_fingerprints(sub_fps[:8192], cfg, dev).extend(
        sub_fps[8192:])
    check(all(torch.equal(a, b) for a, b in (
        (fresh.pos_words, lib.pos_words[:n_sub]), (fresh.neg_words, lib.neg_words[:n_sub]),
        (grown.pos_words, fresh.pos_words), (grown.neg_words, fresh.neg_words),
        (grown.counts, fresh.counts))), "extend equals from_fingerprints on 16,384 entries")
    with tempfile.TemporaryDirectory() as tmp:
        fresh.save(f"{tmp}/lib.npz")
        loaded = FingerprintLibrary.load(f"{tmp}/lib.npz", cfg, dev)
        check(torch.equal(loaded.pos_words, fresh.pos_words)
              and np.array_equal(loaded.match(queries[0]), fresh.match(queries[0])),
              "save/load round-trips")
        try:
            FingerprintLibrary.load(f"{tmp}/lib.npz", FingerprintConfig(analysis_stride=32), dev)
            refused = False
        except ValueError:
            refused = True
        check(refused, "a config with another parameter hash is refused")

        sig = brown_noise(np.random.default_rng(9), 8, 5 * 44100)
        sig = 0.5 * sig / np.abs(sig).max(axis=1, keepdims=True)
        pathlib.Path(f"{tmp}/tracks").mkdir()
        for i, x in enumerate(sig):
            write_wav(f"{tmp}/tracks/t{i}.wav", x, 44100)
        # The crop starts one subfingerprint in: 128 rows of 8 samples at
        # 5512 Hz, ~8192.7 samples at 44.1 kHz.
        write_wav(f"{tmp}/crop.wav", sig[3][8193:8193 + 3 * 44100], 44100)
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rcs = (cli(["enroll", f"{tmp}/tracks", "-o", f"{tmp}/cli.npz",
                        "--device", str(dev)]),
                   cli(["identify", f"{tmp}/crop.wav", "--library", f"{tmp}/cli.npz",
                        "--top-k", "3", "--device", str(dev)]))
        check(rcs == (0, 0), "CLI enroll + identify exit 0")
        answer = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(answer["track"] == "t3" and len(answer["top"]) == 3,
              f"CLI identify --top-k 3 names the crop's track: {answer}")
    return out


#: Configs that reach the band-rows kernel (csrc/band_rows.cu) on CUDA.
FRACTIONAL = {"oracle_mode": dict(integer_hop=False),
              "rate_8000": dict(processing_sample_rate=8000.0, integer_hop=False),
              "pitch_16": dict(pitch_step_count=16, integer_hop=False),
              "rows_256": dict(rows_per_frame=256, integer_hop=False)}
GEOMETRIES = {"pitch_16": dict(pitch_step_count=16), "rows_256": dict(rows_per_frame=256),
              "length_300": dict(subfingerprint_length=300)}
BAND_ROWS_N = 56 * 128           # 7168 rows: a 10 s clip at the parity hop
MAIN_SLICE = 16                  # clips a plain-version slice at the main shape
COMPAT_SETTERS = {"default": (), "pitch_16": (("SetNumberOfPitchSteps", 16),),
                  "length_300": (("SetSubfingerprintLength", 300),),
                  "stride_32": (("SetAnalysisStride", 32),)}


def phase_band_rows(dev, rng, smi: str, batch: int = 4) -> dict:
    """The band-rows kernel against its plain version evaluated in float64
    in rows mode (kernel 5; kernel 4 without fuse_haar) and coefficients
    mode (kernel 2 at other geometries; kernel 4 with fuse_haar), and its
    times beside its 3xTF32 bound."""
    import torch

    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch.ops.extract import required_padded_length
    from lbaudiodetective_torch.ops.kernels import band_rows

    print("[7a] band-rows kernel vs plain", flush=True)
    cases = [(f"rows {name}", FingerprintConfig(**kw), False) for name, kw in FRACTIONAL.items()]
    cases += [(f"coefficients {name}", FingerprintConfig(**kw), True)
              for name, kw in GEOMETRIES.items()]
    cases += [(f"hop 8 coeffs={c}", FingerprintConfig(), c) for c in (False, True)]
    err = {}
    for label, cfg, coeffs in cases:
        audio = torch.from_numpy(brown_noise(
            rng, batch, required_padded_length(cfg, BAND_ROWS_N))).to(dev)
        got = band_rows.band_rows(audio, cfg, BAND_ROWS_N, coeffs)
        # Held to the plain version in float64; the float32 evaluation's own
        # distance from it is printed beside.
        exp = band_rows.band_rows_plain(audio.double(), cfg, BAND_ROWS_N, coeffs)
        exp32 = band_rows.band_rows_plain(audio, cfg, BAND_ROWS_N, coeffs).double()
        ok, e, scale = within_rows_tol(got.double(), exp)
        check(ok, f"{label}: within rtol 5e-4, atol 3e-6*max of the plain version in float64 "
                  f"(max abs err {e:.3e}, max {scale:.3e}, largest error "
                  f"{bar_share(got.double(), exp):.3f} of its bar; the float32 plain version "
                  f"is {bar_share(exp32, exp):.3f} of the bar from float64)")
        check(torch.equal(got, band_rows.band_rows(audio, cfg, BAND_ROWS_N, coeffs)),
              f"{label}: two runs bit-identical")
        err[coeffs] = max(err.get(coeffs, 0.0), e)
        if label != "rows oracle_mode":
            continue
        # NaN at the first sample of clip 0's second sub-tile (the sample the
        # kernel takes the sub-tile's level from) and +inf at clip 1's first
        # sample zero only the windows that hold them.
        bad = audio.clone()
        bad[0, int(cfg.row_starts(BAND_ROWS_N)[128])] = float("nan")
        bad[1, 0] = float("inf")
        got_bad = band_rows.band_rows(bad, cfg, BAND_ROWS_N, coeffs)
        ok, e, _ = within_rows_tol(got_bad.double(), band_rows.band_rows_plain(
            bad.double(), cfg, BAND_ROWS_N, coeffs))
        check(ok and bool(got_bad.isfinite().all()),
              f"{label}, NaN and +inf samples: rows finite and within the bar of the plain "
              f"version in float64 (max abs err {e:.3e})")
    oracle_agreement(dev, rng, FingerprintConfig(integer_hop=False), "integer_hop=False")
    oracle_agreement(dev, rng, FingerprintConfig(pitch_step_count=16), "pitch_step_count=16")

    # One record a TPU kernel that csrc/band_rows.cu replaces, each under the
    # launch count of the one wrapper.
    records = {}
    for label, cfg, coeffs, replaces in (
            ("rows", FingerprintConfig(integer_hop=False), False,
             "lbaudiodetective_tpu/ops/pallas/fused_rows.py:148"),
            ("coefficients hop 8", FingerprintConfig(), True,
             "lbaudiodetective_tpu/ops/pallas/fused_rows_v2.py:196"),
            ("coefficients pitch 16", FingerprintConfig(pitch_step_count=16), True,
             "lbaudiodetective_tpu/ops/pallas/fused_rows_v2.py:678")):
        audio = torch.from_numpy(brown_noise(
            rng, batch, required_padded_length(cfg, BAND_ROWS_N))).to(dev)
        ms = cuda_ms(lambda: band_rows.band_rows(audio, cfg, BAND_ROWS_N, coeffs))
        plain_ms = cuda_ms(lambda: band_rows.band_rows_plain(audio, cfg, BAND_ROWS_N, coeffs),
                           iters=5)
        name = f"band_rows ({label})"
        b, serial_ms = band_rows_bound(cfg, audio, BAND_ROWS_N, coeffs)
        print(f"  {name} [{batch}, {BAND_ROWS_N} rows] ({'coefficients' if coeffs else 'rows'}, "
              f"hop {cfg.hop_in_processing_samples:.4f}, {cfg.pitch_step_count} bands): kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms "
              f"({b['bound_by']}; {serial_ms:.3f} ms if the pipes do not overlap)", flush=True)
        records[name] = {"name": "band_rows", "mode": label, "route": "cuda",
                         "source": "lbaudiodetective_torch/csrc/band_rows.cu",
                         "replaces": replaces, "max_abs_err": err[coeffs],
                         "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None}
    cfg = FingerprintConfig(integer_hop=False)
    main_audio = torch.from_numpy(brown_noise(
        rng, N_CLIPS, required_padded_length(cfg, BAND_ROWS_N))).to(dev)
    main_ms = cuda_ms(lambda: band_rows.band_rows(main_audio, cfg, BAND_ROWS_N), iters=5)
    main_bound, main_serial_ms = band_rows_bound(cfg, main_audio, BAND_ROWS_N, False)
    records["band_rows (rows)"].update(
        main_shape_ms=main_ms, main_shape_bound_ms=main_bound["bound_ms"],
        main_shape_bound_serial_ms=main_serial_ms)
    print(f"  band_rows [{N_CLIPS}, {BAND_ROWS_N} rows] (fractional hop): "
          f"kernel {main_ms:.3f} ms, bound {main_bound['bound_ms']:.3f} ms "
          f"({main_bound['bound_by']}; {main_serial_ms:.3f} ms if the pipes do not overlap) "
          f"({smi})", flush=True)
    # The main path's launch shape, every clip against the plain version in
    # float64 (in slices: the plain gather holds ~120 MB of windows a clip).
    got = band_rows.band_rows(main_audio, cfg, BAND_ROWS_N)
    worst, share, failed = 0.0, 0.0, []
    for i in range(0, N_CLIPS, MAIN_SLICE):
        exp = band_rows.band_rows_plain(main_audio[i:i + MAIN_SLICE].double(), cfg, BAND_ROWS_N)
        ok, e, _ = within_rows_tol(got[i:i + MAIN_SLICE].double(), exp)
        worst = max(worst, e)
        share = max(share, bar_share(got[i:i + MAIN_SLICE].double(), exp))
        if not ok:
            failed.append(i)
    check(not failed, f"rows at [{N_CLIPS}, {BAND_ROWS_N} rows]: every clip within rtol 5e-4, "
                      f"atol 3e-6*max of its slice of the plain version in float64 (max abs "
                      f"err {worst:.3e}, largest error {share:.3f} of its bar; slices failing "
                      f"at clips {failed})")
    rec = records["band_rows (rows)"]
    rec["max_abs_err"] = max(rec["max_abs_err"], worst)
    return records


def phase_every_config(dev, rng) -> dict:
    """The paths that run the band-rows kernel: the fractional-hop batch
    through AudioDetective and the C-API layer with the setters that change
    the frame geometry."""
    import numpy as np
    import torch

    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch.io.decode import decode_audio_file
    from lbaudiodetective_torch.io.wav import write_wav
    from lbaudiodetective_torch import compat
    from lbaudiodetective_torch.models.detective import AudioDetective
    from lbaudiodetective_torch.oracle.pipeline import oracle_fingerprint

    print("[7b] every config: fractional-hop batch, compat", flush=True)
    out = {}
    cfg = FingerprintConfig(integer_hop=False)
    det = AudioDetective(cfg, device=dev)
    clips = synth_clips(rng, cfg, N_CLIPS, CLIP_SECONDS)
    t0 = time.perf_counter()
    fps = det.process_decoded_batch(clips)
    torch.cuda.synchronize()
    out["fractional_first_batch_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fps2 = det.process_decoded_batch(clips)
    out["fractional_batch_s"] = time.perf_counter() - t0
    out["fractional_clips_per_s"] = N_CLIPS / out["fractional_batch_s"]
    n_exp = cfg.num_subfingerprints(clips[0].file_frames, clips[0].proc_frames)
    check(all(f.num_subfingerprints == n_exp for f in fps),
          f"{N_CLIPS} fractional-hop fingerprints of {n_exp} subfingerprints")
    check(all(a == b for a, b in zip(fps, fps2)), "repeated batch bit-identical")
    for i in range(2):
        opos, oneg = oracle_fingerprint(clips[i], cfg)
        agree = ((opos == fps[i].pos).mean() + (oneg == fps[i].neg).mean()) / 2
        check(agree >= 0.999, f"fractional clip {i}: {agree:.5f} of bits equal to the NumPy "
                              "oracle")
    print(f"  AudioDetective(integer_hop=False).process_decoded_batch({N_CLIPS} x "
          f"{CLIP_SECONDS:g} s): {out['fractional_batch_s'] * 1e3:.1f} ms warm "
          f"({out['fractional_clips_per_s']:.1f} clips/s), first call "
          f"{out['fractional_first_batch_s'] * 1e3:.1f} ms", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        a, b = f"{tmp}/a.wav", f"{tmp}/b.wav"
        sig = brown_noise(rng, 1, int(5 * 44100))[0]
        sig = 0.5 * sig / np.abs(sig).max()
        write_wav(a, sig, 44100)
        write_wav(b, sig + 0.01 * rng.standard_normal(sig.shape[0]).astype(np.float32), 44100)
        for case, setters in COMPAT_SETTERS.items():
            gpu, cpu = compat.LBAudioDetectiveNew(device=dev), compat.LBAudioDetectiveNew(
                device="cpu")
            for name, value in setters:
                getattr(compat, "LBAudioDetective" + name)(gpu, value)
                getattr(compat, "LBAudioDetective" + name)(cpu, value)
            fp = compat.LBAudioDetectiveProcessAudioURL(gpu, a)
            cfp = compat.LBAudioDetectiveProcessAudioURL(cpu, a)
            opos, oneg = oracle_fingerprint(
                decode_audio_file(a, gpu.config.processing_sample_rate), gpu.config)
            agree = ((fp.pos == opos).mean() + (fp.neg == oneg).mean()) / 2
            check(fp.num_subfingerprints == cfp.num_subfingerprints > 0 and agree >= 0.999,
                  f"compat {case}: ProcessAudioURL on the card, {fp.num_subfingerprints} "
                  f"subfingerprints as on the CPU port, {agree:.5f} of bits equal to the NumPy "
                  "oracle")
            score = compat.LBAudioDetectiveCompareAudioURLs(gpu, a, b)
            fb = compat.LBAudioDetectiveGetFingerprint(gpu)
            same = cpu.compare_fingerprints(fp, fb)
            raw = compat.LBAudioDetectiveFingerprintCompareToFingerprint(fp, fb, 37, device=dev)
            raw_cpu = compat.LBAudioDetectiveFingerprintCompareToFingerprint(fp, fb, 37,
                                                                             device="cpu")
            check(0.0 < score <= 1.0 and abs(score - same) <= MATCH_TOL
                  and abs(raw - raw_cpu) <= MATCH_TOL,
                  f"compat {case}: CompareAudioURLs {score:.6f} (CPU port on the same "
                  f"fingerprints {same:.6f}), range-37 compare {raw:.6f}")
    return out


def stream_offline(dev, cfg, audio, rows_done: int):
    """Offline extraction on the card of the samples the streams received,
    cut to the rows they have (file_frames chosen so the offline row count
    equals the stream's)."""
    from lbaudiodetective_torch.io.decode import DecodedAudio
    from lbaudiodetective_torch.ops.extract import extract_fingerprint_batch

    file_frames = rows_done * cfg.analysis_stride + cfg.window_size
    clips = [DecodedAudio(x, cfg.processing_sample_rate, file_frames, cfg.file_sample_rate)
             for x in audio]
    return extract_fingerprint_batch(clips, cfg, device=dev)


def phase_streaming(dev, rng, smi: str) -> tuple[dict, collections.Counter]:
    """BASELINE config 4: 256 concurrent streams fed 10 s each through the
    three step paths, against offline extraction on the card; the host is
    never made to wait for the device while the streams are fed.  Returns
    the measurements and the kernels' launch counts summed over the timed
    feeds and the streaming names: the offline references are not counted."""
    import numpy as np
    import torch

    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch import compat
    from lbaudiodetective_torch.ops import kernels
    from lbaudiodetective_torch.streaming import StreamingDetective, StreamingExtractor

    print(f"[8] streaming: {N_CLIPS} streams x {CLIP_SECONDS:g} s", flush=True)
    out, counts = {}, collections.Counter()
    aligned_audio = None
    for name, cfg, chunk in (("aligned", FingerprintConfig(), 1024),
                             ("conv", FingerprintConfig(), 512),
                             ("gather", FingerprintConfig(integer_hop=False), 1024)):
        steps = int(CLIP_SECONDS * cfg.processing_sample_rate) // chunk
        audio = brown_noise(rng, N_CLIPS, steps * chunk)
        chunks = [np.ascontiguousarray(audio[:, s * chunk:(s + 1) * chunk]) for s in range(steps)]
        ext = StreamingExtractor(batch=N_CLIPS, chunk_size=chunk, config=cfg, device=dev,
                                 collect_host=False)
        check((ext.aligned, ext.use_conv) == (name == "aligned", name == "conv"),
              f"{name}: chunk {chunk} takes the {name} step")
        for c in chunks[:8]:                 # warm-up: constants, cuDNN, allocator
            ext.feed(c)
        ext.reset()
        torch.cuda.synchronize()
        prev = torch.cuda.get_sync_debug_mode()
        kernels.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")    # any host wait raises
        try:
            t0 = time.perf_counter()
            for c in chunks:
                ext.feed(c)
            enqueued = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        counts.update(kernels.launch_counts())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stream_s = steps * chunk / cfg.processing_sample_rate
        rtf = N_CLIPS * stream_s / wall
        out[f"{name}_rtf"] = rtf
        out[f"{name}_wall_s"] = wall
        fps = ext.fingerprints()
        pos, neg, n_subs = stream_offline(dev, cfg, audio, ext.rows_done)
        n = ext.rows_done // cfg.rows_per_frame
        check(n > 0 and all(f.num_subfingerprints == n for f in fps)
              and all(int(k) >= n for k in n_subs),
              f"{name}: {n} subfingerprints a stream, as offline")
        spos = np.stack([f.pos for f in fps])
        sneg = np.stack([f.neg for f in fps])
        if name == "aligned":
            check(np.array_equal(spos, pos[:, :n]) and np.array_equal(sneg, neg[:, :n]),
                  f"{name}: bit-equal to offline extraction on the card")
            aligned_audio, aligned_fp = audio[0], fps[0]
        else:
            agree = ((spos == pos[:, :n]).mean() + (sneg == neg[:, :n]).mean()) / 2
            check(agree >= 0.999, f"{name}: {agree:.5f} of bits equal to offline extraction")
        print(f"  {name} (chunk {chunk}, hop {cfg.hop_in_processing_samples:.4f}): "
              f"{wall * 1e3:.1f} ms for {steps} steps ({enqueued * 1e3:.1f} ms to enqueue), "
              f"real-time factor {rtf:.1f} ({smi})", flush=True)

    det = StreamingDetective(FingerprintConfig(), chunk_size=1024, device=dev)
    done = []
    kernels.reset_launch_counts()
    compat.LBAudioDetectiveProcess(det, 2, done.append)
    det.process_samples(aligned_audio[:2048])          # no frame yet
    compat.LBAudioDetectivePauseProcessing(det)
    det.process_samples(np.zeros(4096, np.float32))    # ignored while paused
    compat.LBAudioDetectiveResumeProcessing(det)
    det.process_samples(aligned_audio[2048:8192])
    counts.update(kernels.launch_counts())
    check(len(done) == 1 and done[0].num_subfingerprints == 2
          and np.array_equal(done[0].pos, aligned_fp.pos[:2])
          and np.array_equal(done[0].neg, aligned_fp.neg[:2]),
          "compat streaming names on the card: 2 subfingerprints, equal to stream 0's")
    return out, counts


SESSION_POST = 8                 # subfingerprints a live-session post
N_WAV = 8                        # planted 10 s WAV clips posted to /identify
# Library indices of the planted fingerprints, spread over the whole
# 16,384 entries so that every chunk and query group of a match launch
# holds winners: clip i of phase 5 (phase 10's stream i, the sessions'
# fingerprint i; phase 5's library holds clip 0 itself at 0, every other
# entry a noisy copy) and WAV clip j (phase 9's request j; j = 2 lies in
# the every-score slice).
CLIP_AT = [64 * i for i in range(N_CLIPS)]
WAV_AT = [301 + 1500 * j for j in range(N_WAV)]
N_SESSIONS, N_POOLED = 16, 64    # per-session and pooled live sessions
N_SCORES = 4096                  # tracks of the slice served with every score
STREAM_GROUP = 32                # streams a group of the incremental identifier
LONG_SUBS = 19398                # one hour at 5.39 subfingerprints a second
LONG_CHUNK = 512
LONG_AT = 12345                  # where the long matchers' query is planted


def service_library(dev, rng, fps, entries):
    """Phase 5's 16,384 entries with the 256 clips' fingerprints planted at
    CLIP_AT (phase 10's streams) and 8 written 10 s WAV clips' at WAV_AT
    (phase 9's requests), on the card.  Returns the library,
    its names, the WAVs' bytes (the 8, then a 1.5 s clip) and their
    fingerprints through ``AudioDetective.process_decoded``."""
    import numpy as np

    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch.io.decode import decode_audio_file
    from lbaudiodetective_torch.io.wav import write_wav
    from lbaudiodetective_torch.models.detective import AudioDetective
    from lbaudiodetective_torch.models.library import FingerprintLibrary

    cfg = FingerprintConfig()
    det = AudioDetective(cfg, device=dev)
    sig = brown_noise(rng, N_WAV + 1, int(CLIP_SECONDS * 44100))
    sig = 0.5 * sig / np.abs(sig).max(axis=1, keepdims=True)
    payloads, wav_fps = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for i, x in enumerate(sig):
            path = f"{tmp}/clip{i}.wav"
            write_wav(path, x if i < N_WAV else x[:66150], 44100)
            payloads.append(pathlib.Path(path).read_bytes())
            wav_fps.append(det.process_decoded(decode_audio_file(path)))
    entries = list(entries)
    for at, f in (*zip(CLIP_AT, fps), *zip(WAV_AT, wav_fps)):
        entries[at] = f
    lib = FingerprintLibrary.from_fingerprints(entries, cfg, device=dev)
    return lib, [f"track_{i}" for i in range(len(entries))], payloads, wav_fps


def http_call(addr, method: str, path: str, body: bytes | None = None):
    """(status, JSON body, seconds) of one request to the server at ``addr``."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection(*addr, timeout=300)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        status, out = resp.status, json.loads(resp.read())
    finally:
        conn.close()
    return status, out, time.perf_counter() - t0


@contextlib.contextmanager
def serving(service):
    """``make_server(service)`` on 127.0.0.1 at an ephemeral port, served
    from a thread; yields the address, then stops and joins the thread."""
    from lbaudiodetective_torch.serving import make_server

    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv.server_address
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
        if thread.is_alive():
            raise CheckFailed("the server thread did not stop")


def concurrently(fn, args_list: list) -> list:
    """``fn(*args)`` for every ``args``, each in its own thread; the results
    in order.  Raises the first error a thread met."""
    results, failures = [None] * len(args_list), []

    def run(i, args):
        try:
            results[i] = fn(*args)
        except Exception as e:  # noqa: BLE001 - re-raised below
            failures.append(e)

    threads = [threading.Thread(target=run, args=(i, a)) for i, a in enumerate(args_list)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise CheckFailed("a request thread did not finish within 600 s")
    if failures:
        raise failures[0]
    return results


def post_sessions(addr, sids, fps, posts: range) -> tuple[list, list]:
    """Each session posts the increments ``posts`` (indices of
    SESSION_POST-subfingerprint slices) of its fingerprint in order, all
    sessions at once.  Returns each session's (status, response) list and
    every post's latency."""
    def one(sid, fp):
        subs = fp.to_string().split("+")
        out = []
        for k in posts:
            body = "+".join(subs[k * SESSION_POST:(k + 1) * SESSION_POST]).encode("ascii")
            out.append(http_call(addr, "POST", f"/stream/{sid}", body))
        return out

    runs = concurrently(one, list(zip(sids, fps)))
    return [[(st, r) for st, r, _ in run] for run in runs], [dt for run in runs
                                                             for *_, dt in run]


def top_list(names, idx, scores) -> list:
    return [{"track": names[int(i)], "score": float(s)} for i, s in zip(idx, scores)]


def plain_plane(lib, queries):
    """``[B, L]`` scores of ``queries`` against the whole of ``lib`` by the
    match kernel's plain version, on the words ``lib.match_many`` stacks
    (no launch counted).  One query at a time holds a ``[L, S, S]`` hit
    plane of 0.27 GB at 16,384 entries of 64 rows."""
    import torch

    from lbaudiodetective_torch.models.library import stack_query_planes
    from lbaudiodetective_torch.ops.kernels.match_packed import match_one_vs_many_fused_plain
    from lbaudiodetective_torch.ops.match_packed import _mask_pairs

    qp, qn, nq = stack_query_planes(queries, int(lib.pos_words.shape[1]))
    qpw, qnw = lib._query_words(qp, qn)
    m = _mask_pairs(lib.pairs, 0, lib.config.subfingerprint_length)
    return match_one_vs_many_fused_plain(qpw, qnw, torch.from_numpy(nq).to(lib.device),
                                         lib.pos_words, lib.neg_words, lib.counts,
                                         m).cpu().numpy()


def run_sessions(dev, cfg, lib, names, svc, streams, pool: bool):
    """Open a session a fingerprint on ``svc``, post the first four
    increments over HTTP, ``save_sessions`` into a fresh service,
    ``load_sessions`` there and post the rest, then peek and close.
    Returns (responses a session, latencies, posting wall, saved, loaded,
    peeks, closes)."""
    from lbaudiodetective_torch.serving import IdentificationService

    n_posts = -(-max(f.num_subfingerprints for f in streams) // SESSION_POST)
    with serving(svc) as addr:
        sids = [http_call(addr, "POST", "/stream/open")[1]["session"] for _ in streams]
        t0 = time.perf_counter()
        first, lat1 = post_sessions(addr, sids, streams, range(4))
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        saved = svc.save_sessions(tmp)
        fresh = IdentificationService(lib, names, cfg, stream_pool=pool, device=dev)
        loaded = fresh.load_sessions(tmp)
    with serving(fresh) as addr:
        t0 = time.perf_counter()
        second, lat2 = post_sessions(addr, sids, streams, range(4, n_posts))
        wall += time.perf_counter() - t0
        peeks = [http_call(addr, "GET", f"/stream/{sid}")[:2] for sid in sids]
        closes = [http_call(addr, "POST", f"/stream/{sid}/close")[:2] for sid in sids]
    return ([a + b for a, b in zip(first, second)], lat1 + lat2, wall, saved, loaded,
            peeks, closes)


def phase_service(dev, lib, names, payloads, wav_fps, fps, smi: str
                  ) -> tuple[dict, collections.Counter]:
    """The HTTP identification service on the card (``serving.py``).  Returns
    the measurements and the kernels' launch counts over the requests; the
    offline references the answers are held to run after them."""
    import numpy as np

    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch.models.library import FingerprintLibrary
    from lbaudiodetective_torch.ops import kernels
    from lbaudiodetective_torch.serving import IdentificationService

    print(f"[9] HTTP service on {dev}: {len(lib):,} tracks (two-stage search), "
          f"a {N_SCORES:,}-track slice (every score), live sessions", flush=True)
    cfg = FingerprintConfig()
    out = {}
    batching = dict(batch_window_s=0.02, max_batch=8, device=dev)
    svc = IdentificationService(lib, names, cfg, **batching)
    small = FingerprintLibrary(lib.pos_words[:N_SCORES], lib.neg_words[:N_SCORES],
                               lib.counts[:N_SCORES], lib.pairs, cfg)
    small_svc = IdentificationService(small, names[:N_SCORES], cfg, **batching)
    wav = payloads[:N_WAV]
    kernels.reset_launch_counts()
    with serving(svc) as addr:
        concurrently(lambda p: http_call(addr, "POST", "/identify", p),
                     [(p,) for p in wav])              # warm-up: threads, allocator
        before = svc.extract_dispatches
        t0 = time.perf_counter()
        identified = concurrently(lambda p: http_call(addr, "POST", "/identify", p),
                                  [(p,) for p in wav])
        out["identify_wall_s"] = time.perf_counter() - t0
        dispatches = svc.extract_dispatches - before
        by_text = http_call(addr, "POST", "/identify-fingerprint",
                            wav_fps[1].to_string().encode("ascii"))
        printed = [http_call(addr, "POST", "/fingerprint", payloads[i]) for i in (0, N_WAV)]
        health = http_call(addr, "GET", "/healthz")
        malformed = http_call(addr, "POST", "/identify", b"RIFF\x00\x00 not audio")
        unknown = http_call(addr, "GET", "/stream/no-such-session")
    every_score = small_svc.identify(wav[2])
    per_session = run_sessions(dev, cfg, lib, names, svc, fps[:N_SESSIONS], pool=False)
    pooled = run_sessions(dev, cfg, lib, names,
                          IdentificationService(lib, names, cfg, stream_pool=True, device=dev),
                          fps[N_SESSIONS:N_SESSIONS + N_POOLED], pool=True)
    counts = collections.Counter(kernels.launch_counts())

    # -- the answers against the library's offline calls --------------------
    many_idx, many_sc = lib.search_many(wav_fps[:N_WAV], top_k=5)
    for j, (status, body, _) in enumerate(identified):
        idx, sc = lib.search(wav_fps[j], top_k=5)
        check_quiet(status == 200 and body["track"] == names[WAV_AT[j]]
                    and body["top"] == top_list(names, idx, sc)
                    == top_list(names, many_idx[j], many_sc[j]),
                    f"/identify {j}: {status} {body}")
    check(True, f"{N_WAV} concurrent /identify: each names its planted track (entries "
                f"{WAV_AT[0]}-{WAV_AT[-1]}), 'top' equal to library.search and to a row of "
                f"one search_many batch bit for bit")
    plain = plain_plane(lib, wav_fps[:N_WAV])
    check(np.array_equal(many_sc, np.take_along_axis(plain, many_idx, 1))
          and np.array_equal(many_idx[:, 0], plain.argmax(1))
          and many_idx[:, 0].tolist() == WAV_AT,
          f"search_many x {N_WAV}: exact scores equal the plain matcher's at every returned "
          f"index, winners its argmax over all {len(lib):,} entries")
    check(dispatches < N_WAV, f"{N_WAV} requests took {dispatches} extraction dispatches")
    idx, sc = lib.search(wav_fps[1], top_k=5)
    check(by_text[0] == 200 and by_text[1]["top"] == top_list(names, idx, sc),
          "/identify-fingerprint equals library.search")
    want = small.match(wav_fps[2])
    check(every_score["track"] == names[WAV_AT[2]]
          and list(every_score["scores"].values()) == [float(s) for s in want]
          and list(every_score["scores"]) == names[:N_SCORES],
          f"{N_SCORES:,}-track service: every score equal to library.match")
    check(all(st == 200 and body["fingerprint"] == wav_fps[i].to_string()
              for (st, body, _), i in zip(printed, (0, N_WAV))),
          f"/fingerprint of a 10 s and a 1.5 s clip equal to process_decoded "
          f"({printed[0][1]['n']} and {printed[1][1]['n']} subfingerprints)")
    check(health[:2] == (200, {"ok": True, "tracks": len(lib)}), "/healthz")
    check(malformed[0] == 400 and unknown[0] == 400,
          f"malformed body and unknown session: {malformed[0]}, {unknown[0]}")

    for mode, streams, run in (("per-session", fps[:N_SESSIONS], per_session),
                               ("pooled", fps[N_SESSIONS:N_SESSIONS + N_POOLED], pooled)):
        answers, lat, wall, saved, loaded, peeks, closes = run
        check(saved == loaded == len(streams),
              f"{mode}: {saved} sessions saved, {loaded} loaded into a fresh service")
        last = len(answers[0]) - 1
        for k in range(len(answers[0])):
            n = min((k + 1) * SESSION_POST, streams[0].num_subfingerprints)
            prefixes = [type(f)(f.pos[:n], f.neg[:n]) for f in streams]
            want = lib.match_many(prefixes)
            if k in (1, last):
                check(np.array_equal(want, plain_plane(lib, prefixes)),
                      f"{mode}: match_many [{len(streams)}, {len(lib):,}] plane after post "
                      f"{k} ({n} subfingerprints) equal to the plain matcher's")
            for s, (st, body) in enumerate(a[k] for a in answers):
                best = int(np.argmax(want[s]))
                check_quiet(st == 200 and body["n"] == n and body["track"] == names[best]
                            and body["score"] == float(want[s, best]),
                            f"{mode} session {s}, post {k}: {st} {body}")
        check(all(p == (200, answers[s][-1][1]) == c for s, (p, c)
                  in enumerate(zip(peeks, closes))),
              f"{mode}: peek and close equal the last post's answer")
        first = N_SESSIONS if mode == "pooled" else 0
        check([a[-1][1]["track"] for a in answers]
              == [names[at] for at in CLIP_AT[first:first + len(streams)]],
              f"{mode}: {len(streams)} sessions x {len(answers[0])} posts of {SESSION_POST}: "
              f"top-1 = argmax of library.match_many after every post, scores bit-equal; "
              f"each names its own entry at the end")
        post_ms = np.array(lat) * 1e3
        key = mode.replace("-", "_")
        out.update({f"{key}_post_p50_ms": float(np.percentile(post_ms, 50)),
                    f"{key}_post_p95_ms": float(np.percentile(post_ms, 95)),
                    f"{key}_posts_per_s": len(lat) / wall, f"{key}_posts": len(lat)})
        print(f"  {mode} posts over HTTP: p50 {out[f'{key}_post_p50_ms']:.1f} ms, p95 "
              f"{out[f'{key}_post_p95_ms']:.1f} ms, {out[f'{key}_posts_per_s']:.1f} posts/s "
              f"({smi})", flush=True)
    lat_ms = np.array([dt for *_, dt in identified]) * 1e3
    out.update(identify_p50_ms=float(np.percentile(lat_ms, 50)),
               identify_p95_ms=float(np.percentile(lat_ms, 95)),
               identify_dispatches=dispatches)
    print(f"  /identify x {N_WAV} concurrent: p50 {out['identify_p50_ms']:.1f} ms, p95 "
          f"{out['identify_p95_ms']:.1f} ms, {dispatches} dispatches ({smi})", flush=True)
    return out, counts


def phase_stream_identify(dev, lib, clips, smi: str
                          ) -> tuple[dict, collections.Counter, dict]:
    """BASELINE config 4's size: 256 streams x 10 s against the 16,384-entry
    library, chunk 1024, a match every 4 subfingerprints, ``rematch="full"``
    (the match kernel, one launch a tick) and ``"incremental"`` in groups
    of 32.  Both name every planted stream's track, with equal winners and
    bit-equal scores after every chunk, and the match kernel's whole
    ``[256, 16,384]`` score plane at the last tick equals the incremental
    matcher's (plain torch).  Returns the rates, the kernels' launch
    counts over both runs and each mode's winners after every chunk."""
    import numpy as np
    import torch

    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch.ops import kernels
    from lbaudiodetective_torch.streaming import StreamingIdentifier

    print(f"[10] streaming identifier: {N_CLIPS} streams x {CLIP_SECONDS:g} s vs "
          f"{len(lib):,} tracks", flush=True)
    cfg = FingerprintConfig()
    audio = np.stack([c.samples for c in clips])
    steps = audio.shape[1] // 1024
    chunks = [np.ascontiguousarray(audio[:, s * 1024:(s + 1) * 1024]) for s in range(steps)]
    stream_s = steps * 1024 / cfg.processing_sample_rate
    out, runs, planes, counts = {}, {}, {}, collections.Counter()
    for mode, group in (("full", 0), ("incremental", STREAM_GROUP)):
        ident = StreamingIdentifier(lib, N_CLIPS, 1024, cfg, match_every=4, rematch=mode,
                                    match_stream_group=group, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        history = []
        t0 = time.perf_counter()
        for c in chunks:
            ident.feed(c)
            history.append([(m.track, m.score, m.n_subfingerprints) for m in ident.best()])
        final = ident.finalize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts.update(kernels.launch_counts())
        runs[mode] = history + [[(m.track, m.score, m.n_subfingerprints) for m in final]]
        # The last tick's scores, read again after the launch counts: the
        # full mode's call of the match kernel, the incremental diagonals.
        planes[mode] = (ident._full_scores(*ident._accumulated()).cpu().numpy()
                        if mode == "full" else ident._inc.scores())
        out[f"{mode}_stream_s_per_s"] = N_CLIPS * stream_s / wall
        out[f"{mode}_wall_s"] = wall
        out[f"{mode}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"  rematch={mode}{f', groups of {group}' if group else ''}: {wall * 1e3:.1f} ms "
              f"for {steps} chunks, {out[f'{mode}_stream_s_per_s']:.1f} stream-seconds per "
              f"second, peak {out[f'{mode}_peak_gb']:.2f} GB ({smi})", flush=True)
        del ident
        torch.cuda.empty_cache()
    check(runs["full"] == runs["incremental"],
          f"full and incremental: equal winners, scores bit-equal after each of {steps} chunks")
    plane = planes["full"]
    check(plane.shape == (N_CLIPS, len(lib)) and np.isfinite(plane).all()
          and np.array_equal(plane, planes["incremental"]),
          f"last tick: the match kernel's {list(plane.shape)} score plane equal to the "
          f"incremental matcher's (plain torch) at every entry")
    final = runs["full"][-1]
    check([t for t, _, _ in final] == CLIP_AT,
          f"every stream names its planted track at entries {CLIP_AT[0]}-{CLIP_AT[-1]} "
          f"(scores {min(s for _, s, _ in final):.4f}-{max(s for _, s, _ in final):.4f}, "
          f"{final[0][2]} subfingerprints)")
    return out, counts, runs


def phase_maa_long(dev, rng, fps, smi: str) -> tuple[dict, tuple]:
    """MAA on two written 44.1 kHz WAVs, and the long matchers on a one-hour
    fp1 (LONG_SUBS subfingerprints, padded to LONG_CHUNK) against a 10 s
    query planted with 10 % of its bits flipped at LONG_AT.  Returns the
    measurements and the long matchers' arguments (phase 12's long ring)."""
    import numpy as np
    import torch

    from lbaudiodetective_torch.io.wav import write_wav
    from lbaudiodetective_torch.models.maa import WINDOW, maa_compare_audio_files
    from lbaudiodetective_torch.ops.match import (
        match_fingerprints, match_long_hierarchical, match_long_padded)

    print("[11] MAA and the long matchers", flush=True)
    out = {}
    sig = brown_noise(rng, 1, int(CLIP_SECONDS * 44100))[0]
    sig = 0.5 * sig / np.abs(sig).max()
    crop = sig[40 * WINDOW:40 * WINDOW + 5 * 44100]
    with tempfile.TemporaryDirectory() as tmp:
        write_wav(f"{tmp}/a.wav", sig, 44100)
        write_wav(f"{tmp}/b.wav", crop, 44100)
        t0 = time.perf_counter()
        count = maa_compare_audio_files(f"{tmp}/a.wav", f"{tmp}/b.wav", device=dev)
        out["maa_ms"] = (time.perf_counter() - t0) * 1e3
        cpu_count = maa_compare_audio_files(f"{tmp}/a.wav", f"{tmp}/b.wav", device="cpu")
    windows = len(crop) // WINDOW
    check(count == cpu_count and count >= 0.9 * windows,
          f"maa_compare_audio_files: {count} of {windows} windows match (CPU port {cpu_count})")

    body = fps[:200]                             # fps[-1] occurs only where planted
    reps = -(-LONG_SUBS // body[0].num_subfingerprints)
    pos = np.concatenate([body[i % len(body)].pos for i in range(reps)])[:LONG_SUBS]
    neg = np.concatenate([body[i % len(body)].neg for i in range(reps)])[:LONG_SUBS]
    query = flipped(fps[-1], rng, 0.10)
    n2 = query.num_subfingerprints
    pos[LONG_AT:LONG_AT + n2], neg[LONG_AT:LONG_AT + n2] = fps[-1].pos, fps[-1].neg
    s1 = -(-LONG_SUBS // LONG_CHUNK) * LONG_CHUNK
    p1, q1 = (torch.zeros((s1, 100), dtype=torch.uint8, device=dev) for _ in range(2))
    p1[:LONG_SUBS], q1[:LONG_SUBS] = (torch.from_numpy(x).to(dev) for x in (pos, neg))
    p2, q2 = (torch.zeros((56, 100), dtype=torch.uint8, device=dev) for _ in range(2))
    p2[:n2], q2[:n2] = (torch.from_numpy(x).to(dev) for x in (query.pos, query.neg))
    args = (p1, q1, LONG_SUBS, p2, q2, n2)
    for name, fn in (("padded", lambda: match_long_padded(*args, chunk=LONG_CHUNK, device=dev)),
                     ("hierarchical", lambda: match_long_hierarchical(*args, device=dev))):
        fn()                                          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[f"long_{name}"] = float(fn())
        out[f"long_{name}_ms"] = (time.perf_counter() - t0) * 1e3
    dense = match_fingerprints((pos, neg), (query.pos, query.neg), device=dev)
    check(abs(out["long_padded"] - dense) <= MATCH_TOL and out["long_padded"] > 0.7,
          f"match_long_padded over {LONG_SUBS} subfingerprints: {out['long_padded']:.7f} "
          f"(match_fingerprints {dense:.7f}) in {out['long_padded_ms']:.1f} ms")
    check(abs(out["long_hierarchical"] - out["long_padded"]) <= MATCH_TOL,
          f"match_long_hierarchical finds the same peak: {out['long_hierarchical']:.7f} in "
          f"{out['long_hierarchical_ms']:.1f} ms ({smi})")
    return out, args


N_SLOTS = 4                      # phase 12's mesh: slots on the one card
DEDUP_ROWS = 64                  # rows of the dedup held to the plain matcher's columns
RING_SLICE = 4096                # entries of phase 12c's ring all-pairs


def ring_order_top_k(full, n: int, k: int):
    """Each row's top-k of an all-pairs plane ``full`` in the candidate order
    of a ring of ``n`` slots: slot d meets the blocks of slots d, d - 1, ...
    (mod n) in turn, so an equal score goes to the earlier block, then the
    lower index, as the reference's fold of ``[best | block]`` through
    ``lax.top_k`` keeps it."""
    import torch

    l = full.shape[0] // n
    scores, idx = [], []
    for d in range(n):
        perm = torch.cat([torch.arange(((d - s) % n) * l, ((d - s) % n + 1) * l)
                          for s in range(n)]).to(full.device)
        block = full[d * l:(d + 1) * l][:, perm]
        order = torch.sort(block, dim=1, descending=True, stable=True).indices[:, :k]
        scores.append(torch.gather(block, 1, order))
        idx.append(perm[order])
    return torch.cat(scores), torch.cat(idx)


def phase_sharded(dev, big, svc, fps, clips, long_args, before: dict, smi: str
                  ) -> tuple[dict, collections.Counter]:
    """The sharded layer on one card: every path of ``parallel/`` on a mesh
    of N_SLOTS slots of ``dev``, each held to its unsharded run.  ``big`` is
    phase 6's 1M library and its 16 queries, ``svc`` phase 9's library,
    names and WAV payloads, ``long_args`` phase 11's long planes,
    ``before`` phases 8-11's results.  Returns the measurements and the
    kernels' launch counts over the sharded calls only (the unsharded
    references and the plain matcher are not counted)."""
    import numpy as np
    import torch

    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch.models.library import FingerprintLibrary
    from lbaudiodetective_torch.ops import kernels
    from lbaudiodetective_torch.ops.extract import required_padded_length
    from lbaudiodetective_torch.ops.kernels.match_packed import (
        match_one_vs_many_fused, match_one_vs_many_fused_plain)
    from lbaudiodetective_torch.ops.match_packed import _mask_pairs
    from lbaudiodetective_torch.parallel import (
        ShardedFingerprintLibrary, extract_data_parallel, match_long_time_sharded)
    from lbaudiodetective_torch.parallel.mesh import make_mesh, unshard
    from lbaudiodetective_torch.parallel.pipeline import DeviceSplitPipeline, PipelinedIdentifier
    from lbaudiodetective_torch.parallel.sharded_packed import (
        ring_all_pairs_scores_packed, ring_dedup_topk_packed)
    from lbaudiodetective_torch.serving import IdentificationService
    from lbaudiodetective_torch.streaming import StreamingExtractor, StreamingIdentifier
    from lbaudiodetective_torch.streaming.incremental import _unpack_words

    print(f"[12] the sharded layer on one card: {N_SLOTS} slots on {dev}", flush=True)
    cfg = FingerprintConfig()
    out, counts = {}, collections.Counter()
    lib_mesh = make_mesh(devices=[dev] * N_SLOTS, library_parallelism=N_SLOTS)   # (1, 4)
    data_mesh = make_mesh(devices=[dev] * N_SLOTS, library_parallelism=1)        # (4, 1)
    one = make_mesh(devices=[dev], library_parallelism=1)

    def sharded(fn, *args, **kw):
        """``fn`` with its kernel launches counted (a sharded call)."""
        kernels.reset_launch_counts()
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.synchronize()
            counts.update(kernels.launch_counts())

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, (time.perf_counter() - t0) * 1e3

    # (a) The 1M library split four ways: views, no copy.
    lib, queries = big
    lib.search(queries[0])                 # the reference's own coarse planes, as in phase 6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    slib = ShardedFingerprintLibrary(lib, lib_mesh)
    check(all(p.data_ptr() == lib.pos_words[i * (N_BIG // N_SLOTS)].data_ptr()
              for i, p in enumerate(slib.pos_shards)),
          f"{N_SLOTS}-way ShardedFingerprintLibrary over {N_BIG:,} entries: shards are views")
    walls = {"match": [], "match_sharded": [], "search": [], "search_sharded": []}
    for q in queries:
        ref, ms = timed(lambda: lib.match(q))
        walls["match"].append(ms)
        got, ms = timed(lambda: sharded(slib.match, q))
        walls["match_sharded"].append(ms)
        check_quiet(np.array_equal(got, ref), "sharded match bit-equal to the library's")
    check(True, f"{len(queries)} planted queries: the sharded match bit-equal to the "
                f"library's at all {N_BIG:,} entries")
    mem_match = (torch.cuda.max_memory_allocated() - base) / 1e6
    same_top5 = 0
    for q in queries:
        ref = lib.match(q)
        (ri, rs), ms = timed(lambda: lib.search(q))
        walls["search"].append(ms)
        (gi, gs), ms = timed(lambda: sharded(slib.search, q))
        walls["search_sharded"].append(ms)
        # Each shard shortlists its own 1,024, a superset of the global
        # shortlist's entries in it: the top-1 is the library's, every score
        # is exact, and no rank scores below the library's.
        check_quiet(int(gi[0]) == int(ri[0]) == int(np.argmax(ref)) and gs[0] == rs[0],
                    "sharded search top-1 equal to the library's and the full scan's")
        check_quiet(np.array_equal(gs, ref[gi]) and (gs >= rs).all(),
                    "sharded search scores exact, none below the library's")
        same_top5 += int(np.array_equal(gi, ri))
    check(True, f"search of {len(queries)} planted queries: top-1 and its score equal to the "
                f"library's and the full scan's, every score exact and >= the library's at "
                f"its rank; {same_top5}/{len(queries)} top-5 lists equal")
    gi, gs = sharded(slib.search_many, queries[:8])
    ri, rs = lib.search_many(queries[:8])
    check(np.array_equal(gi[:, 0], ri[:, 0]) and np.array_equal(gs[:, 0], rs[:, 0])
          and (gs >= rs).all(), "search_many x8: top-1 equal to the library's, scores >= its")
    mem_search = (torch.cuda.max_memory_allocated() - base) / 1e6
    out["library"] = {k: float(np.median(v)) for k, v in walls.items()}
    out["library"]["same_top5"] = same_top5
    out["library"]["extra_peak_mb_match"] = mem_match
    out["library"]["extra_peak_mb_search"] = mem_search
    print(f"  1M match wall median {out['library']['match']:.3f} ms (library), "
          f"{out['library']['match_sharded']:.3f} ms ({N_SLOTS} shards); search "
          f"{out['library']['search']:.3f} / {out['library']['search_sharded']:.3f} ms; extra "
          f"peak memory {mem_match:.1f} MB over the matches, {mem_search:.1f} MB with the "
          f"shards' coarse planes ({smi})", flush=True)
    del slib

    # (b) Ring dedup over the service library, k = 8.
    svc_lib, names, payloads = svc
    words = (svc_lib.pos_words, svc_lib.neg_words, svc_lib.counts, svc_lib.pairs)
    (dd_s, dd_i), ms = timed(lambda: sharded(ring_dedup_topk_packed, *words, lib_mesh, k=8))
    dd_s, dd_i = unshard(dd_s), unshard(dd_i)
    (one_s, one_i), ms_one = timed(lambda: ring_dedup_topk_packed(*words, one, k=8))
    rows_tied = int((dd_i != one_i[0]).any(1).sum())
    check(torch.equal(dd_s, one_s[0]),
          f"ring dedup of {len(svc_lib):,} tracks on {N_SLOTS} slots: top-8 scores equal to 1 "
          f"slot's ({ms:.1f} ms, 1 slot {ms_one:.1f} ms); indices differ on {rows_tied} rows, "
          f"at equal scores (below)")
    out["dedup_ms"], out["dedup_one_slot_ms"] = ms, ms_one
    idx = dd_i.cpu().numpy()
    planted = np.zeros(len(svc_lib), bool)
    planted[CLIP_AT + WAV_AT] = True
    copies = np.flatnonzero(~planted)
    original = np.array(CLIP_AT)[copies % N_CLIPS]
    check((idx[copies] == original[:, None]).any(1).all(),
          f"each of {len(copies):,} planted near-duplicates names its original among its 8 "
          f"(first for {(idx[copies, 0] == original).mean():.4f} of them)")
    ok = 0
    for c, at in enumerate(CLIP_AT):
        dup = set(copies[copies % N_CLIPS == c].tolist())   # its unplanted noisy copies
        cand = set(idx[at].tolist())
        ok += cand <= dup if len(dup) >= 8 else dup <= cand
    check(ok == N_CLIPS, f"each of the {N_CLIPS} originals' 8 candidates are its noisy copies "
                         f"(all of them where it has fewer than 8 left)")
    mask = _mask_pairs(svc_lib.pairs, 0, 200)
    launch = match_one_vs_many_fused(*words[:3], *words[:3], mask)    # [query, entry]
    rows = torch.tensor(CLIP_AT[:DEDUP_ROWS], device=dev)
    plain = match_one_vs_many_fused_plain(words[0][rows], words[1][rows], words[2][rows],
                                          *words[:3], mask)
    check(torch.equal(plain, launch[rows]),
          f"one [{len(svc_lib)}, {len(svc_lib)}] launch equal to the plain matcher at "
          f"{DEDUP_ROWS} originals' queries")
    full = launch.T.contiguous()                          # [i, j]: entry i slid, as the ring
    full.fill_diagonal_(-torch.inf)
    for mesh_n, (got_s, got_i) in ((N_SLOTS, (dd_s, dd_i)), (1, (one_s[0], one_i[0]))):
        want_s, want_i = ring_order_top_k(full, mesh_n, 8)
        check(torch.equal(got_s, want_s) and torch.equal(got_i, want_i),
              f"ring dedup on {mesh_n} slot(s) equal to that launch's all-pairs top-8 at every "
              f"row, indices included (ties to the earlier ring step, then the lower index)")
    del launch, full, plain

    # (c) Ring all-pairs on a 4,096-entry slice: one launch, transposed.
    part = tuple(x[:RING_SLICE] for x in words[:3])
    ring, ms = timed(lambda: unshard(sharded(ring_all_pairs_scores_packed, *part, svc_lib.pairs,
                                             lib_mesh)))
    launch = match_one_vs_many_fused(*part, *part, _mask_pairs(svc_lib.pairs, 0, 200))
    check(torch.equal(ring, launch.T), f"ring all-pairs {list(ring.shape)} on {N_SLOTS} slots "
                                       f"equal to one kernel launch ({ms:.1f} ms)")
    out["ring_ms"] = ms

    # (d) Data-parallel extraction of phase 5's clips.
    n_rows = 56 * cfg.rows_per_frame
    audio = np.zeros((len(clips), required_padded_length(cfg, n_rows)), np.float32)
    for i, c in enumerate(clips):
        audio[i, :len(c.samples)] = c.samples[:audio.shape[1]]
    audio_d = torch.from_numpy(audio).to(dev)
    valid = torch.full((len(clips),), 53, dtype=torch.int32, device=dev)
    (pos, neg), ms = timed(lambda: sharded(extract_data_parallel, audio_d, valid, cfg, n_rows,
                                           data_mesh))
    pos, neg = unshard(pos).cpu().numpy(), unshard(neg).cpu().numpy()
    check(all(np.array_equal(pos[i, :53], f.pos) and np.array_equal(neg[i, :53], f.neg)
              for i, f in enumerate(fps)),
          f"extract_data_parallel of {len(clips)} x {CLIP_SECONDS:g} s over {N_SLOTS} data "
          f"slots bit-equal to phase 5's fingerprints ({ms:.1f} ms)")
    out["extract_ms"] = ms

    # (e) The long ring over phase 11's one-hour fingerprint.
    score, ms = timed(lambda: sharded(match_long_time_sharded, *long_args, data_mesh))
    ref = before["long_padded"]
    check(abs(score - ref) <= 1e-5, f"match_long_time_sharded over {LONG_SUBS} subfingerprints "
                                    f"on {N_SLOTS} slots: {score:.7f} (match_long_padded "
                                    f"{ref:.7f}) in {ms:.1f} ms")
    out["long_ms"] = ms

    # (f) PipelinedIdentifier: four batches of 64 clips.
    lib_planes = [_unpack_words(w, svc_lib.pairs).cpu().numpy() for w in words[:2]]
    per = len(clips) // 4                                    # 64 clips a batch
    batches = [(audio[i:i + per], np.full(per, 53, np.int64)) for i in range(0, 4 * per, per)]
    want = [svc_lib.match_many(fps[i:i + per]) for i in range(0, 4 * per, per)]
    pipe = PipelinedIdentifier(*lib_planes, svc_lib.counts.cpu().numpy(), cfg, device=dev)
    list(pipe.run(batches[:2]))                              # warm-up
    submit_ms, got = [], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for b in batches:
        t1 = time.perf_counter()
        r = pipe.submit(*b)
        submit_ms.append((time.perf_counter() - t1) * 1e3)
        if r is not None:
            got.append(r)
    got.append(pipe.drain())
    total = (time.perf_counter() - t0) * 1e3
    counts.update(kernels.launch_counts())
    t0 = time.perf_counter()
    for b in batches:
        pipe._match(*pipe._extract(*b), b[1]).cpu()          # a serial loop, not counted
    serial = (time.perf_counter() - t0) * 1e3
    check(all(np.array_equal(g, w) for g, w in zip(got, want)),
          f"PipelinedIdentifier: 4 x {per} clips' scores equal match_many's (submits "
          f"{', '.join(f'{x:.1f}' for x in submit_ms)} ms, total {total:.1f} ms, serial "
          f"loop {serial:.1f} ms)")
    out["pipeline"] = {"submit_ms": submit_ms, "total_ms": total, "serial_ms": serial}

    # (g) DeviceSplitPipeline: extract on slots {0, 1}, match on {2, 3}.
    slots = list(lib_mesh.slots.flat)
    split = DeviceSplitPipeline(*lib_planes, svc_lib.counts.cpu().numpy(), slots[:2],
                                slots[2:], cfg)
    res = [sharded(split.submit, *b) for b in batches][1:] + [sharded(split.drain)]
    check(all(np.array_equal(g, w) for g, w in zip(res, got)),
          "DeviceSplitPipeline (extract on slots 0-1, match on 2-3 of one card): scores "
          "equal to the pipeline's")
    del pipe, split, lib_planes

    # (h) Sharded streaming, 256 streams x 10 s: aligned and conv steps.
    stream_audio = np.stack([c.samples for c in clips])
    for name, chunk in (("aligned", 1024), ("conv", 512)):
        steps = stream_audio.shape[1] // chunk
        chunks = [np.ascontiguousarray(stream_audio[:, s * chunk:(s + 1) * chunk])
                  for s in range(steps)]
        plain_ext = StreamingExtractor(N_CLIPS, chunk, cfg, dev, collect_host=False)
        mesh_ext = StreamingExtractor(N_CLIPS, chunk, cfg, dev, collect_host=False,
                                      mesh=data_mesh)
        for c in chunks[:8]:                                    # warm-up
            mesh_ext.feed(c)
        mesh_ext.reset()
        for c in chunks:
            plain_ext.feed(c)
        torch.cuda.synchronize()
        prev = torch.cuda.get_sync_debug_mode()
        kernels.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")              # any host wait raises
        try:
            t0 = time.perf_counter()
            for c in chunks:
                mesh_ext.feed(c)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts.update(kernels.launch_counts())
        rtf = N_CLIPS * steps * chunk / cfg.processing_sample_rate / wall
        out[f"stream_{name}_rtf"] = rtf
        check(plain_ext.fingerprints() == mesh_ext.fingerprints(),
              f"StreamingExtractor(mesh=...) {name}: {N_CLIPS} streams over {N_SLOTS} data slots "
              f"bit-equal to the unsharded extractor; RTF {rtf:.1f} (phase 8: "
              f"{before[f'{name}_rtf']:.1f}; {smi})")
        del plain_ext, mesh_ext

    # (i) The streaming identifier and the service on the sharded 16,384 library.
    s_svc_lib = ShardedFingerprintLibrary(svc_lib, lib_mesh)
    id_chunks = [np.ascontiguousarray(stream_audio[:, s * 1024:(s + 1) * 1024])
                 for s in range(stream_audio.shape[1] // 1024)]
    for mode, group in (("full", 0), ("incremental", STREAM_GROUP)):
        ident = StreamingIdentifier(s_svc_lib, N_CLIPS, 1024, cfg, match_every=4,
                                    rematch=mode, match_stream_group=group, device=dev)
        history = []
        t0 = time.perf_counter()
        for c in id_chunks:
            sharded(ident.feed, c)
            history.append([(m.track, m.score, m.n_subfingerprints) for m in ident.best()])
        final = sharded(ident.finalize)
        wall = time.perf_counter() - t0
        history.append([(m.track, m.score, m.n_subfingerprints) for m in final])
        out[f"identify_{mode}_stream_s_per_s"] = N_CLIPS * CLIP_SECONDS / wall
        check(history == before["identify_runs"][mode],
              f"StreamingIdentifier rematch={mode} on the sharded library: winners and scores "
              f"equal to phase 10's after each of {len(id_chunks)} chunks "
              f"({out[f'identify_{mode}_stream_s_per_s']:.1f} stream-s/s)")
        del ident
        torch.cuda.empty_cache()
    batching = dict(batch_window_s=0.02, max_batch=8, device=dev)
    s_svc = IdentificationService(s_svc_lib, names, cfg, **batching)
    ref_svc = IdentificationService(svc_lib, names, cfg, **batching)
    wav = payloads[:N_WAV]
    with serving(s_svc) as addr:
        concurrently(lambda p: http_call(addr, "POST", "/identify", p), [(p,) for p in wav])
        kernels.reset_launch_counts()
        answers = concurrently(lambda p: http_call(addr, "POST", "/identify", p),
                               [(p,) for p in wav])
        counts.update(kernels.launch_counts())
    refs = [ref_svc.identify(p) for p in wav]
    check(all(st == 200 and a["track"] == r["track"] == names[WAV_AT[j]]
              and a["score"] == r["score"]
              and all(e["score"] == float(svc_lib.match(wav_fp)[names.index(e["track"])])
                      for e in a.get("top", []))
              for j, ((st, a, _), r, wav_fp) in enumerate(zip(answers, refs,
                                                              before["wav_fps"]))),
          f"{N_WAV} concurrent /identify on the sharded library: winners and scores equal to "
          f"the unsharded service's, every top-5 score exact")
    return out, counts


def nvidia_smi_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True)
    return proc.stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    """The card's highest SM clock (``nvidia-smi``'s clocks.max.sm)."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                           "--format=csv,noheader,nounits"], capture_output=True, text=True,
                          check=True)
    return float(proc.stdout.strip().splitlines()[0])


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
    from lbaudiodetective_torch.ops.kernels._build import load_library, ptxas_report

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
    for line in ptxas_report().splitlines():
        if line.startswith("==") or "entry function" in line or "spill" in line or "Used" in line:
            print(f"    {line.strip()}", flush=True)

    rng = np.random.default_rng(0)
    records = [phase_select(dev, rng), phase_rows(dev, rng)]

    kernels.reset_launch_counts()
    main_out, fps, library, clips = phase_main_path(dev, rng)
    counts = kernels.launch_counts()
    for name in ("fused_band_rows", "match_one_vs_many_fused"):
        check(counts[name] > 0, f"main path launched {name} {counts[name]} times")
    for r in records:
        r["launches"] = counts[r["name"]]
    match_launches = counts["match_one_vs_many_fused"]
    main_out.update(time_library_match(dev, library))
    print(f"  on {smi}: {main_out['clips_per_s']:.1f} clips/s at B={N_CLIPS}, "
          f"1 x {N_LIBRARY} match {main_out['match_ms']:.3f} ms", flush=True)

    t0 = time.perf_counter()
    lib, queries, originals, clip_of = build_big_library(dev, fps)
    torch.cuda.synchronize()
    print(f"[6] {N_BIG:,}-entry library built on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    records.append(phase_match_kernel(dev, lib, queries, smi, sm_clock_mhz()))
    kernels.reset_launch_counts()
    main_out["library"] = phase_library(dev, lib, queries, originals, clip_of, smi)
    n = kernels.launch_counts()["match_one_vs_many_fused"]
    check(n > 0, f"library path launched match_one_vs_many_fused {n} times")
    records[-1]["launches"] = match_launches + n
    del lib

    band = phase_band_rows(dev, rng, smi)
    kernels.reset_launch_counts()
    main_out["every_config"] = phase_every_config(dev, rng)
    counts = kernels.launch_counts()
    check(counts["band_rows"] > 0, f"every-config path launched band_rows "
                                   f"{counts['band_rows']} times")
    for r in band.values():
        r["launches"] = counts["band_rows"]
    main_out["streaming"], counts = phase_streaming(dev, rng, smi)
    for name in ("select_sign_classes", "fused_band_rows"):
        check(counts[name] > 0, f"streaming launched {name} {counts[name]} times")
    for r in (*records, *band.values()):
        r["launches"] += counts[r["name"]]
    records += band.values()

    torch.cuda.empty_cache()
    svc_lib, names, payloads, wav_fps = service_library(dev, rng, fps, library)
    main_out["service"], counts = phase_service(dev, svc_lib, names, payloads, wav_fps, fps,
                                                smi)
    main_out["stream_identify"], more, runs = phase_stream_identify(dev, svc_lib, clips, smi)
    counts.update(more)
    for name in ("fused_band_rows", "match_one_vs_many_fused", "slot_fold"):
        check(counts[name] > 0, f"service + streaming identifier launched {name} "
                                f"{counts[name]} times")
    for r in records:
        r["launches"] += counts[r["name"]]
    records.append(phase_slot_fold(dev, smi, sm_clock_mhz()))
    records[-1]["launches"] = counts["slot_fold"]
    main_out["maa_long"], long_args = phase_maa_long(dev, rng, fps, smi)

    before = {**main_out["streaming"], "long_padded": main_out["maa_long"]["long_padded"],
              "identify_runs": runs, "wav_fps": wav_fps}
    big = build_big_library(dev, fps)[:2]           # phase 6's library, from its seed
    main_out["sharded"], counts = phase_sharded(dev, big, (svc_lib, names, payloads), fps, clips,
                                                long_args, before, smi)
    for name in ("select_sign_classes", "fused_band_rows", "match_one_vs_many_fused"):
        check(counts[name] > 0, f"the sharded layer launched {name} {counts[name]} times")
    for r in records:
        r["launches"] += counts[r["name"]]
    del big
    check("jax" not in sys.modules, "no JAX module was imported")

    print(json.dumps({"main_path": main_out}))
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
