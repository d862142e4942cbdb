"""The parity paths of the tree in the current directory, for comparing two
commits on one card: the fused rows kernel (``csrc/fused_rows.cu``, classes)
at the parity batch's [256, 7168 rows] (CUDA events, mean of 10), the
call ``AudioDetective.match_against_library`` makes for one query against
16,384 packed entries of 53 rows (``match_one_vs_many_packed``, CUDA events,
mean of 10: host-paced as ``chip_smoke.py`` phase 5 times it, and with the
launches queued behind a sleep on the card, its device time alone), 256
streams fed 10 s through the aligned step (chunk 1024,
``collect_host=False``; median of 5 feeds, or of the count given as the one
argument: enqueue time, wall and real-time factor; and the least of three
feeds queued behind a sleep: their device time alone, beside the step's
kernel alone at [256, 128 rows]) and the parity batch of 256 ten-second
clips (median of 5 warm calls).  Unpack the other commit into a git-ignored directory and run both
in turns, from each tree's root:

    cd build/parent && python ../../scripts/torch_ab_paths.py
    python scripts/torch_ab_paths.py

It imports the package of the directory it runs in and prints that
directory with the card's name and power limit, then the numbers as one
JSON line."""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402

from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.io.decode import DecodedAudio  # noqa: E402
from lbaudiodetective_torch.ops.constants import constants_to_tensors  # noqa: E402
from lbaudiodetective_torch.ops.extract import required_padded_length  # noqa: E402
from lbaudiodetective_torch.ops.kernels.fused_rows import fused_band_rows, rows_arrays  # noqa: E402
from lbaudiodetective_torch.models.detective import AudioDetective  # noqa: E402
from lbaudiodetective_torch.ops.match_packed import match_one_vs_many_packed  # noqa: E402
from lbaudiodetective_torch.streaming import StreamingExtractor  # noqa: E402


def brown(rng, b: int, n: int) -> np.ndarray:
    x = rng.standard_normal((b, n)).astype(np.float32) * 0.1
    return (np.cumsum(x, axis=1) * 0.05).astype(np.float32)


def packed_library(rng, n: int, rows: int, used: int, w: int = 4):
    """``n`` entries of ``used`` valid rows (of ``rows``) of random disjoint
    pos/neg words on the card, as ``pack_fingerprints`` lays them out."""
    pos = rng.integers(0, 2 ** 32, (n, rows, w), dtype=np.uint32)
    neg = rng.integers(0, 2 ** 32, (n, rows, w), dtype=np.uint32) & ~pos
    pos[:, used:] = 0
    neg[:, used:] = 0
    return (torch.from_numpy(pos.view(np.int32)).cuda(), torch.from_numpy(neg.view(np.int32)).cuda(),
            torch.full((n,), used, dtype=torch.int32, device="cuda"))


def events_ms(fn, iters: int = 10, queued: bool = False, warmup: int = 2) -> float:
    """Mean time of ``fn`` between CUDA events; with ``queued`` the launches
    are enqueued behind a sleep on the card (~0.2 s), so the host's pace
    drops out."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(400_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    feeds = int(sys.argv[1]) if sys.argv[1:] else 5
    if not torch.cuda.is_available():
        raise SystemExit("needs one GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    rng = np.random.default_rng(0)
    cfg = FingerprintConfig()
    consts = constants_to_tensors(rows_arrays(cfg), "cuda")
    audio = torch.from_numpy(brown(rng, 256, required_padded_length(cfg, 7168))).cuda()
    for _ in range(2):
        fused_band_rows(audio, cfg, 7168, consts)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        fused_band_rows(audio, cfg, 7168, consts)
    end.record()
    torch.cuda.synchronize()
    fused_ms = start.elapsed_time(end) / 10
    step = audio[:, :required_padded_length(cfg, 128)].contiguous()
    step_ms = events_ms(lambda: fused_band_rows(step, cfg, 128, consts), queued=True)
    lp, ln, nl = packed_library(rng, 16384, 64, 53)
    match = lambda: match_one_vs_many_packed(lp[:1], ln[:1], nl[:1], lp, ln, nl, 100)  # noqa: E731
    match_ms, match_device_ms = events_ms(match), events_ms(match, queued=True)
    chunks = [np.ascontiguousarray(c) for c in np.split(brown(rng, 256, 53 * 1024), 53, axis=1)]
    ext = StreamingExtractor(batch=256, chunk_size=1024, config=cfg, device="cuda",
                             collect_host=False)
    for c in chunks[:8]:
        ext.feed(c)
    enqueue, wall = [], []
    for _ in range(feeds):
        ext.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in chunks:
            ext.feed(c)
        enqueue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    def feed_all():
        ext.reset()
        for c in chunks:
            ext.feed(c)
    feed_device_ms = min(events_ms(feed_all, iters=1, queued=True, warmup=0) for _ in range(3))
    det = AudioDetective(cfg, device="cuda")
    x = brown(rng, 256, int(10 * cfg.processing_sample_rate))
    clips = [DecodedAudio(x[i], cfg.processing_sample_rate, int(10 * cfg.file_sample_rate),
                          cfg.file_sample_rate) for i in range(256)]
    det.process_decoded_batch(clips)
    batch = []
    for _ in range(5):
        t0 = time.perf_counter()
        det.process_decoded_batch(clips)
        batch.append(time.perf_counter() - t0)
    rtf = 256 * 53 * 1024 / cfg.processing_sample_rate / np.median(wall)
    print(f"{os.getcwd()} ({smi}): fused rows [256, 7168 rows] {fused_ms:.3f} ms, [256, 128 "
          f"rows] {step_ms:.4f} ms on the device; 1 x 16,384 "
          f"match {match_ms:.4f} ms ({match_device_ms:.4f} ms on the device); aligned enqueue "
          f"{np.median(enqueue) * 1e3:.1f} ms, wall {np.median(wall) * 1e3:.1f} ms (RTF "
          f"{rtf:.1f}), {feed_device_ms:.1f} ms on the device; parity batch median {np.median(batch) * 1e3:.1f} ms "
          f"{[round(v * 1e3, 1) for v in batch]}", flush=True)
    print(json.dumps({"tree": os.getcwd(), "fused_ms": fused_ms, "match_ms": match_ms,
                      "match_device_ms": match_device_ms, "step_ms": step_ms, "rtf": rtf,
                      "aligned_enqueue_ms": float(np.median(enqueue)) * 1e3,
                      "aligned_device_ms": feed_device_ms,
                      "aligned_wall_ms": float(np.median(wall)) * 1e3,
                      "batch_ms": float(np.median(batch)) * 1e3}), flush=True)


if __name__ == "__main__":
    main()
