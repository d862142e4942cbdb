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
kernel alone at [256, 128 rows]), the same 256 streams through the conv
step (chunk 512) and the fractional-hop gather step (chunk 1024): median
real-time factor of the same count of feeds, as ``chip_smoke.py`` phase 8
times them; a 1,048,576-entry library of random words (31-80 rows of 80)
made on the card from a seed: ``FingerprintLibrary.match`` wall (median of
10) and ``search``'s device span and wall for 16 of its entries as queries
(median, as phase 6 times them); the whole call
``AudioDetective.match_against_library`` makes for one query against
16,384 random fingerprints of 53 subfingerprints, host packing included
(median of 5 warm calls, as phase 5 times it once); and the parity batch of
256 ten-second clips (median of 5 warm calls).  Unpack the other commit into a git-ignored directory and run both
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


def big_library():
    """1,048,576 entries of random disjoint pos/neg words, 31-80 valid rows
    of 80, on the card (``chip_smoke.py``'s ``random_words`` layout)."""
    from lbaudiodetective_torch.models.library import FingerprintLibrary

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    n, s = 1 << 20, 80

    def rand():
        return torch.randint(0, 256, (n, s, 16), dtype=torch.uint8, generator=gen,
                             device="cuda").view(torch.int32)

    counts = torch.randint(31, 81, (n,), dtype=torch.int32, generator=gen, device="cuda")
    sign, nz = rand(), ~(rand() & rand() & rand() & rand() & rand())
    bits = torch.tensor([-1, -1, -1, 15], dtype=torch.int32, device="cuda")   # 100 pairs
    past = (torch.arange(s, device="cuda") >= counts[:, None])[..., None]
    return FingerprintLibrary((sign & nz & bits).masked_fill_(past, 0),
                              (~sign & nz & bits).masked_fill_(past, 0), counts, 100,
                              FingerprintConfig())


def big_query(lib, i: int):
    """Entry ``i`` of ``lib`` as a query Fingerprint."""
    from lbaudiodetective_torch.models.fingerprint import Fingerprint

    n = int(lib.counts[i])
    pos, neg = (w[i, :n].cpu().numpy().view(np.uint32) for w in (lib.pos_words, lib.neg_words))
    return Fingerprint.from_packed(pos, neg, 100)


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
    step_rtf = {}
    for name, step_cfg, chunk in (("conv", cfg, 512),
                                  ("gather", FingerprintConfig(integer_hop=False), 1024)):
        steps = int(10 * step_cfg.processing_sample_rate) // chunk
        pieces = [np.ascontiguousarray(c) for c in
                  np.split(brown(rng, 256, steps * chunk), steps, axis=1)]
        sx = StreamingExtractor(batch=256, chunk_size=chunk, config=step_cfg, device="cuda",
                                collect_host=False)
        for c in pieces[:8]:
            sx.feed(c)
        walls = []
        for _ in range(feeds):
            sx.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for c in pieces:
                sx.feed(c)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        step_rtf[name] = 256 * steps * chunk / step_cfg.processing_sample_rate / np.median(walls)
    big = big_library()
    queries = [big_query(big, i) for i in range(0, 1 << 20, 1 << 16)]
    big.match(queries[0])
    walls = []
    for q in queries[:10]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        big.match(q)
        walls.append(time.perf_counter() - t0)
    match_1m_ms = float(np.median(walls)) * 1e3
    big.search(queries[0])
    spans, walls = [], []
    for q in queries:
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        big.search(q)
        end.record()
        walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end))
    search_ms, search_wall_ms = float(np.median(spans)), float(np.median(walls)) * 1e3
    del big
    det = AudioDetective(cfg, device="cuda")
    from lbaudiodetective_torch.models.fingerprint import Fingerprint

    cls = rng.integers(0, 3, (16384, 53, 100), dtype=np.uint8)
    entries = [Fingerprint((c == 1).astype(np.uint8), (c == 2).astype(np.uint8)) for c in cls]
    det.match_against_library(entries[0], entries)
    calls = []
    for _ in range(5):
        t0 = time.perf_counter()
        det.match_against_library(entries[0], entries)
        calls.append(time.perf_counter() - t0)
    match_call_ms = float(np.median(calls)) * 1e3
    del entries, cls
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
          f"{rtf:.1f}), {feed_device_ms:.1f} ms on the device; conv RTF {step_rtf['conv']:.1f}, "
          f"gather RTF {step_rtf['gather']:.1f}; 1M match {match_1m_ms:.3f} ms, search "
          f"{search_ms:.3f} ms span ({search_wall_ms:.3f} ms wall); match_against_library "
          f"call {match_call_ms:.1f} ms; parity batch median "
          f"{np.median(batch) * 1e3:.1f} ms "
          f"{[round(v * 1e3, 1) for v in batch]}", flush=True)
    print(json.dumps({"tree": os.getcwd(), "fused_ms": fused_ms, "match_ms": match_ms,
                      "match_device_ms": match_device_ms, "step_ms": step_ms, "rtf": rtf,
                      "aligned_enqueue_ms": float(np.median(enqueue)) * 1e3,
                      "aligned_device_ms": feed_device_ms,
                      "aligned_wall_ms": float(np.median(wall)) * 1e3,
                      "conv_rtf": step_rtf["conv"], "gather_rtf": step_rtf["gather"],
                      "match_1m_wall_ms": match_1m_ms, "search_device_ms": search_ms,
                      "search_wall_ms": search_wall_ms, "match_call_ms": match_call_ms,
                      "batch_ms": float(np.median(batch)) * 1e3}), flush=True)


if __name__ == "__main__":
    main()
