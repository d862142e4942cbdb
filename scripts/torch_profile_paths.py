"""Where the time goes in the port's 256-stream streaming paths (aligned chunk
1024, conv chunk 512, fractional-hop gather chunk 1024, 10 s a stream) and its
parity and fractional-hop batches of 256 ten-second clips: walls, device busy from
torch.profiler (kernel and memcpy rows only) and host hot spots from
cProfile.  Run from the repo root on one GPU:

    python scripts/torch_profile_paths.py [cuda|cpu] [batch]

The card's name and power limit are printed first; every number is for it."""
import cProfile
import io
import pstats
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")
from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.models.detective import AudioDetective  # noqa: E402
from lbaudiodetective_torch.streaming import StreamingExtractor  # noqa: E402
import chip_smoke as cs  # noqa: E402

dev = torch.device(sys.argv[1] if len(sys.argv) > 1 else "cuda")
B = int(sys.argv[2]) if len(sys.argv) > 2 else 256
cuda = dev.type == "cuda"
sync = torch.cuda.synchronize if cuda else (lambda: None)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
if cuda:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
rng = np.random.default_rng(0)


def device_rows(prof, top=12):
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    rows.sort(key=lambda e: -e.self_device_time_total)
    lines = [f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:100]}"
             for e in rows[:top]]
    return busy, "\n".join(lines)


def host_profile(fn, top=16):
    pr = cProfile.Profile()
    pr.enable()
    fn()
    sync()
    pr.disable()
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("tottime").print_stats(top)
    return "\n".join(s.getvalue().splitlines()[:top + 12])


for name, cfg, chunk in (("aligned", FingerprintConfig(), 1024),
                         ("conv", FingerprintConfig(), 512),
                         ("gather", FingerprintConfig(integer_hop=False), 1024)):
    steps = int(10 * cfg.processing_sample_rate) // chunk
    audio = cs.brown_noise(rng, B, steps * chunk)
    chunks = [np.ascontiguousarray(audio[:, s * chunk:(s + 1) * chunk]) for s in range(steps)]
    ext = StreamingExtractor(batch=B, chunk_size=chunk, config=cfg, device=dev,
                             collect_host=False)

    def run():
        for c in chunks:
            ext.feed(c)

    for _ in range(3):
        ext.reset()
        sync()
        t0 = time.perf_counter()
        run()
        enq = time.perf_counter() - t0
        sync()
        wall = time.perf_counter() - t0
        print(f"[{name}] wall {wall * 1e3:.3f} ms, enqueue {enq * 1e3:.3f} ms, "
              f"RTF {B * steps * chunk / cfg.processing_sample_rate / wall:.1f}", flush=True)
    ext.reset()
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall = time.perf_counter() - t0
    busy, lines = device_rows(prof)
    print(f"[{name}] profiled wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / (wall * 1e3):.1f} %)\n{lines}", flush=True)
    ext.reset()
    sync()
    print(host_profile(run), flush=True)

for name, cfg in (("parity batch", FingerprintConfig()),
                  ("fractional batch", FingerprintConfig(integer_hop=False))):
    det = AudioDetective(cfg, device=dev)
    clips = cs.synth_clips(rng, cfg, B, 10.0)
    det.process_decoded_batch(clips)
    sync()
    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        det.process_decoded_batch(clips)
        walls.append(time.perf_counter() - t0)
    print(f"[{name}] walls {[round(w * 1e3, 3) for w in walls]} ms, median "
          f"{np.median(walls) * 1e3:.3f} ms, {B / np.median(walls):.1f} clips/s", flush=True)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        det.process_decoded_batch(clips)
        sync()
        wall = time.perf_counter() - t0
    busy, lines = device_rows(prof)
    print(f"[{name}] profiled wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms\n{lines}",
          flush=True)
    print(host_profile(lambda: det.process_decoded_batch(clips)), flush=True)
