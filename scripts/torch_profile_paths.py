"""Where the time goes in the port's 256-stream streaming paths (aligned chunk
1024, conv chunk 512, fractional-hop gather chunk 1024, 10 s a stream), its
parity and fractional-hop batches of 256 ten-second clips, and its library
path (``FingerprintLibrary.match`` and ``search`` over 1,048,576 packed
entries of 31-80 rows built from a seed): walls, device busy from
torch.profiler (kernel and memcpy rows only) and host hot spots from
cProfile.  Run from the repo root on one GPU:

    python scripts/torch_profile_paths.py [cuda|cpu] [batch] [streams,batches,library]

The third argument picks the parts (all three by default); on the CPU the
library has 4,096 entries.  The card's name and power limit are printed
first; every number is for it."""
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
PARTS = (sys.argv[3] if len(sys.argv) > 3 else "streams,batches,library").split(",")
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


def profile_device(name, fn):
    """Wall, device busy and the top device rows of one profiled call."""
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    busy, lines = device_rows(prof)
    print(f"[{name}] profiled wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / (wall * 1e3):.1f} %)\n{lines}", flush=True)


STREAMS = (("aligned", FingerprintConfig(), 1024), ("conv", FingerprintConfig(), 512),
           ("gather", FingerprintConfig(integer_hop=False), 1024))
for name, cfg, chunk in STREAMS if "streams" in PARTS else ():
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
    profile_device(name, run)
    ext.reset()
    sync()
    print(host_profile(run), flush=True)

BATCHES = (("parity batch", FingerprintConfig()),
           ("fractional batch", FingerprintConfig(integer_hop=False)))
for name, cfg in BATCHES if "batches" in PARTS else ():
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
    profile_device(name, lambda: det.process_decoded_batch(clips))
    print(host_profile(lambda: det.process_decoded_batch(clips)), flush=True)

if "library" in PARTS:
    from lbaudiodetective_torch.models.fingerprint import Fingerprint
    from lbaudiodetective_torch.models.library import FingerprintLibrary

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    n_lib = 1 << 20 if cuda else 4096
    lib = FingerprintLibrary(*cs.random_words(gen, dev, n_lib, cs.BIG_S, 100), 100,
                             FingerprintConfig())
    pw = lib.pos_words[3, :int(lib.counts[3])].cpu().numpy().view(np.uint32)
    nw = lib.neg_words[3, :int(lib.counts[3])].cpu().numpy().view(np.uint32)
    full = Fingerprint.from_packed(pw, nw, 100)
    query = Fingerprint(full.pos[2:], full.neg[2:])      # a crop of entry 3
    for name, fn in ((f"library match 1 x {n_lib:,}", lambda: lib.match(query)),
                     (f"library search 1 x {n_lib:,}", lambda: lib.search(query))):
        fn()
        sync()
        walls = []
        for _ in range(7):
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        print(f"[{name}] walls {[round(w * 1e3, 3) for w in walls]} ms, median "
              f"{np.median(walls) * 1e3:.3f} ms", flush=True)
        profile_device(name, fn)
        print(host_profile(fn), flush=True)
