"""Where the time goes inside the packed match kernel (csrc/match_packed.cu):
builds the kernels with one step of the match kernel switched off at a time
(``-DLBAD_MATCH_SKIP=<bits>``, see the kernel's source) and times each build
on a 1,048,576-entry library of 31-80 rows built from a seed (BASELINE
config 5's size): a full scan (1 query, W=4, every word compared), the
coarse pass of a search (4 phases of the query's every 4th row against the
library's every 4th row, range 64: 32 pairs, one word compared) and
``match_against_library``'s 1 x 16,384 at 56 rows.  With the full kernel it
also times other bounds on the chunk size (``match_packed.CHUNK_ENTRIES``).
The builds with a step switched off compute wrong scores; only their times
mean anything.  Run from the repo root on one GPU:

    python scripts/torch_match_ablation.py

The card's name and power limit are printed first; every number is for it.
"""
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from lbaudiodetective_torch.ops.kernels import _build  # noqa: E402
from lbaudiodetective_torch.ops.kernels import match_packed as mp  # noqa: E402
from lbaudiodetective_torch.ops.match_packed import _mask_pairs  # noqa: E402

#: Each step of the kernel and its bit of LBAD_MATCH_SKIP.
STEPS = {"chain sums": 1, "inv_lib and flags": 2, "row copies": 4, "work items": 8}
VARIANTS = {"full kernel": 0, **{f"without {name}": bit for name, bit in STEPS.items()},
            "without all four": sum(STEPS.values())}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs one GPU")
    print(cs.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    lp, ln, nl = cs.random_words(gen, dev, cs.N_BIG, cs.BIG_S, 100)
    query = (lp[3:4], ln[3:4], nl[3:4])
    lpc, lnc, nlc = lp[:, ::4].contiguous(), ln[:, ::4].contiguous(), (nl + 3) // 4
    coarse_q = (lpc[3:7], lnc[3:7], nlc[3:7])
    small = (lp[:16384, :56].contiguous(), ln[:16384, :56].contiguous(),
             nl[:16384].clamp(max=56))
    small_q = (small[0][:1], small[1][:1], small[2][:1])
    shapes = {"full scan 1 x 1M": lambda: mp.match_one_vs_many_fused(*query, lp, ln, nl, 100),
              "coarse 4 x 1M": lambda: mp.match_one_vs_many_fused(*coarse_q, lpc, lnc, nlc,
                                                                  _mask_pairs(100, 64, 200)),
              "1 x 16,384": lambda: mp.match_one_vs_many_fused(*small_q, *small, 100)}
    for name, skip in VARIANTS.items():
        flags = (f"-DLBAD_MATCH_SKIP={skip}",) if skip else ()
        _build.load_library(flags)
        report = _build.ptxas_report(flags).split("== match_packed.cu", 1)[-1].split("==", 1)[0]
        info = [ln_.strip() for ln_ in report.splitlines() if "Used" in ln_]
        times = {k: cs.cuda_ms(fn) for k, fn in shapes.items()}
        print(f"[{name}] {'; '.join(f'{k} {v:.3f} ms' for k, v in times.items())} "
              f"(ptxas: {' | '.join(info)})", flush=True)
    _build.load_library(())
    default = mp.CHUNK_ENTRIES
    for e in (16, 32, 128):
        mp.CHUNK_ENTRIES = e
        mp._device_plan.cache_clear()
        times = {k: cs.cuda_ms(fn) for k, fn in shapes.items()}
        print(f"[chunks of up to {e} entries] "
              f"{'; '.join(f'{k} {v:.3f} ms' for k, v in times.items())}", flush=True)
    mp.CHUNK_ENTRIES = default
    mp._device_plan.cache_clear()


if __name__ == "__main__":
    main()
