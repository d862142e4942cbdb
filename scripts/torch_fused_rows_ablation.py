"""Where the time goes inside the fused rows kernel (csrc/fused_rows.cu):
builds the kernels with one step of the fused rows kernel switched off at a
time (``-DLBAD_FUSED_ROWS_SKIP=<bits>``, see the kernel's source) and times
each build at the main path's [256, 7168 rows] (classes mode) and at the
aligned streaming step's [256, 128 rows].  The full kernel is also held to
the plain version evaluated in float64 at hop 8, 64 and 128 (largest error
as a share of the bar rtol 5e-4, atol 3e-6 * max).  The builds with a step
switched off compute wrong results; only their times mean anything.  Run
from the repo root on one GPU:

    python scripts/torch_fused_rows_ablation.py

The card's name and power limit are printed first; every number is for it.
"""
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.ops.constants import constants_to_tensors  # noqa: E402
from lbaudiodetective_torch.ops.extract import required_padded_length  # noqa: E402
from lbaudiodetective_torch.ops.kernels import _build  # noqa: E402
from lbaudiodetective_torch.ops.kernels.fused_rows import (  # noqa: E402
    fused_band_rows, fused_band_rows_plain, rows_arrays)

#: Each step of the kernel and its bit of LBAD_FUSED_ROWS_SKIP.
STEPS = {"stage 1": 1, "stage-2 mma": 2, "band projection": 4, "fragment copies": 8,
         "select": 16}
VARIANTS = {"full kernel": 0, **{f"without {name}": bit for name, bit in STEPS.items()},
            "without all five": sum(STEPS.values())}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs one GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases = []
    for kw in (dict(), dict(hop_domain="proc"), dict(hop_domain="proc", analysis_stride=128)):
        cfg = FingerprintConfig(**kw)
        consts = constants_to_tensors(rows_arrays(cfg), dev)
        audio = torch.from_numpy(cs.brown_noise(rng, 4, required_padded_length(cfg, 7168))).to(dev)
        exp = fused_band_rows_plain(audio.double(), cfg, 7168,
                                    {k: v.double() for k, v in consts.items()}, emit="coeffs")
        cases.append((cfg, consts, audio, exp))
    cfg, consts = cases[0][0], cases[0][1]
    batch = torch.from_numpy(cs.brown_noise(rng, 256, required_padded_length(cfg, 7168))).to(dev)
    step = batch[:, :required_padded_length(cfg, 128)].contiguous()
    for name, skip in VARIANTS.items():
        flags = (f"-DLBAD_FUSED_ROWS_SKIP={skip}",) if skip else ()
        _build.load_library(flags)
        report = _build.ptxas_report(flags).split("== fused_rows.cu", 1)[-1].split("==", 1)[0]
        info = [ln.strip() for ln in report.splitlines() if "spill" in ln or "Used" in ln]
        print(f"[{name}] ptxas: {' | '.join(info)}", flush=True)
        if not skip:
            for c, k, audio, exp in cases:
                got = fused_band_rows(audio, c, 7168, k, emit="coeffs").double()
                print(f"[{name}] hop {int(c.hop_in_processing_samples)}: largest error "
                      f"{cs.bar_share(got, exp):.3f} of the bar against the float64 plain "
                      f"version", flush=True)
        ms = cs.cuda_ms(lambda: fused_band_rows(batch, cfg, 7168, consts))
        ms_step = cs.cuda_ms(lambda: fused_band_rows(step, cfg, 128, consts), iters=50)
        print(f"[{name}] [256, 7168 rows] {ms:.3f} ms; [256, 128 rows] {ms_step:.3f} ms",
              flush=True)
    _build.load_library(())


if __name__ == "__main__":
    main()
