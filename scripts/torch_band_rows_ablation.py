"""Where the time goes inside the band-rows kernel (csrc/band_rows.cu), and
what its accumulation order buys: builds the kernels with one step of the
band-rows kernel switched off at a time (``-DLBAD_BAND_ROWS_SKIP=<bits>``,
see the kernel's source) and times each build at the fractional-hop batch's
launch shape, [256, 7168 rows] in rows mode.  Bit 16 builds the kernel with
stage 2 summed straight into the running sums, as csrc/fused_rows.cu does;
for it and the full kernel the script also prints the largest error against
the plain version evaluated in float64 (as a share of the bar rtol 5e-4,
atol 3e-6 * max) on 16 clips, and the bit agreement with the NumPy oracle of
the card test's two 4 s clips at subfingerprint_length=300.  The builds with
a step switched off compute wrong results; only their times mean anything.
Run from the repo root on one GPU:

    python scripts/torch_band_rows_ablation.py

The card's name and power limit are printed first; every number is for it.
"""
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.models.detective import AudioDetective  # noqa: E402
from lbaudiodetective_torch.oracle.pipeline import oracle_fingerprint  # noqa: E402
from lbaudiodetective_torch.ops.extract import required_padded_length  # noqa: E402
from lbaudiodetective_torch.ops.kernels import _build, band_rows  # noqa: E402
from tests._torch_common import bit_agreement, synth_clip  # noqa: E402

#: Each step of the kernel and its bit of LBAD_BAND_ROWS_SKIP.
STEPS = {"stage 1": 1, "stage-2 mma": 2, "band projection": 4, "fragment copies": 8}
VARIANTS = {"full kernel": 0, **{f"without {name}": bit for name, bit in STEPS.items()},
            "without all four": sum(STEPS.values()),
            "stage 2 straight into the running sums": 16}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs one GPU")
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    cfg = FingerprintConfig(integer_hop=False)
    n = 7168
    batch = torch.from_numpy(cs.brown_noise(np.random.default_rng(0), 256,
                                            required_padded_length(cfg, n))).to(dev)
    exp = band_rows.band_rows_plain(batch[:16].double(), cfg, n)
    l300 = FingerprintConfig(subfingerprint_length=300)
    clips = [synth_clip(74 + i, 4.0, l300) for i in range(2)]
    oracle = [oracle_fingerprint(c, l300) for c in clips]
    for name, skip in VARIANTS.items():
        flags = (f"-DLBAD_BAND_ROWS_SKIP={skip}",) if skip else ()
        _build.load_library(flags)
        report = _build.ptxas_report(flags).split("== band_rows.cu", 1)[-1].split("==", 1)[0]
        info = [ln.strip() for ln in report.splitlines() if "spill" in ln or "Used" in ln]
        ms = cs.cuda_ms(lambda: band_rows.band_rows(batch, cfg, n), iters=5)
        line = f"[{name}] [256, 7168 rows] {ms:.3f} ms (ptxas: {' | '.join(info)})"
        if skip in (0, 16):
            got = band_rows.band_rows(batch, cfg, n)[:16].double()
            fps = AudioDetective(l300, device=dev).process_decoded_batch(clips)
            agree = [bit_agreement(f.pos, f.neg, *o) for f, o in zip(fps, oracle)]
            line += (f"; largest error {cs.bar_share(got, exp):.3f} of the bar against the "
                     f"float64 plain version; subfingerprint_length=300 clips vs the oracle "
                     f"{[round(a, 5) for a in agree]}")
        print(line, flush=True)
    _build.load_library(())


if __name__ == "__main__":
    main()
