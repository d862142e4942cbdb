"""Bit agreement with the NumPy oracle of the configs the band-rows kernel
serves: for each, two 4 s clips (the card test's, seeds 74 and 75) and six
10 s clips of brown noise, fingerprinted by the CPU path (the plain versions
in float32) and, on a card, by the CUDA path (the kernels), each against
``oracle.pipeline.oracle_fingerprint`` on the same clip.  Run from the repo
root:

    python scripts/torch_oracle_agreement.py [cuda|cpu]

With ``cuda`` the card's name and power limit are printed first."""
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.models.detective import AudioDetective  # noqa: E402
from lbaudiodetective_torch.oracle.pipeline import oracle_fingerprint  # noqa: E402
from tests._torch_common import bit_agreement, synth_clip  # noqa: E402

CONFIGS = {"fractional": dict(integer_hop=False),
           "rate_8000": dict(processing_sample_rate=8000.0, integer_hop=False),
           "pitch_16": dict(pitch_step_count=16), "length_300": dict(subfingerprint_length=300),
           "rows_256": dict(rows_per_frame=256)}


def main() -> None:
    devices = ["cpu"] + (["cuda"] if (sys.argv[1:] or ["cuda"])[0] == "cuda" else [])
    if "cuda" in devices:
        if not torch.cuda.is_available():
            raise SystemExit("needs one GPU (or pass cpu)")
        torch.backends.cudnn.allow_tf32 = False
        print(cs.nvidia_smi_line(), flush=True)
    for name, kw in CONFIGS.items():
        cfg = FingerprintConfig(**kw)
        clips = [synth_clip(74 + i, 4.0, cfg) for i in range(2)]
        clips += cs.synth_clips(np.random.default_rng(3), cfg, 6, 10.0)
        oracle = [oracle_fingerprint(c, cfg) for c in clips]
        for dev in devices:
            fps = AudioDetective(cfg, device=dev).process_decoded_batch(clips)
            agree = [bit_agreement(f.pos, f.neg, *o) for f, o in zip(fps, oracle)]
            print(f"{name} {dev} vs oracle: min {min(agree):.5f}, per clip "
                  f"{[round(a, 5) for a in agree]}", flush=True)


if __name__ == "__main__":
    main()
