"""Hand-written Hopper kernels of the extraction, library and live-session
paths, each beside its plain PyTorch version.  Nothing is compiled at
import: the CUDA library is built by ``_build.load_library`` on the first
launch."""

from lbaudiodetective_torch.ops.kernels import band_rows
from lbaudiodetective_torch.ops.kernels.fused_rows import fused_band_rows
from lbaudiodetective_torch.ops.kernels.match_packed import match_one_vs_many_fused
from lbaudiodetective_torch.ops.kernels.select_signs import select_sign_classes
from lbaudiodetective_torch.ops.kernels.slot_fold import slot_fold

#: Every kernel wrapper by the name its launch count goes under; each
#: carries a ``launches`` count.
WRAPPERS = {
    "select_sign_classes": select_sign_classes,
    "fused_band_rows": fused_band_rows,
    "match_one_vs_many_fused": match_one_vs_many_fused,
    "band_rows": band_rows.band_rows,
    "slot_fold": slot_fold,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
