"""Hand-written Hopper kernels of the extraction and library paths, each
beside its plain PyTorch version.  Nothing is compiled at import: the CUDA
library is built by ``_build.load_library`` on the first launch."""

from lbaudiodetective_torch.ops.kernels import band_rows
from lbaudiodetective_torch.ops.kernels.fused_rows import fused_band_rows
from lbaudiodetective_torch.ops.kernels.match_packed import match_one_vs_many_fused
from lbaudiodetective_torch.ops.kernels.select_signs import select_sign_classes

#: Every kernel wrapper by the name its launch count goes under; each
#: carries a ``launches`` count.
WRAPPERS = {
    "select_sign_classes": select_sign_classes,
    "fused_band_rows": fused_band_rows,
    "match_one_vs_many_fused": match_one_vs_many_fused,
    "band_rows": band_rows.band_rows,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
