"""Top-128 sign-class selection: ``[N, 4096] f32 -> [N, 128] int32``.

Port of ``lbaudiodetective_tpu/ops/pallas/select_signs.py``.  Lane j of a
frame's output is the class (1 pos, 2 neg, 0 zero or NaN) of its j-th
element in (|x| descending, flat index ascending) order.  On a CUDA tensor
the hand-written kernel ``csrc/select_signs.cu`` runs; on a CPU tensor the
plain version below.
"""

from __future__ import annotations

import torch

FRAME = 4096
TOP = 128


def select_sign_classes_plain(coeffs: torch.Tensor, k: int = TOP) -> torch.Tensor:
    """Plain version, for any frame width: a stable sort on
    ``~(bits & 0x7FFFFFFF)`` (|x| descending, ties in index order) carrying
    the sign class as payload, as the reference's
    ``subfingerprints_from_rows`` sort path does.  Returns the first ``k``."""
    bits = coeffs.contiguous().view(torch.int32).to(torch.int64)
    keys = -(bits & 0x7FFFFFFF)              # ascending == abs bits descending
    cls = (coeffs > 0).to(torch.int32) + 2 * (coeffs < 0).to(torch.int32)
    order = torch.sort(keys, dim=-1, stable=True).indices[..., :k]
    return torch.gather(cls, -1, order)


def select_sign_classes(coeffs: torch.Tensor) -> torch.Tensor:
    """``[N, 4096] f32 -> [N, 128] int32`` rank-ordered sign classes.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``select_sign_classes.launches`` counts the launches)."""
    if coeffs.dim() != 2 or coeffs.shape[1] != FRAME:
        raise ValueError(f"select_sign_classes takes [N, {FRAME}] frames, "
                         f"got {tuple(coeffs.shape)}")
    if coeffs.dtype != torch.float32:
        raise TypeError("select_sign_classes takes float32 frames")
    if coeffs.device.type == "cpu":
        return select_sign_classes_plain(coeffs)
    if coeffs.device.type != "cuda":
        raise NotImplementedError(f"no select kernel for device {coeffs.device}")
    from lbaudiodetective_torch.ops.kernels._build import check, load_library

    lib = load_library()
    x = coeffs.contiguous()
    out = torch.empty((x.shape[0], TOP), dtype=torch.int32, device=x.device)
    if x.shape[0] == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        check(lib.lbad_select_sign_classes(x.data_ptr(), x.shape[0],
                                           out.data_ptr(), stream),
              "select_sign_classes")
    select_sign_classes.launches += 1
    return out


select_sign_classes.launches = 0
