"""2-D Haar wavelet transform as two matrix products (port of
the JAX package's ``ops/haar.py``).

    coeffs = H_rows @ frame @ H_cols^T

with the dense matrices of the reference's 1-D decomposition
(``ops.constants.haar_matrix``), so the linear map is the oracle's up to
float reassociation.
"""

from __future__ import annotations

import torch

from lbaudiodetective_torch.ops.constants import haar_matrix


def haar_2d(frames: torch.Tensor, h_rows: torch.Tensor | None = None,
            h_cols: torch.Tensor | None = None) -> torch.Tensor:
    """Batched 2-D Haar: ``[..., rows, cols] -> [..., rows, cols]``.

    ``h_rows``/``h_cols`` are the ``[rows, rows]``/``[cols, cols]`` Haar
    matrices on ``frames``' device; built from ``haar_matrix`` when omitted.
    Products in ``frames``' float type: the caller keeps TF32 off on CUDA
    (it is off for ``torch.matmul`` by default)."""
    rows, cols = frames.shape[-2], frames.shape[-1]
    if h_rows is None:
        h_rows = torch.from_numpy(haar_matrix(rows)).to(frames.device)
    if h_cols is None:
        h_cols = torch.from_numpy(haar_matrix(cols)).to(frames.device)
    h_rows, h_cols = h_rows.to(frames.dtype), h_cols.to(frames.dtype)
    row_pass = torch.matmul(frames, h_cols.T)            # along the cols axis
    return torch.matmul(h_rows, row_pass)                # along the rows axis
