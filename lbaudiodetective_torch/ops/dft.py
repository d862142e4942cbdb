"""Real DFT restricted to the consumed bins, as two matrix stages (port of
the JAX package's ``ops/dft.py``).

With n = a * B + b (A = 16, B = window / 16):

    G[b, r] = sum_a w[a*B + b] e^{-2 pi i a r / A}          (stage 1)
    X[k]    = sum_b e^{-2 pi i k b / N} G[b, k mod A]        (stage 2)

The vDSP 2x output scale is folded into the stage-2 twiddles.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from lbaudiodetective_torch.ops.constants import STAGE1, dft_constants


@lru_cache(maxsize=16)
def _dft_tensors(n: int, bin_lo: int, bin_hi: int, device: str) -> tuple[torch.Tensor, ...]:
    """``dft_constants`` on ``device``, copied there once (a copy per call
    would make the host wait for the device)."""
    return tuple(torch.from_numpy(a).to(device) for a in dft_constants(n, bin_lo, bin_hi))


def rdft_bins(windows: torch.Tensor, bin_lo: int, bin_hi: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``[..., window] -> (re, im)`` each ``[..., bin_hi - bin_lo]``: 2x the
    real DFT at bins [bin_lo, bin_hi), vDSP-scaled.

    Requires ``1 <= bin_lo`` and ``bin_hi <= window / 2``.  Runs in the
    windows' float type (float64 evaluates a plain version exactly)."""
    n = windows.shape[-1]
    if not (1 <= bin_lo and bin_hi <= n // 2):
        raise ValueError("rdft_bins requires bins inside (0, n/2)")
    c1, s1, t_re, t_im, perm = _dft_tensors(n, bin_lo, bin_hi, str(windows.device))
    c1, s1, t_re, t_im = (t.to(windows.dtype) for t in (c1, s1, t_re, t_im))
    y = windows.reshape(*windows.shape[:-1], STAGE1, n // STAGE1)   # [..., a, b]
    g_re = torch.einsum("...ab,ar->...br", y, c1)
    g_im = torch.einsum("...ab,ar->...br", y, s1)
    x_re = (torch.einsum("...br,rbk->...rk", g_re, t_re)
            - torch.einsum("...br,rbk->...rk", g_im, t_im))
    x_im = (torch.einsum("...br,rbk->...rk", g_re, t_im)
            + torch.einsum("...br,rbk->...rk", g_im, t_re))
    lead = x_re.shape[:-2]
    x_re = x_re.reshape(*lead, -1)[..., perm]
    x_im = x_im.reshape(*lead, -1)[..., perm]
    return x_re, x_im
