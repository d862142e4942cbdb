"""The essay's Melody Analyzing Algorithm (MAA), the AFA's rejected
predecessor (port of the JAX package's ``models/maa.py``).

The essay's §3.2.1.1 (Listing 1), §3.2.3.1 (Listing 3) and §4.1.1:

- the signal is split into non-overlapping windows of 512 sample frames
  at the file's native rate (no resampling);
- each window is DFT'd, and the spectrum is split into 5 categories of
  4,400 Hz; per category the frequency of the largest magnitude is kept,
  so a subfingerprint is 5 peak frequencies;
- two subfingerprints match when the sum of their 5 absolute frequency
  differences is below 400 Hz; a fingerprint pair's result is the number
  of matching subfingerprints, maximised over alignment offsets.

The window DFT is the port's two-stage ``ops.dft.rdft_bins``, the peak a
masked argmax (ties to the lowest bin) and the offset slide the AFA
matcher's banded-diagonal sum, all torch ops on ``device``.  The reference
has no TPU kernel here.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from lbaudiodetective_torch.device import DEFAULT_DEVICE, resolve_device
from lbaudiodetective_torch.ops.dft import rdft_bins
from lbaudiodetective_torch.ops.match import banded_diagonal_sums

WINDOW = 512             # essay: "windows of 512 KB in size" (sample frames)
N_CATEGORIES = 5         # essay: "20kHz ... is split into 5 ranges"
CATEGORY_HZ = 4400.0     # essay example: 3800 Hz -> range 0 Hz - 4400 Hz
MATCH_THRESHOLD = 400.0  # essay Listing 3: "if (d < 400) match = YES"


@lru_cache(maxsize=16)
def _category_constants(window: int, sample_rate: float, n_categories: int,
                        category_hz: float) -> tuple[np.ndarray, np.ndarray]:
    """Per-bin frequencies ``[n_bins]`` and ``[n_categories, n_bins]``
    masks over bins [1, window/2).  A rate that leaves a category empty is
    refused: its masked argmax would report bin 0 and inflate counts."""
    ks = np.arange(1, window // 2)
    freqs = ks * (sample_rate / window)
    cat = np.floor(freqs / category_hz).astype(np.int64)
    masks = np.stack([(cat == c) for c in range(n_categories)])
    if not masks.any(axis=1).all():
        raise ValueError(
            f"sample rate {sample_rate:g} Hz leaves a frequency category "
            f"empty ({n_categories} x {category_hz:g} Hz needs Nyquist >= "
            f"{(n_categories - 1) * category_hz:g} Hz); the MAA is specified "
            "for 44.1 kHz material")
    return freqs.astype(np.float32), masks


def maa_subfingerprints(samples, sample_rate: float, window: int = WINDOW,
                        n_categories: int = N_CATEGORIES,
                        category_hz: float = CATEGORY_HZ,
                        device: torch.device | str = DEFAULT_DEVICE) -> torch.Tensor:
    """``[..., T]`` float32 samples (array or tensor) ``-> [..., T // window,
    n_categories]`` peak Hz on ``device``.  The trailing partial window is
    dropped."""
    device = resolve_device(device, "maa_subfingerprints")
    samples = torch.as_tensor(samples, dtype=torch.float32, device=device)
    n_win = samples.shape[-1] // window
    if n_win < 1:
        raise ValueError(f"clip shorter than one {window}-frame window")
    freqs_np, masks_np = _category_constants(window, float(sample_rate),
                                             n_categories, category_hz)
    frames = samples[..., :n_win * window].reshape(*samples.shape[:-1], n_win, window)
    re, im = rdft_bins(frames, 1, window // 2)
    mag = re * re + im * im                                  # [..., n_win, n_bins]
    masks = torch.from_numpy(masks_np).to(device)
    scores = torch.where(masks, mag[..., None, :],
                         torch.full_like(mag[..., None, :], -torch.inf))
    peak_bin = torch.argmax(scores, dim=-1)                  # first maximum
    return torch.from_numpy(freqs_np).to(device)[peak_bin]


def _match_padded(f1: torch.Tensor, n1: int, f2: torch.Tensor, n2: int,
                  threshold: float) -> torch.Tensor:
    if n1 < n2:                                              # slide the longer
        f1, n1, f2, n2 = f2, n2, f1, n1
    diff = (f1[:, None, :] - f2[None, :, :]).abs()           # [S1, S2, cat]
    d = diff[..., 0]
    for c in range(1, diff.shape[-1]):                       # the reference's order
        d = d + diff[..., c]
    s1, s2 = d.shape
    dev = d.device
    valid = ((torch.arange(s1, device=dev)[:, None] < n1)
             & (torch.arange(s2, device=dev)[None, :] < n2))
    match = ((d < threshold) & valid).to(torch.float32)      # Listing 3
    counts = banded_diagonal_sums(match, torch.tensor(n2, device=dev))
    o_valid = torch.arange(s1, device=dev) <= (n1 - n2)
    counts = torch.where(o_valid, counts, torch.full_like(counts, -1.0))
    return torch.clamp(counts.amax(), min=0.0)


def maa_match_count(f1, f2, threshold: float = MATCH_THRESHOLD,
                    device: torch.device | str = DEFAULT_DEVICE) -> int:
    """Best number of matching subfingerprints over alignment offsets (a
    count, not a percentage: essay §4.1.1).  Shapes pad to a common
    128-window bucket."""
    device = resolve_device(device, "maa_match_count")
    f1, f2 = (np.asarray(f.cpu() if isinstance(f, torch.Tensor) else f, np.float32)
              for f in (f1, f2))
    if f1.ndim != 2 or f2.ndim != 2 or f1.shape[1] != f2.shape[1]:
        raise ValueError("expected [n_windows, n_categories] inputs")
    s = -(-max(f1.shape[0], f2.shape[0], 1) // 128) * 128

    def pad(a):
        return torch.from_numpy(np.pad(a, ((0, s - a.shape[0]), (0, 0)))).to(device)

    return int(_match_padded(pad(f1), f1.shape[0], pad(f2), f2.shape[0], threshold))


def maa_fingerprint_file(path: str, device: torch.device | str = DEFAULT_DEVICE
                         ) -> np.ndarray:
    """Decode (native rate, no resampling) and extract MAA subfingerprints."""
    from lbaudiodetective_torch.io.decode import decode_audio_file_raw

    device = resolve_device(device, "maa_fingerprint_file")
    samples, rate = decode_audio_file_raw(path)
    return maa_subfingerprints(samples, float(rate), device=device).cpu().numpy()


def maa_compare_audio_files(path1: str, path2: str,
                            threshold: float = MATCH_THRESHOLD,
                            device: torch.device | str = DEFAULT_DEVICE) -> int:
    """End-to-end MAA pair comparison (the essay's Test-1 harness unit)."""
    return maa_match_count(maa_fingerprint_file(path1, device),
                           maa_fingerprint_file(path2, device), threshold, device)
