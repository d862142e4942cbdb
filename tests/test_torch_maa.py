"""The port's MAA (``models/maa.py``) vs the JAX package's on the CPU.

Peaks (the per-category argmax of the window DFT's magnitude) are equal on
the reference's tone test and on seeded noise: 8,600 of 8,600 peaks
(5 seeds x 344 windows x 5 categories), though the two DFTs sum in another
float32 order.  Match counts are equal; low rates are refused as in
tests/test_maa.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lbaudiodetective_tpu.io.wav import write_wav  # noqa: E402
from lbaudiodetective_tpu.models import maa as jax_maa  # noqa: E402
from lbaudiodetective_torch.models.maa import (  # noqa: E402
    CATEGORY_HZ, N_CATEGORIES, WINDOW, maa_compare_audio_files, maa_fingerprint_file,
    maa_match_count, maa_subfingerprints)

SR = 44100.0


def _peaks(x, sr=SR):
    return maa_subfingerprints(x, sr, device="cpu").numpy()


def test_category_peaks_on_synthetic_tones():
    t = np.arange(int(SR)) / SR
    sig = (np.sin(2 * np.pi * 1000 * t) + 0.5 * np.sin(2 * np.pi * 6000 * t)).astype(np.float32)
    f = _peaks(sig)
    assert f.shape == (int(SR) // WINDOW, N_CATEGORIES)
    np.testing.assert_array_equal(f, np.asarray(jax_maa.maa_subfingerprints(jnp.asarray(sig), SR)))
    bin_hz = SR / WINDOW
    assert abs(f[0, 0] - 1000) <= bin_hz and abs(f[0, 1] - 6000) <= bin_hz
    assert np.all(f >= 0) and np.all(f < N_CATEGORIES * CATEGORY_HZ)


def test_peaks_equal_jax_on_seeded_noise():
    equal = total = 0
    for seed in range(5):
        x = np.random.default_rng(seed).standard_normal(int(SR * 4)).astype(np.float32)
        got = _peaks(x)
        want = np.asarray(jax_maa.maa_subfingerprints(jnp.asarray(x), SR))
        equal += int((got == want).sum())
        total += got.size
    assert (equal, total) == (8600, 8600)


def test_batched_samples_peak_per_row():
    x = np.random.default_rng(8).standard_normal((3, 4 * WINDOW + 17)).astype(np.float32)
    f = _peaks(x)
    assert f.shape == (3, 4, N_CATEGORIES)
    for i in range(3):
        np.testing.assert_array_equal(f[i], _peaks(x[i]))


def test_match_count_semantics_equal_jax():
    sig = np.random.default_rng(3).standard_normal(int(SR * 2)).astype(np.float32)
    f = _peaks(sig)
    g = f.copy()
    g[:, 0] += 399.0
    h = g.copy()
    h[:, 0] += 2.0
    cases = [(f, f, f.shape[0]), (f, f[10:30], 20), (f[10:30], f, 20),
             (f, f + 500.0, 0), (f, g, f.shape[0]), (f, h, 0)]
    for a, b, want in cases:
        assert maa_match_count(a, b, device="cpu") == want
        assert jax_maa.maa_match_count(a, b) == want


def test_match_count_equals_jax_on_noise_pairs():
    rng = np.random.default_rng(12)
    for _ in range(4):
        n1, n2 = (int(k) for k in rng.integers(20, 200, 2))
        a = rng.integers(1, 50, (n1, N_CATEGORIES)).astype(np.float32) * 86.1328125
        b = rng.integers(1, 50, (n2, N_CATEGORIES)).astype(np.float32) * 86.1328125
        b[: min(n1, n2) // 2] = a[: min(n1, n2) // 2] + 50.0
        for threshold in (400.0, 1500.0):
            assert maa_match_count(a, b, threshold, device="cpu") == \
                jax_maa.maa_match_count(a, b, threshold)


def test_low_rate_refused():
    with pytest.raises(ValueError, match="category"):
        maa_subfingerprints(np.zeros(8000, np.float32), 8000.0, device="cpu")
    with pytest.raises(ValueError, match="window"):
        maa_subfingerprints(np.zeros(100, np.float32), SR, device="cpu")


def test_compare_audio_files_equals_jax(tmp_path):
    """Two written 44.1 kHz WAVs, one a window-aligned crop of the other."""
    x = np.cumsum(np.random.default_rng(4).standard_normal(3 * 44100)) * 0.001
    x = (0.5 * x / np.abs(x).max()).astype(np.float32)
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    write_wav(a, x, 44100)
    write_wav(b, x[20 * WINDOW:200 * WINDOW], 44100)
    np.testing.assert_array_equal(maa_fingerprint_file(b, device="cpu"),
                                  np.asarray(jax_maa.maa_fingerprint_file(b)))
    got = maa_compare_audio_files(a, b, device="cpu")
    assert got == jax_maa.maa_compare_audio_files(a, b)
    assert got > 150            # an aligned crop: nearly every window matches
