"""Golden oracle: pure-NumPy, quirk-faithful fingerprint pipeline.

This module is the behavioural specification of the framework.  It re-derives
the reference pipeline stage by stage (citations per function), keeping the
reference's numerical quirks:

- Q1  stored subfingerprint = sign pairs of the top L/2 ranked wavelets
- Q2  rank-only encoding, stable tie-break by flat index (our determinism rule)
- Q5  asymmetric spectrum normalisation (positive components only / 512) and
      vDSP fft_zrip's 2x output scale with packed DC/Nyquist slots
- Q6  double-converted integer band edges (precomputed in FingerprintConfig)
- Q8  hop-domain parameterisation ('file' vs 'proc'), row count from the
      file-rate length
- Q9  only complete 128-row frames are fingerprinted
- Q10/Q11 possible-hit similarity + offset-sliding max matcher

The extraction (the JAX package's and this port's) must agree with this oracle (fingerprint bits near-
exactly, match scores to <1%); the corpus identification tests check the
oracle itself against the essay's published Figure 24-28 results.
"""

from __future__ import annotations

import numpy as np

from lbaudiodetective_torch.config import FingerprintConfig
from lbaudiodetective_torch.io.decode import DecodedAudio, decode_audio_file

_SQRT2 = np.float32(np.sqrt(np.float32(2.0)))


# --------------------------------------------------------------------------- #
# Spectral stage
# --------------------------------------------------------------------------- #

def vdsp_packed_spectrum(window: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Real FFT with vDSP packed-format semantics (LBAudioDetective.m:353-357).

    vDSP's ``ctoz``/``fft_zrip``/``ztoc`` on a real 2048-sample window yields
    interleaved ``samples[2k], samples[2k+1]`` = (2*Re X_k, 2*Im X_k) for
    k >= 1, with the packed slots samples[0] = 2*X_0 (DC) and samples[1] =
    2*X_{n/2} (Nyquist).  The reference zeroes ``A.imagp[0]`` *after* ztoc
    (m:357), which does not affect the samples buffer -- so the Nyquist value
    stays in slot 1.  Returns (re, im) arrays of length n/2.
    """
    n = window.shape[-1]
    spec = np.fft.rfft(window.astype(np.float64))
    re = np.empty(n // 2, dtype=np.float32)
    im = np.empty(n // 2, dtype=np.float32)
    re[0] = np.float32(2.0 * spec[0].real)
    im[0] = np.float32(2.0 * spec[n // 2].real)
    re[1:] = (2.0 * spec[1:n // 2].real).astype(np.float32)
    im[1:] = (2.0 * spec[1:n // 2].imag).astype(np.float32)
    return re, im


def compute_band_energies(window: np.ndarray, config: FingerprintConfig) -> np.ndarray:
    """One window -> ``pitch_step_count`` band energies
    (LBAudioDetectiveComputeFrequencies, LBAudioDetective.m:335-408).

    Quirk Q5: components are divided by (window/2)/2 = 512 only when positive;
    energies are summed over the Q6 bin ranges and divided by the first-stage
    band width.
    """
    re, im = vdsp_packed_spectrum(window)
    div = np.float32(config.spectrum_scale_divisor)
    re = np.where(re > 0.0, re / div, re)
    im = np.where(im > 0.0, im / div, im)
    v = re * re + im * im
    v = np.where(np.isfinite(v), v, np.float32(0.0))
    out = np.zeros(config.pitch_step_count, dtype=np.float32)
    ranges = config.band_bin_ranges
    widths = config.band_widths
    for i in range(config.pitch_step_count):
        lo, hi = int(ranges[i, 0]), int(ranges[i, 1])
        out[i] = v[lo:hi].sum(dtype=np.float32) / widths[i]
    return out


def _first_stage_band_indices(config: FingerprintConfig) -> np.ndarray:
    """The reference's Hz-like first-stage band edges ``indices[j]``
    (LBAudioDetective.m:367-371) — n-independent (built from windowSize)."""
    import math

    bins = config.pitch_step_count
    sr = config.processing_sample_rate
    log_base = math.exp(math.log((sr / 2.0) / config.min_frequency) / bins)
    mincoef = float(config.window_size) / sr * config.min_frequency
    return np.array([int((log_base ** j - 1.0) * mincoef) + int(mincoef)
                     for j in range(bins + 1)], dtype=np.int64)


def _band_energies_short_read(buf: np.ndarray, n_read: int,
                              config: FingerprintConfig) -> np.ndarray:
    """ComputeFrequencies with ``inNumberFrames = n_read < windowSize``
    (the reference's short-read call, LBAudioDetective.m:275,281,335-408):

    - the FFT still runs over the FULL window-sized buffer (FFT state is
      sized once), so the tail beyond ``n_read`` is stale data;
    - ``width = inNumberFrames/2`` rescales the Q5 divisor to
      ``(n_read/2)/2`` (integer divisions) — 0 near EOF, sending positive
      components to inf (dropped by the NaN/inf guard, m:399-402) while
      NEGATIVE components keep contributing;
    - the second band-edge conversion divides by ``sr/inNumberFrames``
      (m:382-383), shrinking every bin index by ``n_read/windowSize`` (the
      2013 ARM float->UInt32 conversion saturates negatives to 0).
    """
    re, im = vdsp_packed_spectrum(buf)
    width = n_read // 2
    div = np.float32(width // 2)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        re = np.where(re > 0.0, re / div, re)
        im = np.where(im > 0.0, im / div, im)
        v = re * re + im * im
    v = np.where(np.isfinite(v), v, np.float32(0.0))
    indices = _first_stage_band_indices(config)
    sr = config.processing_sample_rate
    out = np.zeros(config.pitch_step_count, dtype=np.float32)
    half = buf.shape[0] // 2
    for i in range(config.pitch_step_count):
        lo_b, hi_b = int(indices[i]), int(indices[i + 1])
        if n_read > 0:
            li = (2.0 * lo_b) / (sr / n_read) - 1.0
            hi = (2.0 * hi_b) / (sr / n_read) - 1.0
        else:
            li = hi = -1.0                       # 2L/inf - 1 on sr/0
        li = 0 if li < 0 else min(int(li), half)
        hi = 0 if hi < 0 else min(int(hi), half)
        wdt = np.float32(hi_b - lo_b)
        if hi > li and wdt > 0:
            out[i] = v[li:hi].sum(dtype=np.float32) / wdt
    return out


def _stale_tail_rows(audio: DecodedAudio, config: FingerprintConfig,
                     starts: np.ndarray, first_short: int) -> np.ndarray:
    """Rows from ``first_short`` on with the reference's short-read cascade
    (LBAudioDetective.m:252,275): ``readNumberFrames`` starts at windowSize,
    is written back by every ExtAudioFileRead, and is never reset — so after
    the first short read every subsequent read requests (at most) what the
    last one returned, and the sample buffer's tail keeps whatever the last
    longer read left there."""
    w = config.window_size
    x = audio.samples
    p_total = x.shape[0]
    buf = np.zeros(w, np.float32)
    if first_short > 0:                 # buffer state entering the tail:
        s_prev = int(starts[first_short - 1])
        seg = x[s_prev:min(s_prev + w, p_total)]
        buf[:seg.shape[0]] = seg        # the previous (full) read
    req = w
    out = np.zeros((len(starts) - first_short, config.pitch_step_count),
                   np.float32)
    for j, i in enumerate(range(first_short, len(starts))):
        s = int(starts[i])
        got = min(req, max(0, p_total - s))
        if got:
            buf[:got] = x[s:s + got]
        req = got
        if got >= w:                    # not actually short (defensive)
            out[j] = compute_band_energies(buf, config)
        else:
            out[j] = _band_energies_short_read(buf, got, config)
    return out


def spectrogram_rows(audio: DecodedAudio, config: FingerprintConfig,
                     stale_tail: bool = False) -> np.ndarray:
    """All spectrogram rows for a clip: ``[n_rows, pitch_step_count]`` float32.

    Row ``i`` is the band-energy vector of the 2048-sample window starting at
    processing sample ``floor(i * hop)`` (hop per config.hop_domain, quirk Q8).
    Windows running past EOF are zero-padded by default; with
    ``stale_tail=True`` they instead replicate the reference's short-read
    stale-buffer cascade (LBAudioDetective.m:252,275 — see
    CALIBRATION.md for the measured corpus impact).
    """
    n_rows = config.num_rows(audio.file_frames, audio.proc_frames)
    # Q9: rows beyond the last full frame are never used; skip computing them.
    n_rows -= n_rows % config.rows_per_frame
    if n_rows <= 0:
        return np.zeros((0, config.pitch_step_count), dtype=np.float32)
    starts = config.row_starts(n_rows)
    w = config.window_size
    x = audio.samples
    pad = int(max(0, starts[-1] + w - x.shape[0]))
    if pad:
        x = np.concatenate([x, np.zeros(pad, dtype=np.float32)])
    windows = x[starts[:, None] + np.arange(w)[None, :]]
    # Vectorised band energies over all rows at once.
    n = w
    spec = np.fft.rfft(windows.astype(np.float64), axis=-1)
    re = np.empty((n_rows, n // 2), dtype=np.float32)
    im = np.empty((n_rows, n // 2), dtype=np.float32)
    re[:, 0] = (2.0 * spec[:, 0].real).astype(np.float32)
    im[:, 0] = (2.0 * spec[:, n // 2].real).astype(np.float32)
    re[:, 1:] = (2.0 * spec[:, 1:n // 2].real).astype(np.float32)
    im[:, 1:] = (2.0 * spec[:, 1:n // 2].imag).astype(np.float32)
    div = np.float32(config.spectrum_scale_divisor)
    re = np.where(re > 0.0, re / div, re)
    im = np.where(im > 0.0, im / div, im)
    v = re * re + im * im
    v = np.where(np.isfinite(v), v, np.float32(0.0))
    rows = np.zeros((n_rows, config.pitch_step_count), dtype=np.float32)
    ranges = config.band_bin_ranges
    widths = config.band_widths
    for i in range(config.pitch_step_count):
        # Clamp to [0, n/2): the reference reads out of bounds for a -1 band
        # edge (Q6 int(x-1.0) truncation at very low min_frequency) -- UB,
        # spec-corrected identically in ops.spectral.band_projection_matrix.
        lo = min(max(int(ranges[i, 0]), 0), n // 2)
        hi = min(max(int(ranges[i, 1]), 0), n // 2)
        if hi > lo and widths[i] > 0:   # zero-width band -> energy 0 (0/0 UB)
            rows[:, i] = v[:, lo:hi].sum(axis=1, dtype=np.float32) / widths[i]
    if stale_tail:
        # First row whose window runs past EOF (short read in the reference).
        first_short = int(np.searchsorted(starts + w, audio.samples.shape[0],
                                          side="right"))
        if first_short < n_rows:
            rows[first_short:] = _stale_tail_rows(audio, config, starts,
                                                  first_short)
    return rows


# --------------------------------------------------------------------------- #
# Haar wavelet stage
# --------------------------------------------------------------------------- #

def haar_decompose_array(a: np.ndarray) -> np.ndarray:
    """1-D Haar decomposition (LBAudioDetectiveFrameDecomposeArray,
    LBAudioDetectiveFrame.m:134-153): pre-divide by sqrt(n), then repeated
    (a+b)/sqrt2, (a-b)/sqrt2 halving."""
    a = a.astype(np.float32).copy()
    n = a.shape[0]
    a /= np.float32(np.sqrt(np.float32(n)))
    while n > 1:
        n //= 2
        lo = (a[0:2 * n:2] + a[1:2 * n:2]) / _SQRT2
        hi = (a[0:2 * n:2] - a[1:2 * n:2]) / _SQRT2
        a[:n] = lo
        a[n:2 * n] = hi
    return a


def haar_decompose_frame(frame: np.ndarray) -> np.ndarray:
    """2-D separable Haar: each row, then each column
    (LBAudioDetectiveFrameDecompose, LBAudioDetectiveFrame.m:113-132)."""
    out = np.empty_like(frame, dtype=np.float32)
    for r in range(frame.shape[0]):
        out[r] = haar_decompose_array(frame[r])
    for c in range(frame.shape[1]):
        out[:, c] = haar_decompose_array(out[:, c])
    return out


# --------------------------------------------------------------------------- #
# Subfingerprint extraction
# --------------------------------------------------------------------------- #

def extract_subfingerprint(frame_coeffs: np.ndarray, config: FingerprintConfig,
                           tie_rng: np.random.Generator | None = None
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Ranked-sign extraction (LBAudioDetectiveFrameExtractFingerprint,
    LBAudioDetectiveFrame.m:165-191 + storage quirk Q1).

    Returns (pos, neg) uint8 arrays of length ``num_wavelet_pairs``: for rank
    j, pos[j]=1 if the j-th largest-|coeff| value is > 0, neg[j]=1 if < 0.
    Ties in |coeff| break by flat (row-major) index -- our determinism rule
    for quirk Q2.
    """
    flat = frame_coeffs.reshape(-1)
    k = config.num_wavelet_pairs
    if tie_rng is None:
        order = np.argsort(-np.abs(flat), kind="stable")[:k]
    else:
        # Q2 sensitivity hook: the reference's NSArray sort is UNSTABLE, so
        # |coeff| ties could come out in any order there.  A random secondary
        # key randomises the within-tie order (lexsort: last key is primary)
        # without moving any non-tied element, letting
        # scripts/tiebreak_sensitivity.py bound how much the tie order can
        # move corpus scores.
        sec = tie_rng.permutation(flat.size)
        order = np.lexsort((sec, -np.abs(flat)))[:k]
    top = flat[order]
    pos = (top > 0.0).astype(np.uint8)
    neg = (top < 0.0).astype(np.uint8)
    return pos, neg


def oracle_fingerprint(audio: DecodedAudio, config: FingerprintConfig | None = None,
                       stale_tail: bool = False
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Full extraction: clip -> (pos, neg) uint8 arrays ``[n_sub, pairs]``
    (LBAudioDetectiveProcessAudioURL + SynthesizeFingerprint,
    LBAudioDetective.m:208-331).  ``stale_tail`` opts into the reference's
    short-read stale-buffer EOF behaviour (Q8 tail; CALIBRATION.md)."""
    config = config or FingerprintConfig()
    coeffs = oracle_frame_coeffs(audio, config, stale_tail=stale_tail)
    return select_from_coeffs(coeffs, config)


def oracle_frame_coeffs(audio: DecodedAudio,
                        config: FingerprintConfig | None = None,
                        stale_tail: bool = False) -> np.ndarray:
    """``[n_sub, rows_per_frame, width]`` Haar coefficient frames — the
    pre-selection stage of :func:`oracle_fingerprint`, exposed so the Q2
    tie-sensitivity experiment can rerun ONLY the ranked-sign selection
    per random seed (the spectral + Haar stages dominate the runtime and
    are tie-independent)."""
    config = config or FingerprintConfig()
    rows = spectrogram_rows(audio, config, stale_tail=stale_tail)
    rpf = config.rows_per_frame
    n_sub = rows.shape[0] // rpf
    return np.stack([haar_decompose_frame(rows[s * rpf:(s + 1) * rpf])
                     for s in range(n_sub)]) if n_sub else \
        np.zeros((0, rpf, rows.shape[1]), rows.dtype)


def select_from_coeffs(coeffs: np.ndarray, config: FingerprintConfig,
                       tie_rng: np.random.Generator | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Ranked-sign selection over precomputed coefficient frames."""
    n_sub = coeffs.shape[0]
    pairs = config.num_wavelet_pairs
    pos = np.zeros((n_sub, pairs), dtype=np.uint8)
    neg = np.zeros((n_sub, pairs), dtype=np.uint8)
    for s in range(n_sub):
        pos[s], neg[s] = extract_subfingerprint(coeffs[s], config, tie_rng)
    return pos, neg


def oracle_fingerprint_from_file(path: str, config: FingerprintConfig | None = None
                                 ) -> tuple[np.ndarray, np.ndarray]:
    config = config or FingerprintConfig()
    audio = decode_audio_file(path, config.processing_sample_rate)
    return oracle_fingerprint(audio, config)


# --------------------------------------------------------------------------- #
# Matching
# --------------------------------------------------------------------------- #

def compare_subfingerprints(pos1, neg1, pos2, neg2, n_pairs: int) -> float:
    """Quirk Q10 similarity (LBAudioDetectiveFingerprintCompareSubfingerprints,
    LBAudioDetectiveFingerprint.m:151-176): a pair is 'possible' iff fp1's
    pair is non-zero; a hit iff both classes are equal; 0 when nothing is
    possible."""
    p1, n1 = pos1[:n_pairs], neg1[:n_pairs]
    p2, n2 = pos2[:n_pairs], neg2[:n_pairs]
    possible = (p1 | n1).astype(bool)
    hits = possible & (p1 == p2) & (n1 == n2)
    possible_hits = int(possible.sum())
    if possible_hits <= 0:
        return 0.0
    return float(np.float32(int(hits.sum())) / np.float32(possible_hits))


def oracle_match_fingerprints(fp1: tuple[np.ndarray, np.ndarray],
                              fp2: tuple[np.ndarray, np.ndarray],
                              comparison_range: int = 0,
                              subfingerprint_length: int = 200) -> float:
    """Offset-sliding matcher (LBAudioDetectiveFingerprintCompareToFingerprint,
    LBAudioDetectiveFingerprint.m:119-149): swap so fp1 is longer, slide fp2
    over every offset, score = max over offsets of mean pair similarity.

    ``comparison_range`` counts *booleans* (quirk Q11); 0 -> defaults to the
    subfingerprint length, i.e. all pairs.
    """
    if comparison_range == 0:
        comparison_range = subfingerprint_length
    n_bools = min(comparison_range, subfingerprint_length)
    n_pairs = (n_bools + 1) // 2

    (pos1, neg1), (pos2, neg2) = fp1, fp2
    if pos1.shape[0] < pos2.shape[0]:
        pos1, neg1, pos2, neg2 = pos2, neg2, pos1, neg1
    n1, n2 = pos1.shape[0], pos2.shape[0]
    if n2 == 0:
        return 0.0
    best = 0.0
    for offset in range(n1 - n2 + 1):
        total = np.float32(0.0)
        for i in range(n2):
            total += np.float32(compare_subfingerprints(
                pos1[i + offset], neg1[i + offset], pos2[i], neg2[i], n_pairs))
        best = max(best, float(total / np.float32(n2)))
    return best


def oracle_compare(path1: str, path2: str, comparison_range: int = 0,
                   config: FingerprintConfig | None = None) -> float:
    """End-to-end pair comparison (LBAudioDetectiveCompareAudioURLs,
    LBAudioDetective.m:442-464)."""
    config = config or FingerprintConfig()
    fp1 = oracle_fingerprint_from_file(path1, config)
    fp2 = oracle_fingerprint_from_file(path2, config)
    return oracle_match_fingerprints(fp1, fp2, comparison_range,
                                     config.subfingerprint_length)
