"""The benchmark's yardstick: the rows kernel's work against a count by
hand, and the match kernel's scan work against a brute-force count."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from portbench import work
from portbench.reference.geometry import Geometry

DEFAULT = Geometry(5512.0, 2048, 64, 32, 128, 200, 318.0, "file", 44100.0, True)


def test_default_geometry():
    # 10 s at 44.1 kHz: (441000 - 2048) // 64 = 6858 rows, 53 whole frames.
    assert DEFAULT.hop == 8.0
    assert DEFAULT.n_sub(441000, 55120) == 53
    r = DEFAULT.band_ranges()
    assert (int(r[:, 0].min()), int(r[:, 1].max())) == (86, 759)
    # 673 bins from 86: 42 a residue mod 16, and one residue (86 % 16) 43.
    assert DEFAULT.k_max() == 43


def test_rows_work_by_hand_at_256_by_7168_rows():
    windows = 256 * 7168
    fma = (16 * 128 * 16 * 2          # stage 1: 16 taps, 128 values of b, 16 residues, re+im
           + 128 * 43 * 16 * 4        # stage 2: 43 bins a residue, complex (4 real FMA)
           + 16 * 43 * 32             # band projection
           + (32 * 32 + 128 * 32))    # the frame's two Haar products, a row's share
    assert fma == 444_928
    n_bytes, ops = work.rows_work(DEFAULT, 256, 7168)
    assert ops == 2 * fma * windows == 1_632_892_878_848
    assert n_bytes == 256 * (7167 * 8 + 2048) * 4 + 256 * 56 * 128 * 4
    # Operations bind: 1.633 TFLOP at 495 TFLOP/s.
    assert work.rows_bound_s(DEFAULT, 256, 7168) == pytest.approx(ops / 495e12)
    assert 3.29e-3 < work.rows_bound_s(DEFAULT, 256, 7168) < 3.31e-3


def brute_scan(q_counts, lib_counts, w, mask_pairs):
    wu = min(w, (mask_pairs + 31) // 32)
    popc = 0
    for nq, nl in itertools.product(q_counts, lib_counts):
        if nq == 0 or nl == 0:
            continue
        longer, shorter = max(nq, nl), min(nq, nl)
        for _offset in range(longer - shorter + 1):
            for _row in range(shorter):
                popc += wu
    n_bytes = (sum(lib_counts) * wu * 2 * 4 + len(lib_counts) * 4
               + sum(q_counts) * wu * 2 * 4 + len(q_counts) * len(lib_counts) * 4)
    return n_bytes, popc


@pytest.mark.parametrize("w,mask_pairs", [(4, 100), (4, 32), (2, 50)])
def test_scan_work_against_brute_force(w, mask_pairs):
    rng = np.random.default_rng(7)
    lib_counts = list(rng.integers(0, 12, size=40))
    q_counts = [0, 1, 5, 11, 14]
    got = work.scan_work(q_counts, work.count_histogram(lib_counts), w, mask_pairs)
    assert got == brute_scan(q_counts, lib_counts, w, mask_pairs)


def test_scan_bound_takes_the_slower_of_bytes_and_popc():
    assert work.scan_bound_s(3.35e12, 0, 132, 1980) == pytest.approx(1.0)
    assert work.scan_bound_s(0, 16 * 132 * 1980e6, 132, 1980) == pytest.approx(1.0)
