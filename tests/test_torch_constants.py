"""The port's NumPy constant builders are bit-equal to the JAX package's, and
the port gives identical output with either set of arrays."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.ops import constants as port  # noqa: E402
from tests._torch_common import jax_config, synth_clip  # noqa: E402

CONFIGS = {"parity": FingerprintConfig(), "proc": FingerprintConfig(hop_domain="proc")}


def _jax_builders(cfg):
    from lbaudiodetective_tpu.ops import dft, haar, spectral
    from lbaudiodetective_tpu.ops.pallas import fused_rows, fused_rows_v2

    cfg = jax_config(cfg)
    ranges = cfg.band_bin_ranges
    lo, hi = int(ranges[:, 0].min()), int(ranges[:, 1].max())
    return {
        "haar128": haar.haar_matrix(128), "haar32": haar.haar_matrix(32),
        "dft": dft._dft_constants(cfg.window_size, lo, hi),
        "proj": spectral.band_projection_matrix(cfg),
        "kernel": fused_rows._kernel_constants(cfg),
        "v2": fused_rows_v2._v2_constants(cfg, False),
        "v2_haar": fused_rows_v2._v2_constants(cfg, True),
        "conv": spectral._conv_constants(cfg),
        "interior": spectral.bands_in_interior(cfg),
    }


def _port_builders(cfg):
    ranges = cfg.band_bin_ranges
    lo, hi = int(ranges[:, 0].min()), int(ranges[:, 1].max())
    return {
        "haar128": port.haar_matrix(128), "haar32": port.haar_matrix(32),
        "dft": port.dft_constants(cfg.window_size, lo, hi),
        "proj": port.band_projection_matrix(cfg),
        "kernel": port.kernel_constants(cfg),
        "v2": port.v2_constants(cfg, False),
        "v2_haar": port.v2_constants(cfg, True),
        "conv": port.conv_constants(cfg),
        "interior": port.bands_in_interior(cfg),
    }


def _assert_bit_equal(a, b, name):
    if isinstance(a, tuple):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bit_equal(x, y, f"{name}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    else:
        assert a == b, name


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_builders_bit_equal_to_jax(cfg_name):
    cfg = CONFIGS[cfg_name]
    jax_arrays, port_arrays = _jax_builders(cfg), _port_builders(cfg)
    for name in jax_arrays:
        _assert_bit_equal(jax_arrays[name], port_arrays[name], name)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_jax_built_constants_give_identical_output(cfg_name):
    """The extractor's buffers may come from the JAX package's builders
    through constants_to_tensors: same fingerprints, bit for bit."""
    from lbaudiodetective_tpu.ops import haar, spectral
    from lbaudiodetective_tpu.ops.pallas import fused_rows_v2
    from lbaudiodetective_torch.ops.extract import FingerprintExtractor
    from lbaudiodetective_torch.ops.kernels.fused_rows import rows_arrays

    cfg = CONFIGS[cfg_name]
    c16, s16, t2a, _, proj_r, _, perm, h_cols_t = fused_rows_v2._v2_constants(
        jax_config(cfg), True)
    w1, w2, proj_perm, _ = spectral._conv_constants(jax_config(cfg))
    # The kernel reads t2a's twiddles split into TF32 and in fragment order,
    # which the port derives from the JAX package's t2a.
    k_max = port.kernel_constants(cfg)[5]
    t2_frag = port.stage2_fragments(t2a[..., :k_max], t2a[..., 64:64 + k_max])
    jax_arrays = {"c16": c16, "s16": s16, "t2_frag": t2_frag, "proj_r": proj_r,
                  "perm": perm, "h_cols_t": h_cols_t, "conv_w1": w1, "conv_w2": w2,
                  "proj_perm": proj_perm, "h_rows": haar.haar_matrix(128),
                  "h_cols": haar.haar_matrix(32)}
    assert sorted(jax_arrays) == sorted(rows_arrays(cfg))
    _assert_bit_equal(t2_frag, rows_arrays(cfg)["t2_frag"], "t2_frag")
    tensors = port.constants_to_tensors(jax_arrays, "cpu")
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in tensors.values())

    own = FingerprintExtractor(cfg, "cpu")
    from_jax = FingerprintExtractor(cfg, "cpu", arrays=jax_arrays)
    assert own.route == from_jax.route == "conv"
    n_sub = 8
    n_rows = n_sub * cfg.rows_per_frame
    from lbaudiodetective_torch.ops.extract import required_padded_length

    clip = synth_clip(11, 30.0, cfg).samples
    audio = np.zeros((2, required_padded_length(cfg, n_rows)), np.float32)
    t = min(len(clip), audio.shape[1])
    audio[0, :t] = clip[:t]
    audio[1, :t] = -clip[:t]
    x = torch.from_numpy(audio)
    n_valid = torch.tensor([n_sub, n_sub - 1])
    for a, b in zip(own(x, n_valid, n_rows), from_jax(x, n_valid, n_rows)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_tf32_split_of_the_twiddles(cfg_name):
    """The host-side split of the stage-2 twiddles: hi and lo each have at
    most 10 explicit mantissa bits (the low 13 bits are zero), and hi + lo
    gives each twiddle within 2^-22 relative; zeros stay zero."""
    _, _, t_re, t_im, _, _ = port.kernel_constants(CONFIGS[cfg_name])
    rng = np.random.default_rng(12)
    for x in (t_re, t_im, rng.standard_normal(4096).astype(np.float32) * 1e3):
        hi, lo = port.tf32_split(x)
        assert hi.dtype == lo.dtype == np.float32 and hi.shape == x.shape
        assert not (hi.view(np.uint32) & 0x1FFF).any()
        assert not (lo.view(np.uint32) & 0x1FFF).any()
        exact = x.astype(np.float64)
        err = np.abs(hi.astype(np.float64) + lo.astype(np.float64) - exact)
        assert (err <= 2.0 ** -22 * np.abs(exact)).all()
        assert (hi[x == 0] == 0).all() and (lo[x == 0] == 0).all()


def _mma_tile(a_lanes, b_lanes):
    """``mma.m16n8k8`` TF32 on fragments as PTX lays them out: lane (g, t) =
    (lane >> 2, lane & 3) holds A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
    and B (t, g), (t + 4, g); returns its C (g, 2t), (g, 2t + 1),
    (g + 8, 2t), (g + 8, 2t + 1), in float64."""
    a, b = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = a_lanes[lane]
        b[t, g], b[t + 4, g] = b_lanes[lane]
    d = a @ b
    return np.array([[d[lane >> 2, 2 * (lane & 3)], d[lane >> 2, 2 * (lane & 3) + 1],
                      d[(lane >> 2) + 8, 2 * (lane & 3)], d[(lane >> 2) + 8, 2 * (lane & 3) + 1]]
                     for lane in range(32)])


def test_stage2_fragments_give_the_complex_product():
    """csrc/dft_stage2.cuh's indexing, emulated lane by lane on one warp's
    16 windows and one chunk of 32 b at residue 5: A fragments from G with
    the hi/lo split, B fragments as stage2_fragments lays them out, four real
    products per slot tile (-T_im by sign flip), each product added straight
    into the slot tile's running sum in the kernel's order (per k-step the
    small terms, then the hi*hi terms).  The result is the complex product
    G T within 1e-6 of its largest value (the dropped lo*lo terms and TF32
    rounding of G)."""
    cfg = CONFIGS["parity"]
    _, _, t2a, _, _, k_max, _, _ = port.v2_constants(cfg, True)
    frag = port.stage2_fragments(t2a[..., :k_max], t2a[..., 64:64 + k_max])
    r, chunk, warp = 5, 2, 3
    rng = np.random.default_rng(13)
    g = (rng.standard_normal((128, 32)) + 1j * rng.standard_normal((128, 32))) * 10
    t = (t2a[r, 32 * chunk:32 * chunk + 32, :k_max]
         + 1j * t2a[r, 32 * chunk:32 * chunk + 32, 64:64 + k_max]).astype(np.complex128)
    exp = g[16 * warp:16 * warp + 16] @ t
    g32 = {"re": g.real.astype(np.float32), "im": g.imag.astype(np.float32)}
    acc = {"re": np.zeros((6, 32, 4)), "im": np.zeros((6, 32, 4))}
    lanes = np.arange(32)
    row0, tig = 16 * warp + (lanes >> 2), lanes & 3
    for ks in range(4):
        a = {}
        for part in ("re", "im"):
            col = 8 * ks + tig
            v = np.stack([g32[part][row0, col], g32[part][row0 + 8, col],
                          g32[part][row0, col + 4], g32[part][row0 + 8, col + 4]], axis=1)
            a[part] = port.tf32_split(v)
        for tile in range(6):
            b = {part: frag[r, 0, chunk, ks, tile, i] for i, part in enumerate(("re", "im"))}
            terms = (("re", "re", "re", 1), ("re", "im", "im", -1),
                     ("im", "re", "im", 1), ("im", "im", "re", 1))
            for big in (False, True):
                for out, a_part, b_part, sign in terms:
                    hi_b, lo_b = sign * b[b_part][:, :2], sign * b[b_part][:, 2:]
                    a_hi, a_lo = a[a_part]
                    pairs = ((a_hi, hi_b),) if big else ((a_lo, hi_b), (a_hi, lo_b))
                    for a_lanes, b_lanes in pairs:
                        acc[out][tile] += _mma_tile(a_lanes, b_lanes)
    got = np.zeros((16, 48), np.complex128)
    for tile in range(6):
        for i in range(4):
            rows = (lanes >> 2) + 8 * (i >> 1)
            slots = 8 * tile + 2 * tig + (i & 1)
            got[rows, slots] = acc["re"][tile][:, i] + 1j * acc["im"][tile][:, i]
    assert not got[:, k_max:].any()
    err = np.abs(got[:, :k_max] - exp).max()
    assert err <= 1e-6 * np.abs(exp).max(), err


def test_stage2_fragments_in_passes_of_48_slots():
    """Above 48 slots a residue, stage 2 runs passes of 48: pass p holds
    slots 48 p .. 48 p + 47 in the one-pass layout, zero past k_max; the
    projection is padded the same way."""
    rng = np.random.default_rng(14)
    k_max, bands = 100, 16
    t_re, t_im = (rng.standard_normal((16, 128, k_max)).astype(np.float32) for _ in "ri")
    frag = port.stage2_fragments(t_re, t_im)
    assert frag.shape == (16, 3, 4, 4, 6, 2, 32, 4) and port.stage2_passes(k_max) == 3
    pad = np.zeros((16, 128, 144), np.float32)
    for p in range(3):
        re, im = pad.copy(), pad.copy()
        re[..., :k_max], im[..., :k_max] = t_re, t_im
        one = port.stage2_fragments(re[..., 48 * p:48 * p + 48], im[..., 48 * p:48 * p + 48])
        assert np.array_equal(frag[:, p], one[:, 0])
    assert not frag[:, 2, :, :, 1:].any()           # slot tiles past slot 100 of the last pass
    proj = rng.standard_normal((16 * k_max, bands)).astype(np.float32)
    passes = port.projection_passes(proj, k_max)
    assert passes.shape == (16, 3, 48, bands)
    flat = passes.reshape(16, 144, bands)
    assert np.array_equal(flat[:, :k_max].reshape(-1, bands), proj) and not flat[:, k_max:].any()


def test_residue0_twiddles_cancel_a_constant():
    """csrc/fused_rows.cu subtracts one constant a window from residue 0's
    stage-1 values: exact because residue 0's twiddles sum to zero over b
    (k = 16 m, 0 < m < 128), to float32 rounding."""
    for cfg in CONFIGS.values():
        _, _, t_re, t_im, _, k_max = port.kernel_constants(cfg)
        for t in (t_re[0, :, :k_max], t_im[0, :, :k_max]):
            assert np.abs(t.astype(np.float64).sum(axis=0)).max() <= 1e-5
        assert np.abs(t_re[1].astype(np.float64).sum(axis=0)).max() > 1e-3
