"""The port's own copies of the JAX package's host-only modules (``config``,
``errors``, ``io``, ``models.fingerprint``, ``models.frame``, ``utils``,
``oracle``) behave as the originals: configs built from the same keyword
arguments are equal field for field and in every derived quantity, files
written into ``tmp_path`` decode to equal samples, library files cross in
both directions, and frames and the NumPy oracle give equal arrays.  Values
cross the boundary as numpy arrays and field values.  Every comparison is
exact: the copies run the same NumPy (and C++) code."""

import dataclasses
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_torch import config as port_config  # noqa: E402
from lbaudiodetective_torch import errors as port_errors  # noqa: E402
from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.io import decode as port_decode  # noqa: E402
from lbaudiodetective_torch.models.fingerprint import Fingerprint, FingerprintBuilder  # noqa: E402
from lbaudiodetective_torch.ops import constants as port_constants  # noqa: E402
from lbaudiodetective_torch.utils import packing, serialize  # noqa: E402
from lbaudiodetective_tpu import config as jax_config_module  # noqa: E402
from lbaudiodetective_tpu import errors as jax_errors  # noqa: E402
from lbaudiodetective_tpu.io import decode as jax_decode  # noqa: E402
from lbaudiodetective_tpu.utils import packing as jax_packing  # noqa: E402
from lbaudiodetective_tpu.utils import serialize as jax_serialize  # noqa: E402
from tests._torch_common import brown_noise, jax_clip, jax_config, jax_fp, synth_clip  # noqa: E402

#: Every config the port's tests build.
CONFIGS = {
    "parity": {}, "proc": dict(hop_domain="proc"),
    "stride_128": dict(hop_domain="proc", analysis_stride=128),
    "hop_512": dict(hop_domain="proc", analysis_stride=512),
    "stride_32": dict(analysis_stride=32),
    "oracle_mode": dict(integer_hop=False),
    "rate_8000": dict(processing_sample_rate=8000.0, integer_hop=False),
    "pitch_16": dict(pitch_step_count=16),
    "pitch_16_fractional": dict(pitch_step_count=16, integer_hop=False),
    "rows_256": dict(rows_per_frame=256),
    "rows_256_fractional": dict(rows_per_frame=256, integer_hop=False),
    "length_300": dict(subfingerprint_length=300),
    "length_128": dict(subfingerprint_length=128),
    "window_1024": dict(window_size=1024, integer_hop=False),
    "low_band": dict(min_frequency=1.0),
}


def _assert_same(a, b, what):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_equals_jax_field_for_field(name):
    cfg = FingerprintConfig(**CONFIGS[name])
    jcfg = jax_config_module.FingerprintConfig(**CONFIGS[name])
    assert jax_config(cfg) == jcfg
    assert ([(f.name, f.default) for f in dataclasses.fields(cfg)]
            == [(f.name, f.default) for f in dataclasses.fields(jcfg)])
    for attr in ("num_wavelet_pairs", "coeffs_per_frame", "hop_in_processing_samples",
                 "has_integer_hop", "band_bin_ranges", "band_widths",
                 "spectrum_scale_divisor"):
        _assert_same(getattr(cfg, attr), getattr(jcfg, attr), attr)
    for n in (0, 1, 129, 7168):
        _assert_same(cfg.row_starts(n), jcfg.row_starts(n), f"row_starts({n})")
    for file_frames, proc_frames in ((44100, 5512), (441000, 55120), (1000, 100)):
        assert (cfg.num_rows(file_frames, proc_frames), cfg.num_subfingerprints(
            file_frames, proc_frames)) == (jcfg.num_rows(file_frames, proc_frames),
                                           jcfg.num_subfingerprints(file_frames, proc_frames))
    assert serialize.config_params_hash(cfg) == jax_serialize.config_params_hash(jcfg)
    assert cfg.with_updates(analysis_stride=16) == FingerprintConfig(
        **{**CONFIGS[name], "analysis_stride": 16})
    # The port's config keeps no JAX-only property.
    assert not hasattr(cfg, "precision")


def test_config_constants_and_validation_equal_jax():
    for n in dir(jax_config_module):
        if n.startswith("DEFAULT_") or n == "MIN_ANALYSIS_FREQUENCY":
            assert getattr(port_config, n) == getattr(jax_config_module, n), n
    for bad in (dict(window_size=2000), dict(subfingerprint_length=99),
                dict(hop_domain="x"), dict(matmul_precision="x")):
        with pytest.raises(ValueError):
            jax_config_module.FingerprintConfig(**bad)
        with pytest.raises(ValueError):
            FingerprintConfig(**bad)


def _jax_builders(cfg):
    from lbaudiodetective_tpu.ops import spectral
    from lbaudiodetective_tpu.ops.pallas import fused_rows, fused_rows_v2

    out = {"interior": lambda: spectral.bands_in_interior(cfg),
           "proj": lambda: spectral.band_projection_matrix(cfg),
           "kernel": lambda: fused_rows._kernel_constants(cfg),
           "conv": lambda: spectral._conv_constants(cfg)}
    if cfg.has_integer_hop and 128 % int(cfg.hop_in_processing_samples) == 0:
        out["v2_haar"] = lambda: fused_rows_v2._v2_constants(cfg, True)
    return out


def _port_builders(cfg):
    out = {"interior": lambda: port_constants.bands_in_interior(cfg),
           "proj": lambda: port_constants.band_projection_matrix(cfg),
           "kernel": lambda: port_constants.kernel_constants(cfg),
           "conv": lambda: port_constants.conv_constants(cfg)}
    if cfg.has_integer_hop and 128 % int(cfg.hop_in_processing_samples) == 0:
        out["v2_haar"] = lambda: port_constants.v2_constants(cfg, True)
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_constant_builders_equal_jax(name):
    """The port's builders on the port's config and the JAX package's on
    its own give bit-equal arrays, or both refuse the config."""
    cfg = FingerprintConfig(**CONFIGS[name])
    jax_fns, port_fns = _jax_builders(jax_config(cfg)), _port_builders(cfg)
    assert sorted(jax_fns) == sorted(port_fns)
    for key, jfn in jax_fns.items():
        try:
            exp = jfn()
        except ValueError:
            with pytest.raises(ValueError):
                port_fns[key]()
            continue
        _assert_same(exp, port_fns[key](), key)


def test_errors_equal_jax():
    names = [n for n, v in vars(jax_errors).items() if isinstance(v, type)]
    assert len(names) >= 3
    for n in names:
        ours, theirs = getattr(port_errors, n), getattr(jax_errors, n)
        assert [c.__name__ for c in ours.__mro__] == [c.__name__ for c in theirs.__mro__], n


def _caf_bytes(desc: tuple, data: bytes) -> bytes:
    return (b"caff\x00\x01\x00\x00"
            + b"desc" + struct.pack(">q", 32) + struct.pack(">dIIIIII", *desc)
            + b"data" + struct.pack(">q", len(data) + 4) + b"\x00" * 4 + data)


def _write(fmt: str, path: str, x: np.ndarray, rate: float, writers) -> None:
    """Write ``x`` as ``fmt`` with the writers of one package (CAF by hand:
    neither package has a CAF writer)."""
    if fmt == "wav":
        writers.wav.write_wav(path, x, rate)
    elif fmt == "aiff":
        writers.aiff.write_aiff(path, x, rate)
    elif fmt == "au":
        writers.au.write_au(path, x, rate)
    elif fmt == "caf_lpcm":
        pcm = np.round(np.clip(x, -1, 1 - 2 ** -15) * 32768).astype(">i2").tobytes()
        with open(path, "wb") as f:
            f.write(_caf_bytes((rate, int.from_bytes(b"lpcm", "big"), 0, 2, 1, 1, 16), pcm))
    else:                                          # caf_ima4: seeded packets
        rng = np.random.default_rng(int(abs(x[:8]).sum() * 1e6) % 1000)
        packets = rng.integers(0, 256, size=(len(x) // 64, 34), dtype=np.uint8)
        packets[:, 0] = 0
        packets[:, 1] &= 0x80 | 0x1F                 # predictor 0, step index < 32
        with open(path, "wb") as f:
            f.write(_caf_bytes((rate, int.from_bytes(b"ima4", "big"), 0, 34, 64, 1, 0),
                               packets.tobytes()))


class _Writers:
    def __init__(self, pkg):
        import importlib

        self.wav = importlib.import_module(f"{pkg}.io.wav")
        self.aiff = importlib.import_module(f"{pkg}.io.aiff")
        self.au = importlib.import_module(f"{pkg}.io.au")


@pytest.fixture(params=["native", "numpy"])
def decode_path(request, monkeypatch):
    """Both packages on the same decode path: their native decoders, or (with
    the native libraries switched off) their NumPy readers and resamplers."""
    from lbaudiodetective_torch.io.native import binding
    from lbaudiodetective_tpu.io.native import binding as jax_binding

    if request.param == "native":
        if not (binding.available() and jax_binding.available()):
            pytest.skip("no C++ toolchain: the native decoders are not built")
    else:
        for mod in (binding, jax_binding):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_tried", True)
    return request.param


@pytest.mark.parametrize("fmt", ["wav", "aiff", "au", "caf_lpcm", "caf_ima4"])
def test_decode_equals_jax(fmt, tmp_path, decode_path):
    """A file written by each package's writers has the same bytes, and
    decodes to the same samples in both packages on the same path (native
    decoder first, the NumPy readers as fallback, in both), raw and
    resampled."""
    x = brown_noise(90, 1, 44100)[0]
    x = (0.5 * x / np.abs(x).max()).astype(np.float32)
    ours, theirs = str(tmp_path / f"port.{fmt}"), str(tmp_path / f"jax.{fmt}")
    _write(fmt, ours, x, 44100.0, _Writers("lbaudiodetective_torch"))
    _write(fmt, theirs, x, 44100.0, _Writers("lbaudiodetective_tpu"))
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    raw, rate = port_decode.decode_audio_file_raw(ours)
    jraw, jrate = jax_decode.decode_audio_file_raw(ours)
    assert rate == jrate == 44100.0 and raw.dtype == jraw.dtype == np.float32
    np.testing.assert_array_equal(raw, jraw)
    d, jd = port_decode.decode_audio_file(ours), jax_decode.decode_audio_file(ours)
    assert (d.processing_rate, d.file_frames, d.file_rate) == (
        jd.processing_rate, jd.file_frames, jd.file_rate)
    assert d.proc_frames == jd.proc_frames > 0
    np.testing.assert_array_equal(d.samples, jd.samples)


def test_native_decoder_builds_in_the_port():
    """The port's copy of the native decoder builds into its own git-ignored
    ``build/`` and is the one the port loads."""
    from lbaudiodetective_torch.io.native import binding

    if not binding.available():
        pytest.skip("no C++ toolchain: the NumPy readers decode")
    assert binding._SO.parent.parent.name == "native"
    assert "lbaudiodetective_torch" in binding._SO.parts


def test_packing_equals_jax():
    rng = np.random.default_rng(91)
    for pairs in (1, 31, 32, 33, 64, 100, 150):
        plane = (rng.random((7, pairs)) < 0.5).astype(np.uint8)
        assert packing.words_per_plane(pairs) == jax_packing.words_per_plane(pairs)
        words = packing.pack_bits(plane)
        np.testing.assert_array_equal(words, jax_packing.pack_bits(plane))
        np.testing.assert_array_equal(packing.unpack_bits(words, pairs), plane)
        np.testing.assert_array_equal(jax_packing.unpack_bits(words, pairs), plane)


def _fps(seed, n=5):
    rng = np.random.default_rng(seed)
    out = []
    for m in rng.integers(3, 20, size=n):
        sign = rng.random((m, 100)) < 0.5
        nz = rng.random((m, 100)) > 0.05
        out.append(Fingerprint((sign & nz).astype(np.uint8), (~sign & nz).astype(np.uint8)))
    return out


def test_fingerprint_files_cross_both_ways(tmp_path):
    from lbaudiodetective_tpu.config import FingerprintConfig as JaxConfig

    fps, cfg, jcfg = _fps(92), FingerprintConfig(), JaxConfig()
    serialize.save_fingerprint(str(tmp_path / "p.npz"), fps[0], cfg)
    jax_serialize.save_fingerprint(str(tmp_path / "j.npz"), jax_fp(fps[0]), jcfg)
    for path in ("p.npz", "j.npz"):
        got = serialize.load_fingerprint(str(tmp_path / path), cfg)
        jgot = jax_serialize.load_fingerprint(str(tmp_path / path), jcfg)
        assert got == fps[0]
        np.testing.assert_array_equal(jgot.pos, fps[0].pos)
        np.testing.assert_array_equal(jgot.neg, fps[0].neg)
        with pytest.raises(ValueError, match="hash mismatch"):
            serialize.load_fingerprint(str(tmp_path / path), cfg.with_updates(analysis_stride=32))
    with np.load(tmp_path / "p.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_library_files_cross_both_ways(tmp_path):
    from lbaudiodetective_tpu.config import FingerprintConfig as JaxConfig

    fps, cfg, jcfg = _fps(93, 7), FingerprintConfig(), JaxConfig()
    serialize.save_library(str(tmp_path / "p.npz"), fps, cfg)
    jax_serialize.save_library(str(tmp_path / "j.npz"), [jax_fp(f) for f in fps], jcfg)
    with np.load(tmp_path / "p.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for path in ("p.npz", "j.npz"):
        got = serialize.load_library(str(tmp_path / path), cfg)
        jgot = jax_serialize.load_library(str(tmp_path / path), jcfg)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        jgot if isinstance(jgot, tuple) else (jgot,)):
            if isinstance(a, list):
                assert [(f.pos.tobytes(), f.neg.tobytes()) for f in a] == [
                    (f.pos.tobytes(), f.neg.tobytes()) for f in b]
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fingerprint_value_type_equals_jax():
    """String form, packed form, equality and the builder agree with the
    JAX package's value type on the same planes."""
    from lbaudiodetective_tpu.models.fingerprint import FingerprintBuilder as JaxBuilder

    fp = _fps(94, 1)[0]
    jfp = jax_fp(fp)
    assert fp.to_string() == jfp.to_string()
    for a, b in zip(fp.packed(), jfp.packed()):
        np.testing.assert_array_equal(a, b)
    assert Fingerprint.from_string(fp.to_string(), 200) == fp
    assert fp.copy() == fp and hash(fp.copy()) == hash(fp)
    rng = np.random.default_rng(95)
    b, jb = FingerprintBuilder(10), JaxBuilder(10)
    for _ in range(4):
        sub = rng.integers(0, 2, 12).astype(bool)
        b.add_subfingerprint(sub)
        jb.add_subfingerprint(sub)
    frozen, jfrozen = b.freeze(), jb.freeze()
    np.testing.assert_array_equal(frozen.pos, jfrozen.pos)
    np.testing.assert_array_equal(frozen.neg, jfrozen.neg)
    assert frozen.to_string() == jfrozen.to_string()


def test_frame_equals_jax():
    from lbaudiodetective_torch.models.frame import Frame
    from lbaudiodetective_tpu.models.frame import Frame as JaxFrame

    rng = np.random.default_rng(96)
    for rows, cols in ((128, 32), (4, 8), (3, 4), (6, 10)):
        m = rng.standard_normal((rows, cols)).astype(np.float32)
        f, jf = Frame(rows), JaxFrame(rows)
        for r in m:
            assert f.set_row(r) and jf.set_row(r)
        assert f.full() and jf.full() and f.fingerprint_length == jf.fingerprint_length
        f.decompose()
        jf.decompose()
        np.testing.assert_array_equal(f.as_matrix(), jf.as_matrix())
        for k in (1, 5, min(100, rows * cols)):
            np.testing.assert_array_equal(f.extract_fingerprint(k), jf.extract_fingerprint(k))


@pytest.mark.parametrize("name", ["parity", "oracle_mode", "pitch_16", "proc"])
def test_oracle_equals_jax(name):
    """The port's NumPy oracle and the JAX package's on the same clip and
    config: equal bits, equal band energies and Haar coefficients, and equal
    match scores."""
    from lbaudiodetective_torch.oracle import pipeline as port_oracle
    from lbaudiodetective_tpu.oracle import pipeline as jax_oracle

    cfg = FingerprintConfig(**CONFIGS[name])
    clip = synth_clip(97, 3.0, cfg)
    pos, neg = port_oracle.oracle_fingerprint(clip, cfg)
    jpos, jneg = jax_oracle.oracle_fingerprint(jax_clip(clip), jax_config(cfg))
    assert pos.shape[0] > 0
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(neg, jneg)
    window = clip.samples[:cfg.window_size]
    np.testing.assert_array_equal(port_oracle.compute_band_energies(window, cfg),
                                  jax_oracle.compute_band_energies(window, jax_config(cfg)))
    frame = np.random.default_rng(98).standard_normal((128, 32)).astype(np.float32)
    np.testing.assert_array_equal(port_oracle.haar_decompose_frame(frame),
                                  jax_oracle.haar_decompose_frame(frame))
    other = (pos[1:], neg[1:])
    for rng in (0, 37):
        assert (port_oracle.oracle_match_fingerprints((pos, neg), other, rng)
                == jax_oracle.oracle_match_fingerprints((jpos, jneg), other, rng))
