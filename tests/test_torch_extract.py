"""End-to-end extraction of the port vs the JAX package and the live NumPy
oracle on synthetic clips (the bar of tests/test_extract_parity.py: >= 99.9 %
of bits), plus batch == single, zeroed padding, silence, and the route
each config takes on each device."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.io.decode import DecodedAudio  # noqa: E402
from lbaudiodetective_torch.ops import extract  # noqa: E402
from lbaudiodetective_torch.ops.extract import (  # noqa: E402
    extract_fingerprint, extract_fingerprint_batch, extraction_route)
from lbaudiodetective_torch.ops.match import match_fingerprints  # noqa: E402
from tests._torch_common import bit_agreement, jax_clip, jax_config, synth_clip  # noqa: E402

CONFIGS = {
    "parity": FingerprintConfig(),
    "proc": FingerprintConfig(hop_domain="proc"),
    "fractional_hop": FingerprintConfig(integer_hop=False),
}


@pytest.mark.parametrize("cfg_name,seconds", [
    ("parity", 3.0), ("parity", 1.5), ("proc", 13.0), ("fractional_hop", 2.5)])
def test_extract_matches_jax_and_oracle(cfg_name, seconds):
    from lbaudiodetective_tpu.ops.extract import extract_fingerprint as jax_extract
    from lbaudiodetective_tpu.oracle.pipeline import oracle_fingerprint

    cfg = CONFIGS[cfg_name]
    clip = synth_clip(21, seconds, cfg)
    pos, neg, n = extract_fingerprint(clip, cfg, device="cpu")
    assert n > 0 and pos.shape == (n, 100) and pos.dtype == np.uint8
    assert not (pos & neg).any()
    jpos, jneg, jn = jax_extract(jax_clip(clip), jax_config(cfg))
    assert jn == n
    assert bit_agreement(pos, neg, jpos[:n], jneg[:n]) >= 0.999
    opos, oneg = oracle_fingerprint(jax_clip(clip), jax_config(cfg))
    assert opos.shape[0] == n
    assert bit_agreement(pos, neg, opos, oneg) >= 0.999


def test_batch_equals_single_and_padding_is_zero():
    cfg = CONFIGS["parity"]
    clips = [synth_clip(30 + i, s, cfg) for i, s in enumerate((2.0, 3.0, 1.2))]
    bpos, bneg, n_subs = extract_fingerprint_batch(clips, cfg, device="cpu")
    assert bpos.shape == (3, 16, 100)
    for i, c in enumerate(clips):
        pos, neg, n = extract_fingerprint(c, cfg, device="cpu")
        assert n == n_subs[i]
        np.testing.assert_array_equal(bpos[i, :n], pos)
        np.testing.assert_array_equal(bneg[i, :n], neg)
        assert bpos[i, n:].sum() == 0 and bneg[i, n:].sum() == 0
    # Static-shape serving form: padded batch and capped bucket.
    ppos, pneg, pn = extract_fingerprint_batch(clips, cfg, pad_batch_to=4, n_sub_cap=9,
                                           device="cpu")
    assert ppos.shape == (3, 16, 100)
    np.testing.assert_array_equal(pn, np.minimum(n_subs, 9))
    for i in range(3):
        np.testing.assert_array_equal(ppos[i, :pn[i]], bpos[i, :pn[i]])


@pytest.fixture(scope="module")
def many_clips():
    """256 clips of 1.0-2.0 s (buckets of 8 and 16 subfingerprints)."""
    cfg = CONFIGS["parity"]
    return [synth_clip(200 + i, 1.0 + 0.25 * (i % 5), cfg) for i in range(256)]


def _chunks_of(monkeypatch, step: int) -> None:
    """Chunks of ``step`` clips on every device (0: one chunk)."""
    monkeypatch.setattr(extract, "_wave_clips", lambda route, n_tiles, device: step)


@pytest.mark.parametrize("batch", [1, 2, 3, 34, 67, 256])
def test_chunked_batch_equals_single_dispatch(batch, many_clips, monkeypatch):
    """A batch launched in chunks of 3 clips and the rest (one chunk where
    the batch holds fewer than two) gives the bits of the batch in one
    chunk."""
    from lbaudiodetective_torch.utils import profiling

    cfg, clips = CONFIGS["parity"], many_clips[:batch]
    _chunks_of(monkeypatch, 0)
    single = extract_fingerprint_batch(clips, cfg, device="cpu")
    _chunks_of(monkeypatch, 3)
    with profiling.recording() as rec:
        chunked = extract_fingerprint_batch(clips, cfg, device="cpu")
    launches = [s.attrs for s in rec.spans if s.name == "extract.launch"]
    assert len(launches) == len(extract.chunk_bounds(batch, 3)) == (
        1 if batch < 6 else -(-batch // 3))
    for a, b in zip(single, chunked):
        np.testing.assert_array_equal(a, b)


def test_chunked_batch_pins_shapes_and_zeroes_padding_rows(many_clips, monkeypatch):
    """``pad_batch_to`` and ``n_sub_cap`` give the same bits in chunks, and
    the padding rows stay silent after the staging slots held clips."""
    from lbaudiodetective_torch.ops.extract import (
        get_extractor, required_padded_length, rows_for_subfingerprints)

    cfg, clips = CONFIGS["parity"], many_clips[:34]
    _chunks_of(monkeypatch, 0)
    single = extract_fingerprint_batch(clips, cfg, pad_batch_to=40, n_sub_cap=9, device="cpu")
    _chunks_of(monkeypatch, 3)
    chunked = extract_fingerprint_batch(clips, cfg, pad_batch_to=40, n_sub_cap=9, device="cpu")
    for a, b in zip(single, chunked):
        np.testing.assert_array_equal(a, b)
    assert single[0].shape == (34, 16, 100) and single[2].max() == 9
    # The padding rows, read in full: every subfingerprint counted valid.
    n_rows = rows_for_subfingerprints(cfg, 16)
    n_valid = np.full(40, 16, np.int32)
    pos, neg = get_extractor(cfg, "cpu").extract_clips(
        [c.samples for c in clips], n_valid, n_rows, required_padded_length(cfg, n_rows))
    assert pos.shape == (40, 16, 100) and pos[:34].any()
    assert not pos[34:].any() and not neg[34:].any()


def test_staging_reuse_leaks_no_stale_samples(monkeypatch):
    """Short clips right after long ones, through the same staging slots,
    give the short clips' own fingerprints: the windows that run past a
    clip's samples read zeros, not the samples an earlier chunk left."""
    from lbaudiodetective_torch.ops.extract import (
        FingerprintExtractor, bucket_subfingerprints, required_padded_length,
        rows_for_subfingerprints)

    cfg = CONFIGS["parity"]
    rate, file_rate = cfg.processing_sample_rate, cfg.file_sample_rate
    _chunks_of(monkeypatch, 3)
    extract_fingerprint_batch([synth_clip(400 + i, 6.0, cfg) for i in range(8)], cfg,
                              device="cpu")
    # One second of samples, counted as 2.5 s of file frames.
    short = [DecodedAudio(synth_clip(420 + i, 1.0, cfg).samples, rate, int(2.5 * file_rate),
                          file_rate) for i in range(8)]
    pos, neg, n_subs = extract_fingerprint_batch(short, cfg, device="cpu")
    n_rows = rows_for_subfingerprints(cfg, bucket_subfingerprints(int(n_subs.max())))
    x = np.zeros((8, required_padded_length(cfg, n_rows)), np.float32)
    for row, c in zip(x, short):
        row[:len(c.samples)] = c.samples
    assert required_padded_length(cfg, n_rows) > len(short[0].samples)
    rpos, rneg = FingerprintExtractor(cfg, "cpu")(torch.from_numpy(x), torch.from_numpy(n_subs),
                                                  n_rows)
    np.testing.assert_array_equal(pos, rpos.numpy())
    np.testing.assert_array_equal(neg, rneg.numpy())


def test_threads_extracting_at_once_get_their_own_batches(many_clips, monkeypatch):
    """Threads extracting different batches at once through the shared
    extractor, switching often, each get their own batch's fingerprints."""
    import sys
    import threading

    cfg = CONFIGS["parity"]
    _chunks_of(monkeypatch, 2)
    batches = [many_clips[:20], many_clips[20:34],
               [synth_clip(500 + i, 3.0, cfg) for i in range(12)], many_clips[34:44]]
    expected = [extract_fingerprint_batch(b, cfg, device="cpu") for b in batches]
    got: list[list] = [[] for _ in batches]
    start = threading.Barrier(len(batches))

    def run(k):
        start.wait()
        for _ in range(4):
            got[k].append(extract_fingerprint_batch(batches[k], cfg, device="cpu"))

    threads = [threading.Thread(target=run, args=(k,)) for k in range(len(batches))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for k in range(len(batches)):
        assert len(got[k]) == 4
        for result in got[k]:
            for a, b in zip(expected[k], result):
                np.testing.assert_array_equal(a, b)


def test_silence_extracts_all_zero_and_scores_zero():
    cfg = CONFIGS["parity"]
    rate, file_rate = cfg.processing_sample_rate, cfg.file_sample_rate
    d = DecodedAudio(np.zeros(int(3.0 * rate), np.float32), rate,
                     int(3.0 * file_rate), file_rate)
    pos, neg, n = extract_fingerprint(d, cfg, device="cpu")
    assert n > 0 and not pos.any() and not neg.any()
    assert match_fingerprints((pos, neg), (pos, neg), device="cpu") == 0.0


def test_short_clip_has_no_subfingerprints():
    cfg = CONFIGS["parity"]
    d = synth_clip(3, 0.2, cfg)
    pos, neg, n = extract_fingerprint(d, cfg, device="cpu")
    assert n == 0 and pos.shape == (0, 100)


def test_rows_implementation_per_device():
    """Each device takes the route named for what runs there: CUDA the
    kernels wherever the reference takes its Pallas kernels, the CPU the
    conv and gather paths."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert extraction_route(CONFIGS["parity"], cuda) == "fused_rows"
    assert extraction_route(CONFIGS["proc"], cuda) == "fused_rows"
    assert extraction_route(CONFIGS["parity"], cpu) == "conv"
    assert extraction_route(CONFIGS["fractional_hop"], cpu) == "gather"
    assert extraction_route(CONFIGS["fractional_hop"], cuda) == "band_rows"
    big_frames = FingerprintConfig(rows_per_frame=256)
    assert extraction_route(big_frames, cpu) == "conv"
    assert extraction_route(big_frames, cuda) == "band_rows_coeffs"
    assert extraction_route(FingerprintConfig(window_size=1024), cuda) == "conv"
    low_band = FingerprintConfig(min_frequency=1.0)
    assert extraction_route(low_band, cuda) == "gather"
    for cfg in TABLE.values():
        assert extraction_route(cfg, cpu) in ("conv", "gather")


#: The configs that reach the band-rows kernel on CUDA, with the route each
#: takes on CUDA and on the CPU.
TABLE = {
    "oracle_mode": FingerprintConfig(integer_hop=False),
    "rate_8000": FingerprintConfig(processing_sample_rate=8000.0, integer_hop=False),
    "pitch_16": FingerprintConfig(pitch_step_count=16),
    "length_300": FingerprintConfig(subfingerprint_length=300),
    "rows_256": FingerprintConfig(rows_per_frame=256),
    "window_1024": FingerprintConfig(window_size=1024, integer_hop=False),
}
ROUTES = {"oracle_mode": ("band_rows", "gather"), "rate_8000": ("band_rows", "gather"),
          "pitch_16": ("band_rows_coeffs", "conv"), "length_300": ("band_rows_coeffs", "conv"),
          "rows_256": ("band_rows_coeffs", "conv"), "window_1024": ("band_rows", "gather")}


def _extract_with(clip, cfg, route):
    """Single-clip extraction through ``route`` on CPU tensors (each
    kernel's plain version)."""
    from lbaudiodetective_torch.ops.constants import constants_to_tensors
    from lbaudiodetective_torch.ops.extract import (
        bucket_subfingerprints, required_padded_length, route_arrays, route_planes,
        rows_for_subfingerprints)

    n = cfg.num_subfingerprints(clip.file_frames, clip.proc_frames)
    n_rows = rows_for_subfingerprints(cfg, bucket_subfingerprints(n))
    x = np.zeros((1, required_padded_length(cfg, n_rows)), np.float32)
    t = min(len(clip.samples), x.shape[1])
    x[0, :t] = clip.samples[:t]
    consts = constants_to_tensors(route_arrays(cfg, route), "cpu")
    pos, neg = route_planes(route, torch.from_numpy(x), cfg, n_rows, consts)
    return pos.numpy()[0, :n], neg.numpy()[0, :n]


@pytest.mark.parametrize("name", sorted(TABLE))
def test_every_config_extracts_against_jax_and_oracle(name):
    """Each config of the port's routing table on the CPU: the default path
    and the CUDA route (run with the kernels' plain versions) against JAX
    extract_fingerprint and the NumPy oracle, >= 99.9 % of bits.  Window
    1024 with a fractional hop: the reference's kernel fails there, and so
    does the port's CUDA route, with ValueError."""
    from lbaudiodetective_tpu.ops.extract import extract_fingerprint as jax_extract
    from lbaudiodetective_tpu.oracle.pipeline import oracle_fingerprint

    cfg = TABLE[name]
    cuda_route, cpu_route = ROUTES[name]
    assert extraction_route(cfg, torch.device("cuda")) == cuda_route
    assert extraction_route(cfg, torch.device("cpu")) == cpu_route
    clip = synth_clip(27, 4.0, cfg)
    pos, neg, n = extract_fingerprint(clip, cfg, device="cpu")
    assert n > 0 and pos.shape == (n, cfg.num_wavelet_pairs)
    jpos, jneg, jn = jax_extract(jax_clip(clip), jax_config(cfg))
    assert jn == n
    assert bit_agreement(pos, neg, jpos[:n], jneg[:n]) >= 0.999
    opos, oneg = oracle_fingerprint(jax_clip(clip), jax_config(cfg))
    assert opos.shape[0] == n
    assert bit_agreement(pos, neg, opos, oneg) >= 0.999
    if name == "window_1024":
        with pytest.raises(ValueError, match="window_size == 2048"):
            _extract_with(clip, cfg, cuda_route)
        return
    rpos, rneg = _extract_with(clip, cfg, cuda_route)
    assert bit_agreement(rpos, rneg, jpos[:n], jneg[:n]) >= 0.999
    assert bit_agreement(rpos, rneg, opos, oneg) >= 0.999


@pytest.mark.parametrize("route", ["default", "cuda_route"])
def test_length_300_cpu_path_agrees_with_oracle_as_jax_does(route):
    """subfingerprint_length=300 keeps 150 of 4096 coefficients a frame, so
    float32 rounding flips the sign bits of near ties: on the seed-74 4 s
    clip the JAX package's own CPU path agrees only 99.873 % with the NumPy
    oracle, under the 99.9 % bar (the card's band-rows kernel is held to the
    oracle there, in tests/test_torch_cuda.py).  The port's CPU path, by its
    default route and by the kernel's plain version, does no worse."""
    from lbaudiodetective_tpu.ops.extract import extract_fingerprint as jax_extract
    from lbaudiodetective_tpu.oracle.pipeline import oracle_fingerprint

    cfg = TABLE["length_300"]
    clip = synth_clip(74, 4.0, cfg)
    opos, oneg = oracle_fingerprint(jax_clip(clip), jax_config(cfg))
    jpos, jneg, n = jax_extract(jax_clip(clip), jax_config(cfg))
    jax_agree = bit_agreement(np.asarray(jpos)[:n], np.asarray(jneg)[:n], opos, oneg)
    if route == "default":
        pos, neg, pn = extract_fingerprint(clip, cfg, device="cpu")
        assert pn == n
    else:
        pos, neg = _extract_with(clip, cfg, ROUTES["length_300"][0])
    agree = bit_agreement(pos, neg, opos, oneg)
    assert agree >= jax_agree >= 0.998, (agree, jax_agree)


def test_conv_route_equals_the_fused_rows_plain_version():
    """At the parity config the CPU's conv route gives, element for element,
    the classes of the fused rows kernel's plain version: the route the CPU
    takes there is that plain version op for op."""
    from lbaudiodetective_torch.ops.constants import constants_to_tensors
    from lbaudiodetective_torch.ops.extract import (
        FingerprintExtractor, required_padded_length, rows_for_subfingerprints)
    from lbaudiodetective_torch.ops.kernels.fused_rows import (
        fused_band_rows_plain, rows_arrays)

    cfg, n_sub = CONFIGS["parity"], 8
    n_rows = rows_for_subfingerprints(cfg, n_sub)
    x = np.zeros((3, required_padded_length(cfg, n_rows)), np.float32)
    for row, seed in zip(x, (26, 27, 28)):
        clip = synth_clip(seed, 3.0, cfg).samples[:x.shape[1]]
        row[:len(clip)] = clip
    audio = torch.from_numpy(x)
    extractor = FingerprintExtractor(cfg, "cpu")
    assert extractor.route == "conv"
    pos, neg = extractor(audio, torch.full((3,), n_sub), n_rows)
    cls = fused_band_rows_plain(audio, cfg, n_rows, constants_to_tensors(rows_arrays(cfg), "cpu"),
                                emit="classes")[..., :cfg.num_wavelet_pairs]
    assert pos.any() and neg.any()
    assert torch.equal(pos.to(torch.int32) + 2 * neg.to(torch.int32), cls)


@pytest.mark.parametrize("cfg_kwargs", [dict(rows_per_frame=256),
                                        dict(min_frequency=1.0)])
def test_other_rows_paths_match_jax(cfg_kwargs):
    """The conv path (frames that are not 128 x 32) and the packed-rfft path
    (band edges at bin 0) against the JAX package on the CPU."""
    from lbaudiodetective_tpu.ops.extract import extract_fingerprint as jax_extract

    cfg = FingerprintConfig(**cfg_kwargs)
    clip = synth_clip(23, 4.0, cfg)
    pos, neg, n = extract_fingerprint(clip, cfg, device="cpu")
    jpos, jneg, jn = jax_extract(jax_clip(clip), jax_config(cfg))
    assert n == jn > 0
    assert bit_agreement(pos, neg, jpos[:n], jneg[:n]) >= 0.999
