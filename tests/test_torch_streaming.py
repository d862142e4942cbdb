"""The port's streaming runtime (``lbaudiodetective_torch/streaming``) on the
CPU: incremental extraction equals the port's offline extractor over the
concatenated stream bit for bit, on every step path (aligned, conv,
fractional-hop gather, the rows_per_frame=256 ring), as
tests/test_streaming.py holds the JAX package's; and equals the JAX
package's own streaming on the same chunks (>= 99.9 % of bits, the port's
bar against the JAX package).  With a ``mesh`` the streams split over the
data slots and the bits equal the unsharded extractor's on every step path,
as tests/test_streaming.py holds the JAX package's sharded extractor."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.io.decode import DecodedAudio  # noqa: E402
from lbaudiodetective_torch.ops.extract import extract_fingerprint  # noqa: E402
from lbaudiodetective_torch.streaming import (  # noqa: E402
    StreamingDetective, StreamingExtractor)
from tests._torch_common import bit_agreement, brown_noise, jax_config  # noqa: E402


def _offline_reference(audio_batch, cfg, n_rows_avail):
    """Offline bits for streams: file_frames chosen so the offline row count
    equals the rows the stream has."""
    out = []
    for x in audio_batch:
        file_frames = n_rows_avail * cfg.analysis_stride + cfg.window_size
        d = DecodedAudio(samples=x, processing_rate=cfg.processing_sample_rate,
                         file_frames=file_frames, file_rate=cfg.file_sample_rate)
        pos, neg, n = extract_fingerprint(d, cfg, device="cpu")
        out.append((pos[:n], neg[:n]))
    return out


def _stream(cfg, audio, chunk, **kw):
    ext = StreamingExtractor(batch=audio.shape[0], chunk_size=chunk, config=cfg, device="cpu",
                             **kw)
    for s in range(audio.shape[1] // chunk):
        ext.feed(audio[:, s * chunk:(s + 1) * chunk])
    return ext


def _assert_equals_offline(ext, audio, cfg):
    fps = ext.fingerprints()
    refs = _offline_reference(audio, cfg, ext.rows_done)
    n_sub = ext.rows_done // cfg.rows_per_frame
    assert n_sub >= 1
    for b, fp in enumerate(fps):
        assert fp.num_subfingerprints == n_sub
        np.testing.assert_array_equal(fp.pos, refs[b][0][:n_sub], err_msg=f"stream {b} pos")
        np.testing.assert_array_equal(fp.neg, refs[b][1][:n_sub], err_msg=f"stream {b} neg")
    return fps


def _noise(seed, batch, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("hop_domain", ["file", "proc"])
def test_incremental_equals_offline(hop_domain):
    cfg = FingerprintConfig(hop_domain=hop_domain)
    audio = _noise(30, 3, 1024 * 12)
    ext = _stream(cfg, audio, 1024)
    assert ext.aligned == (hop_domain == "file") and ext.use_conv == (hop_domain == "proc")
    _assert_equals_offline(ext, audio, cfg)


def test_reset_clears_state():
    ext = StreamingExtractor(batch=2, chunk_size=1024, device="cpu")
    a = _noise(31, 2, 1024)
    for _ in range(3):
        ext.feed(a)
    assert ext.rows_done > 0 and ext.collected
    ext.reset()
    assert ext.rows_done == 0 and ext.total_samples == 0 and not ext.collected
    assert not ext.audio_ring.any() and not ext.lin_buf.any()


def test_streaming_detective_lifecycle():
    det = StreamingDetective(FingerprintConfig(), chunk_size=1024, device="cpu")
    done = []
    det.start_processing(max_subfingerprints=1, callback=done.append)
    rng = np.random.default_rng(32)
    # One subfingerprint needs 128 rows (~128 * 8 + 2048 samples in file
    # mode); 2048 samples cannot complete a frame yet.
    det.process_samples((rng.standard_normal(2048) * 0.1).astype(np.float32))
    assert not done
    det.pause_processing()
    det.process_samples(np.zeros(8192, np.float32))      # ignored while paused
    assert not done
    det.resume_processing()
    det.process_samples((rng.standard_normal(8192) * 0.1).astype(np.float32))
    assert len(done) == 1 and done[0].num_subfingerprints >= 1
    with pytest.raises(RuntimeError):
        StreamingDetective(device="cpu").resume_processing()


def test_feed_pcm16_matches_float_feed():
    """int16 ingest gives the float feed's bits (i16 / 32768 is exact)."""
    cfg = FingerprintConfig()
    rng = np.random.default_rng(9)
    chunk = cfg.rows_per_frame * int(cfg.hop_in_processing_samples)
    i16 = (rng.standard_normal((2, 6, chunk)) * 3276.8).astype(np.int16)
    f32 = i16.astype(np.float32) / 32768.0
    a = StreamingExtractor(batch=2, chunk_size=chunk, config=cfg, device="cpu")
    b = StreamingExtractor(batch=2, chunk_size=chunk, config=cfg, device="cpu")
    for s in range(6):
        a.feed(f32[:, s])
        b.feed_pcm16(i16[:, s])
    assert a.fingerprints() == b.fingerprints()
    with pytest.raises(ValueError):
        b.feed_pcm16(f32[:, 0])


@pytest.mark.parametrize("chunk", [512, 768])
def test_incremental_conv_path_non_aligned(chunk):
    """Parity hop, chunks that are not one frame: the conv step."""
    cfg = FingerprintConfig()
    audio = _noise(31, 2, chunk * 10)
    ext = _stream(cfg, audio, chunk)
    assert not ext.aligned and ext.use_conv
    _assert_equals_offline(ext, audio, cfg)


def test_streaming_large_rows_per_frame_ring():
    """rows_per_frame=256 sizes the rows ring up."""
    cfg = FingerprintConfig(rows_per_frame=256, hop_domain="proc")
    audio = _noise(32, 1, 2048 * 12)
    ext = _stream(cfg, audio, 2048)
    assert ext.ring_size >= cfg.rows_per_frame + ext.r_max
    _assert_equals_offline(ext, audio, cfg)


def test_incremental_fractional_hop_gather():
    """integer_hop=False streams through the mod-ring window gather."""
    cfg = FingerprintConfig(integer_hop=False)
    audio = _noise(33, 1, 1024 * 6)
    ext = _stream(cfg, audio, 1024)
    assert not ext.aligned and not ext.use_conv
    _assert_equals_offline(ext, audio, cfg)


@pytest.mark.parametrize("case", ["aligned", "conv", "gather"])
def test_equals_jax_streaming(case):
    """The port's streaming and the JAX package's on the same chunks."""
    from lbaudiodetective_tpu.streaming.runtime import StreamingExtractor as JaxStreaming

    cfg, chunk = {"aligned": (FingerprintConfig(), 1024),
                  "conv": (FingerprintConfig(hop_domain="proc"), 512),
                  "gather": (FingerprintConfig(integer_hop=False), 1024)}[case]
    audio = brown_noise(34, 2, 20480)
    ext = _stream(cfg, audio, chunk)
    jax_ext = JaxStreaming(batch=2, chunk_size=chunk, config=jax_config(cfg))
    for s in range(audio.shape[1] // chunk):
        jax_ext.feed(audio[:, s * chunk:(s + 1) * chunk])
    assert (ext.aligned, ext.use_conv) == (jax_ext.aligned, jax_ext.use_conv)
    assert ext.rows_done == jax_ext.rows_done
    for fp, jfp in zip(ext.fingerprints(), jax_ext.fingerprints()):
        assert fp.num_subfingerprints == jfp.num_subfingerprints >= 1
        assert bit_agreement(fp.pos, fp.neg, jfp.pos, jfp.neg) >= 0.999


def test_device_is_explicit():
    """A device that is not there raises; results stay on the device with
    ``collect_host=False`` until harvest."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamingExtractor(batch=1, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamingDetective(device="cuda")
    cfg = FingerprintConfig()
    audio = _noise(35, 2, 1024 * 4)
    ext = _stream(cfg, audio, 1024, collect_host=False)
    assert all(isinstance(p, torch.Tensor) for p, _ in ext.collected)
    host = _stream(cfg, audio, 1024)
    assert ext.fingerprints() == host.fingerprints()


@pytest.mark.parametrize("case", ["aligned", "conv", "gather"])
def test_sharded_over_data_slots_equals_unsharded_and_jax(case):
    """8 streams over the 4 data slots of a 1-D CPU mesh (two a slot, as in
    the reference's sharded test): the same bits as the unsharded extractor, on the host
    and kept on the device; the JAX package's sharded extractor within the
    port's bar."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from lbaudiodetective_tpu.streaming.runtime import StreamingExtractor as JaxStreaming
    from lbaudiodetective_torch.parallel.mesh import Mesh, Slot

    cfg, chunk = {"aligned": (FingerprintConfig(), 1024),
                  "conv": (FingerprintConfig(hop_domain="proc"), 1024),
                  "gather": (FingerprintConfig(integer_hop=False), 1024)}[case]
    mesh = Mesh(np.array([Slot(i, torch.device("cpu")) for i in range(4)], dtype=object),
                ("data",))
    chunks = _noise(31, 8, 1024 * 20).reshape(8, 20, 1024).transpose(1, 0, 2)
    plain = StreamingExtractor(batch=8, chunk_size=chunk, config=cfg, device="cpu")
    sharded = StreamingExtractor(batch=8, chunk_size=chunk, config=cfg, device="cpu",
                                 mesh=mesh)
    on_device = StreamingExtractor(batch=8, chunk_size=chunk, config=cfg, device="cpu",
                                   collect_host=False, mesh=mesh)
    jax_sharded = JaxStreaming(batch=8, chunk_size=chunk, config=jax_config(cfg),
                               mesh=JaxMesh(np.array(jax.devices()[:4]), ("data",)))
    for c in chunks:
        n_plain = plain.feed(c)[2]
        assert sharded.feed(c)[2] == on_device.feed(c)[2] == n_plain
        jax_sharded.feed(c)
    assert len(sharded._parts) == 4 and sharded.rows_done == plain.rows_done
    fps = plain.fingerprints()
    assert fps[0].num_subfingerprints >= 1
    for fp, a, b, j in zip(fps, sharded.fingerprints(), on_device.fingerprints(),
                           jax_sharded.fingerprints()):
        assert a == fp and b == fp
        assert bit_agreement(a.pos, a.neg, j.pos, j.neg) >= 0.999
    sharded.reset()
    assert sharded.rows_done == 0 and not sharded.collected
    assert all(p.rows_done == 0 for p in sharded._parts)
    with pytest.raises(ValueError, match="batch must divide"):
        StreamingExtractor(batch=6, config=cfg, device="cpu", mesh=mesh)
