"""The port's ShardedFingerprintLibrary (``lbaudiodetective_torch/parallel/
sharded_library.py``) on a 4-way library axis of CPU slots, the cases of
tests/test_sharded_library.py: scores and rankings equal the single-device
library's and the JAX package's ShardedFingerprintLibrary's bit for bit,
padding never reaches a result, sharded files cross between the packages,
and the service, live sessions and the session pool take a sharded
library unchanged (on WAVs written from a seed: the corpus is absent)."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_tpu import serving as jax_serving  # noqa: E402
from lbaudiodetective_tpu.config import FingerprintConfig as JaxConfig  # noqa: E402
from lbaudiodetective_tpu.models.library import FingerprintLibrary as JaxLibrary  # noqa: E402
from lbaudiodetective_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from lbaudiodetective_tpu.parallel.sharded_library import (  # noqa: E402
    ShardedFingerprintLibrary as JaxSharded)
from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.models.fingerprint import Fingerprint  # noqa: E402
from lbaudiodetective_torch.models.library import FingerprintLibrary  # noqa: E402
from lbaudiodetective_torch.parallel.mesh import make_mesh  # noqa: E402
from lbaudiodetective_torch.parallel.sharded_library import ShardedFingerprintLibrary  # noqa: E402
from lbaudiodetective_torch.serving import IdentificationService  # noqa: E402
from lbaudiodetective_torch.streaming.incremental import StreamSessionPool  # noqa: E402
from tests._torch_common import brown_noise, jax_fp  # noqa: E402
from tests.test_match import random_fp  # noqa: E402


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(8, library_parallelism=4), make_mesh(8, library_parallelism=4,
                                                              device="cpu")


def _fps(rng, sizes, pairs=100):
    return [Fingerprint.from_planes(*random_fp(rng, int(n), pairs), 2 * pairs) for n in sizes]


def _libraries(fps, meshes):
    """The port's library, its sharded form and the JAX package's sharded
    form of the same fingerprints."""
    lib = FingerprintLibrary.from_fingerprints(fps, device="cpu")
    return lib, ShardedFingerprintLibrary(lib, meshes[1]), JaxSharded(
        JaxLibrary.from_fingerprints([jax_fp(f) for f in fps]), meshes[0])


def test_sharded_match_equals_single_device_and_jax(meshes):
    rng = np.random.default_rng(81)
    fps = _fps(rng, [12, 3, 7, 9, 1, 12, 5, 8, 10, 2, 6])   # 11: pads the 4-way axis
    lib, slib, jlib = _libraries(fps, meshes)
    assert len(slib) == len(lib) == 11 and slib.n_padded == 12
    assert [int(c.shape[0]) for c in slib.count_shards] == [3, 3, 3, 3]
    assert slib.pos_shards[0].data_ptr() != lib.pos_words.data_ptr()    # padding copies
    for qi in (0, 4, 10):
        got = slib.match(fps[qi])
        assert got.shape == (11,)
        np.testing.assert_array_equal(got, lib.match(fps[qi]))
        np.testing.assert_array_equal(got, jlib.match(jax_fp(fps[qi])))


def test_sharded_search_equals_single_device_and_jax(meshes):
    rng = np.random.default_rng(82)
    fps = _fps(rng, [8 + (i % 5) for i in range(32)])      # 32: shards are views
    lib, slib, jlib = _libraries(fps, meshes)
    assert slib.pos_shards[1].data_ptr() == lib.pos_words[8].data_ptr()
    for qi in (3, 17):
        got_idx, got_sc = slib.search(fps[qi], top_k=4)
        ref_idx, ref_sc = lib.search(fps[qi], top_k=4)
        np.testing.assert_array_equal(got_idx, ref_idx)
        np.testing.assert_array_equal(got_sc, ref_sc)
        j_idx, j_sc = jlib.search(jax_fp(fps[qi]), top_k=4)
        np.testing.assert_array_equal(got_idx, j_idx)
        np.testing.assert_array_equal(got_sc, j_sc)
    gi, gs = slib.search_many([fps[3], fps[17]], top_k=4)
    np.testing.assert_array_equal(gi[0], lib.search(fps[3], top_k=4)[0])
    np.testing.assert_array_equal(gi[1], lib.search(fps[17], top_k=4)[0])
    assert gs.shape == (2, 4)


def test_search_zero_score_query_never_returns_padding(meshes):
    rng = np.random.default_rng(85)
    fps = _fps(rng, [6, 9, 5, 7, 8, 4, 10])                # 7 entries over 4 shards
    _, slib, jlib = _libraries(fps, meshes)
    zero = Fingerprint.from_planes(np.zeros((5, 100), np.uint8), np.zeros((5, 100), np.uint8),
                                   200)
    idx, sc = slib.search(zero, top_k=5)
    assert idx.shape == (5,) and (idx < 7).all() and (sc == 0.0).all()
    np.testing.assert_array_equal(idx, jlib.search(jax_fp(zero), top_k=5)[0])
    bi, bs = slib.search_many([zero, fps[1], zero], top_k=5)
    assert bi.shape == (3, 5) and (bi < 7).all()
    assert (bs[0] == 0.0).all() and (bs[2] == 0.0).all()
    ji, js = jlib.search_many([jax_fp(f) for f in (zero, fps[1], zero)], top_k=5)
    np.testing.assert_array_equal(bi, ji)
    np.testing.assert_array_equal(bs, js)


def test_search_many_batched_equals_looped(meshes):
    rng = np.random.default_rng(84)
    fps = _fps(rng, [5 + (i % 7) for i in range(27)])      # 27 % 4 != 0
    lib, slib, _ = _libraries(fps, meshes)
    queries = [fps[i] for i in (0, 9, 13, 22, 26)]
    bi, bs = slib.search_many(queries, top_k=3)
    assert bi.shape == (5, 3)
    for r, q in enumerate(queries):
        li, ls = slib.search(q, top_k=3)
        np.testing.assert_array_equal(bi[r], li)
        np.testing.assert_array_equal(bs[r], ls)
        ri, rs = lib.search(q, top_k=3)
        np.testing.assert_array_equal(bi[r], ri)
        np.testing.assert_array_equal(bs[r], rs)


def test_search_chunk_not_dividing_shard(meshes):
    rng = np.random.default_rng(85)
    fps = _fps(rng, [6 + (i % 5) for i in range(24)])      # 6 a shard, chunk 4
    lib, slib, jlib = _libraries(fps, meshes)
    for qi in (0, 11, 23):
        kw = dict(top_k=3, shortlist=2, chunk=4, coarse_stride=2)
        idx, sc = slib.search(fps[qi], **kw)
        brute = lib.match(fps[qi])
        assert int(idx[0]) == qi and sc[0] == pytest.approx(1.0)
        np.testing.assert_array_equal(sc, brute[idx])      # exact re-scores
        j_idx, j_sc = jlib.search(jax_fp(fps[qi]), **kw)
        np.testing.assert_array_equal(idx, j_idx)
        np.testing.assert_array_equal(sc, j_sc)
    bi, _ = slib.search_many([fps[0], fps[11]], top_k=3, shortlist=2, chunk=4,
                             coarse_stride=2)
    assert int(bi[0, 0]) == 0 and int(bi[1, 0]) == 11


def test_match_many_and_identify(meshes):
    rng = np.random.default_rng(83)
    fps = _fps(rng, [6, 9, 12, 4, 8])
    lib, slib, jlib = _libraries(fps, meshes)
    got = slib.match_many(fps[:3])
    np.testing.assert_array_equal(got, lib.match_many(fps[:3]))
    np.testing.assert_array_equal(got, jlib.match_many([jax_fp(f) for f in fps[:3]]))
    assert slib.match_many([]).shape == (0, 5)
    bi, bs = slib.identify(fps[2])
    assert bi == 2 and bs == pytest.approx(1.0)


def test_save_load_sharded_roundtrip_across_packages(meshes, tmp_path):
    rng = np.random.default_rng(86)
    fps = _fps(rng, [7, 4, 9, 5, 11, 6, 8])                # 7 entries: pads
    lib, slib, jlib = _libraries(fps, meshes)
    d = str(tmp_path / "db")
    slib.save_sharded(d)
    re = ShardedFingerprintLibrary.load_sharded(d, meshes[1], lib.config)
    assert len(re) == 7
    np.testing.assert_array_equal(re.match(fps[3]), slib.match(fps[3]))
    d2 = str(tmp_path / "db2")                             # another shard count on disk
    slib.save_sharded(d2, n_shards=3)
    re2 = ShardedFingerprintLibrary.load_sharded(d2, meshes[1], lib.config)
    np.testing.assert_array_equal(re2.match(fps[3]), slib.match(fps[3]))
    with pytest.raises(ValueError):                        # the parameter-hash guard
        ShardedFingerprintLibrary.load_sharded(d, meshes[1],
                                               FingerprintConfig(subfingerprint_length=100))
    from_port = JaxSharded.load_sharded(d, meshes[0], JaxConfig())   # port -> JAX
    np.testing.assert_array_equal(from_port.match(jax_fp(fps[3])), slib.match(fps[3]))
    d3 = str(tmp_path / "jdb")                             # JAX -> port
    jlib.save_sharded(d3, n_shards=2)
    from_jax = ShardedFingerprintLibrary.load_sharded(d3, meshes[1], lib.config)
    np.testing.assert_array_equal(from_jax.match(fps[5]), jlib.match(jax_fp(fps[5])))


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Five 3 s WAVs, the first four fingerprinted, and a crop of track b."""
    from lbaudiodetective_torch.io.wav import write_wav
    from lbaudiodetective_torch.models.detective import AudioDetective

    root = tmp_path_factory.mktemp("sharded_serving")
    sig = brown_noise(80, 4, 3 * 44100)
    sig = 0.5 * sig / np.abs(sig).max(axis=1, keepdims=True)
    paths = [str(root / f"{i}.wav") for i in range(4)]
    for p, x in zip(paths, sig):
        write_wav(p, x, 44100)
    write_wav(str(root / "crop.wav"), sig[1][16385:120000], 44100)
    det = AudioDetective(device="cpu")
    return [det.process_audio_file(p) for p in paths], open(root / "crop.wav", "rb").read()


def test_serving_edge_with_sharded_library(meshes, clips):
    """The service answers identically on the sharded library, the port's
    and the JAX package's, in the score and search forms."""
    fps, payload = clips
    names = ["a", "b", "c", "d"]
    lib, slib, jlib = _libraries(fps, meshes)
    for kw in ({}, dict(search_threshold=1, top_k=2)):
        ref = IdentificationService(lib, names, device="cpu", **kw).identify(payload)
        got = IdentificationService(slib, names, device="cpu", **kw).identify(payload)
        assert got == ref
        assert got == jax_serving.IdentificationService(jlib, names, JaxConfig(),
                                                        **kw).identify(payload)
        assert got["track"] == "b"


@pytest.mark.parametrize("pool", [False, True])
def test_streaming_sessions_over_sharded_library(meshes, pool):
    """Live sessions on a sharded library: every running result equals the
    single-device service's and the JAX package's sharded service's."""
    rng = np.random.default_rng(83)
    fps = _fps(rng, [6, 9, 4, 11, 7, 10, 3])               # 7: pads the 4-way axis
    names = [f"t{i}" for i in range(len(fps))]
    lib, slib, jlib = _libraries(fps, meshes)
    kw = dict(stream_cap=16, stream_pool=pool, stream_flush_window_s=0.0)
    services = [IdentificationService(lib, names, device="cpu", **kw),
                IdentificationService(slib, names, device="cpu", **kw),
                jax_serving.IdentificationService(jlib, names, JaxConfig(), **kw)]
    sids = [s.stream_open()["session"] for s in services]
    subs = fps[3].to_string().split("+")
    i = 0
    for k in (2, 5, 4):
        chunk = "+".join(subs[i:i + k]).encode()
        i += k
        plain, got, ref = (s.stream_update(sid, chunk) for s, sid in zip(services, sids))
        assert got == plain == ref and got["n"] == i
    final = services[1].stream_close(sids[1])
    assert final["track"] == "t3" and final["score"] == pytest.approx(1.0, abs=1e-5)


def test_session_pool_and_checkpoints_on_sharded_library(meshes, tmp_path):
    """The slot-batched pool on a sharded library equals the pool on the
    single-device one; a single-session checkpoint restores into a fresh
    pool on the same mesh (the padded entry axis is part of the geometry a
    checkpoint is keyed to, as in the JAX package, so a single-device pool
    refuses it), and the JAX package's sharded matcher reads a sharded
    matcher's checkpoint."""
    from lbaudiodetective_tpu.streaming.incremental import (
        IncrementalLibraryMatcher as JaxMatcher)
    from lbaudiodetective_torch.streaming.incremental import IncrementalLibraryMatcher

    rng = np.random.default_rng(87)
    fps = _fps(rng, [6, 9, 4, 11, 7, 10, 3])
    lib, slib, jlib = _libraries(fps, meshes)
    pools = [StreamSessionPool(x, slots=4, n_cap=4, device="cpu") for x in (lib, slib)]
    for p in pools:
        for sid in ("a", "b"):
            p.open(sid)
    for step in range(3):
        for p in pools:
            p.post("a", fps[1].pos[step * 3:step * 3 + 3], fps[1].neg[step * 3:step * 3 + 3])
            p.post("b", fps[5].pos[step:step + 2], fps[5].neg[step:step + 2])
            p.flush()
        for a, b in zip(pools[0].top_k(3), pools[1].top_k(3)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pools[0].scores_for("a"), pools[1].scores_for("a"))
    path = str(tmp_path / "a.npz")
    pools[1].save_session("a", path)
    fresh = StreamSessionPool(slib, slots=4, n_cap=4, device="cpu")
    fresh.open("x")
    fresh.restore_session("x", path)
    np.testing.assert_array_equal(fresh.scores_for("x"), pools[1].scores_for("a"))
    with pytest.raises(ValueError, match="different library or stream geometry"):
        pools[0].restore_session("a", path)

    m = IncrementalLibraryMatcher(slib, batch=2, n_cap=4, device="cpu")
    q = np.stack([fps[1].pos[:5], fps[2].pos[:4].repeat(2, 0)[:5]])
    qn = np.stack([fps[1].neg[:5], fps[2].neg[:4].repeat(2, 0)[:5]])
    m.update(q, qn)
    jm = JaxMatcher(jlib, batch=2, n_cap=4)
    jm.update(q, qn)
    np.testing.assert_array_equal(m.scores(), jm.scores())
    m.save_state(str(tmp_path / "m.npz"))
    jm2 = JaxMatcher(jlib, batch=2, n_cap=4)
    jm2.restore_state(str(tmp_path / "m.npz"))
    np.testing.assert_array_equal(jm2.scores(), m.scores())


def test_stream_sessions_concurrent_threads(meshes):
    """Concurrent sessions on a sharded library, each streaming its own
    entry, all converge on their own track."""
    rng = np.random.default_rng(84)
    fps = _fps(rng, [8] * 8)
    names = [f"t{i}" for i in range(8)]
    _, slib, _ = _libraries(fps, meshes)
    svc = IdentificationService(slib, names, stream_cap=16, max_sessions=8, device="cpu")
    results, errors = {}, []

    def worker(i):
        try:
            subs = fps[i].to_string().split("+")
            sid = svc.stream_open()["session"]
            for j in range(0, len(subs), 3):
                svc.stream_update(sid, "+".join(subs[j:j + 3]).encode())
            results[i] = svc.stream_close(sid)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    for i, r in results.items():
        assert r["track"] == names[i] and r["n"] == 8
        assert r["score"] == pytest.approx(1.0, abs=1e-5)
