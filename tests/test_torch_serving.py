"""The port's HTTP identification service (``serving.py``) vs the JAX
package's on the CPU, on WAVs written from a seed (the corpus is absent).

The same payloads through both packages' ``IdentificationService`` give
equal JSON: identify (the ``"scores"`` and the search ``"top"`` forms),
fingerprint, identify-fingerprint and the live-session endpoints, per
session and pooled; scores are compared as floats, so equal means bit for
bit.  Also: batched equals unbatched, the isolation retry stays on the
service's device, typed errors and 429s, session checkpoints that restore
in either package, and one socket round trip through ``make_server``."""

import http.client
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_tpu import serving as jax_serving  # noqa: E402
from lbaudiodetective_tpu.config import FingerprintConfig as JaxConfig  # noqa: E402
from lbaudiodetective_tpu.io.wav import write_wav  # noqa: E402
from lbaudiodetective_tpu.models.library import FingerprintLibrary as JaxLibrary  # noqa: E402
from lbaudiodetective_torch import errors, serving  # noqa: E402
from lbaudiodetective_torch.models.detective import AudioDetective  # noqa: E402
from lbaudiodetective_torch.models.library import FingerprintLibrary  # noqa: E402
from tests._torch_common import brown_noise, jax_fp  # noqa: E402

NAMES = ["a", "b", "c", "d"]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Five 3 s WAVs (the first four enrolled), a crop of track b, and
    both packages' libraries of the four."""
    root = tmp_path_factory.mktemp("serving")
    sig = brown_noise(80, 5, 3 * 44100)
    sig = 0.5 * sig / np.abs(sig).max(axis=1, keepdims=True)
    paths = []
    for i, x in enumerate(sig):
        paths.append(str(root / f"{i}.wav"))
        write_wav(paths[-1], x, 44100)
    write_wav(str(root / "crop.wav"), sig[1][16385:120000], 44100)
    payloads = [open(p, "rb").read() for p in paths + [str(root / "crop.wav")]]
    det = AudioDetective(device="cpu")
    fps = [det.process_audio_file(p) for p in paths[:4]]
    lib = FingerprintLibrary.from_fingerprints(fps, device="cpu")
    jlib = JaxLibrary.from_fingerprints([jax_fp(f) for f in fps], JaxConfig())
    return lib, jlib, payloads, fps


def services(case, **kw):
    lib, jlib, _, _ = case
    return (serving.IdentificationService(lib, NAMES, device="cpu", **kw),
            jax_serving.IdentificationService(jlib, NAMES, JaxConfig(), **kw))


@pytest.mark.parametrize("search_threshold", [4096, 2])
def test_identify_fingerprint_endpoints_equal_jax(case, search_threshold):
    port, jax = services(case, search_threshold=search_threshold, top_k=3)
    for payload in case[2]:
        got = port.identify(payload)
        assert got == jax.identify(payload)
        assert ("top" in got) == (search_threshold == 2)
        fp = port.fingerprint(payload)
        assert fp == jax.fingerprint(payload)
        text = fp["fingerprint"].encode()
        assert port.identify_fingerprint(text) == jax.identify_fingerprint(text) == got
    assert port.extract_dispatches == jax.extract_dispatches == 12
    assert port.identify(case[2][5])["track"] == "b"
    assert port.health() == jax.health() == {"ok": True, "tracks": 4}


def test_bad_payloads_are_typed_errors(case):
    port, _ = services(case)
    with pytest.raises(errors.DecodeError):
        port.identify(b"this is not audio at all")
    for bad, what in ((b"01+2x", "only"), ("01".encode() * 3, "length"),
                      ("é".encode(), "ASCII"), (("01" * 100 + "+" + "0").encode(), None)):
        with pytest.raises(errors.InvalidArgumentError, match=what):
            port.identify_fingerprint(bad)
    with pytest.raises(errors.DecodeError, match="too short"):
        port.identify_fingerprint(b"")
    with pytest.raises(errors.InvalidArgumentError, match="names"):
        serving.IdentificationService(case[0], NAMES[:2], device="cpu")


@pytest.mark.parametrize("n_sub_cap", [0, 24])
def test_batched_identify_equals_unbatched(case, n_sub_cap):
    unbatched, _ = services(case)
    batched, _ = services(case, batch_window_s=0.5, max_batch=4, n_sub_cap=n_sub_cap)
    payloads = case[2][:4]
    want = [unbatched.identify(p) for p in payloads]
    got = [None] * 4
    threads = [threading.Thread(target=lambda i=i: got.__setitem__(
        i, batched.identify(payloads[i]))) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if n_sub_cap:               # clips longer than the cap are truncated
        assert [g["track"] for g in got] == NAMES
    else:
        assert got == want
    assert batched.extract_dispatches < 4


def test_failed_batch_retries_each_clip_on_the_service_device(case, monkeypatch):
    """A failing batch is re-run clip by clip through the same extraction
    on the same device; a clip that still fails fails only its request."""
    port, _ = services(case, batch_window_s=0.5, max_batch=2)
    devices = []
    real = serving.extract_fingerprint

    def boom(*a, **k):
        raise RuntimeError("batch failed")

    def spy(clip, config, device):
        devices.append(device)
        if clip.samples.shape[0] < 1000:
            raise RuntimeError("kernel launch failed")
        return real(clip, config, device=device)

    monkeypatch.setattr(serving, "extract_fingerprint_batch", boom)
    monkeypatch.setattr(serving, "extract_fingerprint", spy)
    results = {}

    def call(key, payload):
        try:
            results[key] = port.identify(payload)
        except RuntimeError as e:
            results[key] = e

    tiny = case[2][0][:44 + 400]                 # a WAV header and a few samples
    threads = [threading.Thread(target=call, args=(k, p))
               for k, p in (("good", case[2][2]), ("bad", tiny))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert results["good"]["track"] == "c"
    assert isinstance(results["bad"], RuntimeError)
    assert devices and all(d == port.device for d in devices)


@pytest.mark.parametrize("pool", [False, True])
def test_stream_sessions_equal_jax(case, pool):
    port, jax = services(case, stream_pool=pool, stream_flush_window_s=0.0, top_k=3)
    fps = case[3]
    subs = fps[2].to_string().split("+")
    sp, sj = port.stream_open()["session"], jax.stream_open()["session"]
    for i in range(0, len(subs), 5):
        body = "+".join(subs[i:i + 5]).encode()
        assert port.stream_update(sp, body) == jax.stream_update(sj, body)
    assert port.stream_update(sp, b"") == jax.stream_update(sj, b"")      # an empty post
    peek = port.stream_peek(sp)
    assert peek == jax.stream_peek(sj) and peek["track"] == "c" and peek["score"] == 1.0
    assert peek["n"] == fps[2].num_subfingerprints
    assert port.stream_close(sp) == jax.stream_close(sj) == peek
    with pytest.raises(errors.InvalidArgumentError, match="unknown session"):
        port.stream_update(sp, b"")
    empty = port.stream_open()["session"]
    assert port.stream_peek(empty) == {"track": None, "score": 0.0, "top": [], "n": 0}


def test_concurrent_pooled_posts_fold_in_one_flush(case):
    port, _ = services(case, stream_pool=True, stream_flush_window_s=0.5, max_sessions=4)
    fps = case[3]
    sids = [port.stream_open()["session"] for _ in range(4)]
    flushes = []
    real = port._pool.flush
    port._pool.flush = lambda: flushes.append(real()) or flushes[-1]
    out = [None] * 4
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, port.stream_update(
        sids[i], "+".join(fps[i].to_string().split("+")[:6]).encode()))) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert [o["track"] for o in out] == NAMES and all(o["n"] == 6 for o in out)
    assert flushes == [4]


def test_pooled_answers_equal_per_session_answers(case):
    """Pooled answers, ranked over just the slots answered, equal the
    per-session service's (which scores each session alone): posts folded
    together in one flush, a flush of some of the sessions, and a peek and a
    close of sessions whose neighbours posted since their last answer."""
    pooled, _ = services(case, stream_pool=True, stream_flush_window_s=0.2, max_sessions=6,
                         top_k=3)
    per, _ = services(case, top_k=3)
    subs = [fp.to_string().split("+") for fp in case[3]]
    sp = [pooled.stream_open()["session"] for _ in range(4)]
    ss = [per.stream_open()["session"] for _ in range(4)]

    def post_together(who, r):
        bodies = {i: "+".join(subs[i][3 * r:3 * r + 3]).encode() for i in who}
        out = {}
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, pooled.stream_update(sp[i], bodies[i]))) for i in who]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for i in who:
            assert out[i] == per.stream_update(ss[i], bodies[i]), i

    post_together([0, 1, 2, 3], 0)
    post_together([2, 0], 1)                    # two of the four slots, unsorted
    post_together([1, 0], 2)
    assert pooled.stream_peek(sp[3]) == per.stream_peek(ss[3])
    assert pooled.stream_peek(sp[2]) == per.stream_peek(ss[2])
    closed = pooled.stream_close(sp[1])
    assert closed == per.stream_close(ss[1]) and closed["n"] == 6
    post_together([3, 2, 0], 3)
    for i in (0, 2, 3):
        assert pooled.stream_close(sp[i]) == per.stream_close(ss[i]), i

    # A session closed while its post waits in the window: the close folds
    # and answers it, the post fails as unknown, and the flush still answers
    # the other session that posted in it.
    sp = [pooled.stream_open()["session"] for _ in range(2)]
    ss = [per.stream_open()["session"] for _ in range(2)]
    bodies = ["+".join(subs[i][:4]).encode() for i in (2, 3)]
    out = [None, None]

    def post(i):
        try:
            out[i] = pooled.stream_update(sp[i], bodies[i])
        except errors.InvalidArgumentError as e:
            out[i] = e

    pooled.stream_flush_window_s = 1.0
    threads = [threading.Thread(target=post, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
        time.sleep(0.1)
    closed = pooled.stream_close(sp[0])
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    per.stream_update(ss[0], bodies[0])
    assert closed == per.stream_close(ss[0]) and closed["n"] == 4
    assert isinstance(out[0], errors.InvalidArgumentError) and "unknown session" in str(out[0])
    assert out[1] == per.stream_update(ss[1], bodies[1]) and out[1]["n"] == 4


def test_session_caps_eviction_and_429s(case):
    lib = case[0]
    port = serving.IdentificationService(lib, NAMES, device="cpu", max_sessions=2,
                                         stream_cap=8, stream_idle_evict_s=3600.0)
    a = port.stream_open()["session"]
    port.stream_open()
    with pytest.raises(errors.ResourceExhaustedError, match="active"):
        port.stream_open()
    with pytest.raises(errors.InvalidArgumentError, match="cap"):
        port.stream_update(a, ("+".join(["01" * 100] * 9)).encode())
    port.stream_idle_evict_s = 0.0               # every session is now idle
    c = port.stream_open()["session"]
    assert a not in port._sessions and c in port._sessions
    with pytest.raises(errors.InvalidArgumentError, match="unknown"):
        port.stream_peek(a)
    small = serving.IdentificationService(lib, NAMES, device="cpu", stream_library_max=3)
    with pytest.raises(errors.ResourceExhaustedError, match="limited"):
        small.stream_open()


@pytest.mark.parametrize("pool", [False, True])
def test_session_checkpoints_restore_in_either_package(case, tmp_path, pool):
    port, jax = services(case, stream_pool=pool, stream_flush_window_s=0.0)
    subs = case[3][1].to_string().split("+")
    sp = port.stream_open()["session"]
    port.stream_update(sp, "+".join(subs[:7]).encode())
    stale = tmp_path / "gone.npz"
    stale.write_bytes(b"not a checkpoint")
    assert port.save_sessions(str(tmp_path)) == 1
    assert not stale.exists()                  # the directory mirrors the table
    for fresh in services(case, stream_pool=not pool, stream_flush_window_s=0.0):
        assert fresh.load_sessions(str(tmp_path)) == 1
        got = fresh.stream_update(sp, "+".join(subs[7:]).encode())
        port_fresh, _ = services(case)
        want = port_fresh.identify_fingerprint("+".join(subs).encode())
        assert got["track"] == "b" and got["score"] == want["score"]
        assert got["n"] == len(subs)
    (tmp_path / "bad.npz").write_bytes(b"truncated")
    assert services(case)[0].load_sessions(str(tmp_path)) == 1      # skipped, not fatal


def test_http_round_trip(case):
    port, _ = services(case, top_k=2)
    srv = serving.make_server(port)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def call(method, path, body=None):
        conn = http.client.HTTPConnection(*srv.server_address, timeout=60)
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())

    try:
        assert call("GET", "/healthz") == (200, {"ok": True, "tracks": 4})
        status, body = call("POST", "/identify", case[2][5])
        assert status == 200 and body == port.identify(case[2][5])
        status, body = call("POST", "/fingerprint", case[2][0])
        assert status == 200 and body["n"] > 0
        status, body = call("POST", "/identify-fingerprint", body["fingerprint"].encode())
        assert status == 200 and body["track"] == "a"
        status, body = call("POST", "/identify", b"garbage")
        with pytest.raises(errors.AudioDetectiveError) as refused:
            port.identify(b"garbage")
        assert status == 400 and body["status"] == refused.value.status
        assert call("GET", "/nope")[0] == call("POST", "/nope", b"")[0] == 404
        sid = call("POST", "/stream/open")[1]["session"]
        text = "+".join(case[3][3].to_string().split("+")[:4])
        status, body = call("POST", f"/stream/{sid}", text.encode())
        assert status == 200 and body["track"] == "d" and body["n"] == 4
        assert call("GET", f"/stream/{sid}") == (200, body)
        assert call("POST", f"/stream/{sid}/close") == (200, body)
        assert call("GET", f"/stream/{sid}")[0] == 400
        port.stream_library_max = 1
        status, body = call("POST", "/stream/open")
        assert status == 429 and body["status"] == errors.RESOURCE_EXHAUSTED
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_service_runs_on_the_library_device(case):
    with pytest.raises(ValueError, match="not on meta"):
        serving.IdentificationService(case[0], NAMES, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serving.IdentificationService(case[0], NAMES)


def test_no_precision_warning_where_the_jax_package_warns(case):
    """The JAX package's service and identifier warn at an identify entry
    point when ``matmul_precision`` is a tier its accelerator kernels do not
    reproduce; the port's kernels compute at one precision whatever the
    field says, so its service and identifier build without a warning."""
    import warnings

    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch.streaming import StreamingIdentifier

    cfg = FingerprintConfig(matmul_precision="default")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        serving.IdentificationService(case[0], NAMES, cfg, device="cpu")
        StreamingIdentifier(case[0], 2, config=cfg, device="cpu")


def test_concurrent_mixed_load_keeps_every_session_exact(case):
    """More threads than cores, a short switch interval: per-session and
    pooled posts, peeks and identifies at once.  Every session's last answer
    equals a one-shot identification of everything it posted, so no post
    was lost or folded twice, and no thread deadlocks."""
    import os
    import sys

    lib = case[0]
    per = serving.IdentificationService(lib, NAMES, device="cpu", max_sessions=32)
    pooled = serving.IdentificationService(lib, NAMES, device="cpu", stream_pool=True,
                                           stream_flush_window_s=0.001, max_sessions=32)
    fps = case[3]
    n_threads = 2 * min(os.cpu_count() or 4, 8)
    results, failures = {}, []

    def work(i):
        try:
            svc = (per, pooled)[i % 2]
            fp = fps[i % 4]
            sid = svc.stream_open()["session"]
            subs = fp.to_string().split("+")
            for k in range(0, len(subs), 3):
                svc.stream_update(sid, "+".join(subs[k:k + 3]).encode())
                svc.stream_peek(sid)
                if k % 6 == 0:
                    svc.identify_fingerprint("+".join(subs[:k + 3]).encode())
            results[i] = (svc.stream_close(sid), svc.identify_fingerprint(
                fp.to_string().encode()))
        except Exception as e:  # noqa: BLE001 - reported below
            failures.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not failures, failures
    for i, (closed, one_shot) in results.items():
        assert closed["track"] == one_shot["track"] == NAMES[i % 4]
        assert closed["score"] == one_shot["score"]
        assert closed["n"] == fps[i % 4].num_subfingerprints
    assert len(results) == n_threads


def test_pooled_posts_over_http_record_their_spans(case):
    """Inside ``recording()``, 8 sessions posting at once over HTTP, twice:
    every request is one ``serve.request`` root whose spans share its
    request id, the flushes fold every post, each post names the flush that
    answered it, and each top-k span scores just the slots it answers."""
    from lbaudiodetective_torch.utils import profiling

    port, _ = services(case, stream_pool=True, stream_flush_window_s=0.2, max_sessions=8)
    srv = serving.make_server(port)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def call(method, path, body=None):
        conn = http.client.HTTPConnection(*srv.server_address, timeout=60)
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())

    subs = [fp.to_string().split("+") for fp in case[3]]
    with profiling.recording() as rec:
        try:
            sids = [call("POST", "/stream/open")[1]["session"] for _ in range(8)]
            for r in range(2):
                out = [None] * 8
                posts = [threading.Thread(target=lambda i=i: out.__setitem__(i, call(
                    "POST", f"/stream/{sids[i]}",
                    "+".join(subs[i % 4][3 * r:3 * r + 3]).encode()))) for i in range(8)]
                for t in posts:
                    t.start()
                for t in posts:
                    t.join(timeout=120)
                assert not any(t.is_alive() for t in posts)
                assert [o[0] for o in out] == [200] * 8
                assert [o[1]["n"] for o in out] == [3 * r + 3] * 8
            assert call("GET", f"/stream/{sids[0]}")[0] == 200
            assert call("POST", f"/stream/{sids[1]}/close")[0] == 200
            # A handler closes its root span after the client has its
            # answer, and a span that closes after the recording is not
            # kept: wait for all 26 roots.
            deadline = time.monotonic() + 60
            while (sum(s.name == "serve.request" for s in list(rec.spans)) < 26
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        finally:
            srv.shutdown()
            srv.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()
    spans = {s.id: s for s in rec.spans}
    roots = [s for s in rec.spans if s.name == "serve.request"]
    assert all(s.parent is None and s.request == s.id for s in roots)
    for s in rec.spans:
        if s.parent is not None:
            assert s.request == spans[s.parent].request and s.thread == spans[s.parent].thread
    assert sorted(s.attrs["route"] for s in roots) == sorted(
        ["/stream/open"] * 8 + ["/stream/<id>"] * 17 + ["/stream/<id>/close"])
    posts = [s for s in roots if s.attrs["route"] == "/stream/<id>" and s.attrs["method"] == "POST"]
    assert len(posts) == 16
    flushes = {s.id: s for s in rec.spans if s.name == "pool.flush"}
    by_cause = {c: [f for f in flushes.values() if f.attrs["cause"] == c]
                for c in ("post", "peek", "close")}
    assert len(by_cause["post"]) + len(by_cause["peek"]) + len(by_cause["close"]) == len(flushes)
    assert sum(f.attrs["sessions"] for f in flushes.values()) == 16
    assert sum(f.attrs["rows"] for f in flushes.values()) == 16 * 3
    assert all(f.attrs["slots_folded"] == f.attrs["sessions"] for f in flushes.values())
    for p in posts:
        flush = flushes[p.attrs["flush"]]
        assert flush.attrs["cause"] == "post" and p.request in flush.attrs["requests"]
        assert flush.start_ns >= p.start_ns
    answered = sorted(r for f in by_cause["post"] for r in f.attrs["requests"])
    assert answered == sorted(p.request for p in posts)
    tops = [s for s in rec.spans if s.name == "pool.top_k"]
    assert all(t.attrs["slots_scored"] == t.attrs["slots_used"] for t in tops)
    for t in tops:
        (flush,) = [f for f in flushes.values()
                    if f.parent == t.parent and f.request == t.request]
        used = len(flush.attrs["requests"]) if t.attrs["cause"] == "post" else 1
        assert t.attrs["cause"] == flush.attrs["cause"] and t.attrs["slots_used"] == used
    assert {t.attrs["cause"] for t in tops} == {"post", "peek", "close"}
    names = {s.name for s in rec.spans}
    assert {"serve.parse", "pool.enqueue", "pool.window", "pool.dispatch_wait",
            "serve.respond", "pool.close", "pool.open"} <= names
    assert all(s.attrs["waited_ns"] >= 0 for s in rec.spans
               if s.name in ("pool.enqueue", "pool.window", "pool.close", "pool.open"))
