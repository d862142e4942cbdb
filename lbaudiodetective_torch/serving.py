"""Serving edge: the essay's "Whistles" identification server (port of the
JAX package's ``serving.py``).

The reference project's iOS app uploads a recording and a server matches it
against a fingerprint DB over HTTP/JSON (essay PDF §3.2.5).  This module is
a stdlib-HTTP edge over :class:`~lbaudiodetective_torch.models.library.
FingerprintLibrary`: decode runs on the host, extraction and matching on
the library's device (on CUDA the port's kernels: the rows and select
kernels extract, the packed match kernel scores).

Endpoints (JSON unless noted):
  GET  /healthz               -> {"ok": true, "tracks": N}
  POST /identify              body: raw CAF, WAV, AIFF or AU bytes
                              -> {"track": name, "score": s, "scores": {...}}
                              (libraries above ``search_threshold``: the
                              exact top-k "top" list replaces "scores")
  POST /fingerprint           body: raw audio bytes
                              -> {"n": count, "fingerprint": "0110...+..."}
  POST /identify-fingerprint  body: fingerprint string ("0110...+..."), the
                              essay's protocol (the phone fingerprints, the
                              server only matches)
  POST /stream/open           -> {"session": id}, a live-recognition session
  POST /stream/<id>           body: fingerprint string of the NEW
                              subfingerprints since the last post ->
                              running {"track", "score", "top", "n"}, the
                              scores of a full rematch of the accumulated
                              fingerprint (incremental diagonal state)
  GET  /stream/<id>           the running result, without posting
  POST /stream/<id>/close     final result; frees the session state

Handler threads run device work one at a time, under ``_lock`` and inside
``torch.cuda.device`` of the service's device.  Locks are taken in one
order: ``_slock``, a session's lock, ``_pcond``, ``_lock``.  Unlike the JAX
package, the service does not warn about ``matmul_precision``: the port's
kernels compute at one precision whatever its value.  A
:class:`~lbaudiodetective_torch.parallel.sharded_library.
ShardedFingerprintLibrary` is served unchanged: the service runs on its
first slot's device, and each slot scans its shard.

Inside ``profiling.recording()`` each request is a ``serve.request`` span
(attributes ``method``, ``route``) over ``serve.parse``, the pool's spans
and ``serve.respond``.  A pooled post: ``pool.enqueue`` (``waited_ns`` to
take ``_pcond``); the leader's ``pool.window`` (``waited_ns`` to take
``_pcond``, ``timeout_ns`` the window; past it, the wait to take ``_pcond``
back) or a follower's ``pool.wait``; ``pool.dispatch_wait`` (taking
``_lock``); ``pool.flush`` (``cause``, ``sessions``, ``k_max``, ``rows``,
``slots_folded``: the slots whose hits the fold counted, the posting
sessions'; a post-caused one lists the ``requests`` it answered, and each
of their ``serve.request`` spans names it in ``flush``); ``pool.top_k``
(``cause``, ``slots_scored``, ``slots_used``), which scores only the slots
it answers: those of a flush's posting sessions still open, the one slot
of a peek or a close.  ``pool.close`` and ``pool.open`` carry
``waited_ns`` for the locks.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from lbaudiodetective_torch import errors
from lbaudiodetective_torch.config import FingerprintConfig
from lbaudiodetective_torch.device import DEFAULT_DEVICE, library_device
from lbaudiodetective_torch.io.decode import decode_audio_file
from lbaudiodetective_torch.models.fingerprint import Fingerprint
from lbaudiodetective_torch.models.library import FingerprintLibrary
from lbaudiodetective_torch.ops.extract import extract_fingerprint, extract_fingerprint_batch
from lbaudiodetective_torch.streaming.incremental import (
    IncrementalLibraryMatcher, StreamSessionPool)
from lbaudiodetective_torch.utils import profiling


class IdentificationService:
    """Request -> response core (testable without sockets).

    ``batch_window_s > 0`` turns on identify micro-batching: concurrent
    requests arriving within the window (or until ``max_batch``) are
    extracted in one padded dispatch by the first-arriving thread (the
    batch leader), then matched together and handed back.  Results equal
    the unbatched path's (batched extraction is bit-identical to per-clip
    extraction).

    ``search_threshold`` picks the matching by library size: at or below
    it, scores for every track (the ``"scores"`` dict); above it, the
    two-stage coarse -> exact search's ``"top"`` list of ``top_k``
    candidates with exact scores.
    """

    def __init__(self, library: FingerprintLibrary, names: list[str],
                 config: FingerprintConfig | None = None,
                 batch_window_s: float = 0.0, max_batch: int = 8,
                 search_threshold: int = 4096, top_k: int = 5,
                 n_sub_cap: int = 0, stream_cap: int = 256,
                 max_sessions: int = 64, stream_library_max: int = 65536,
                 stream_idle_evict_s: float = 30.0,
                 stream_pool: bool = False,
                 stream_flush_window_s: float = 0.02,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.device = library_device(library, device, "IdentificationService")
        if len(names) != len(library):
            raise errors.InvalidArgumentError("names must match library size")
        self.library = library
        self.names = list(names)
        self.config = config or FingerprintConfig()
        #: Held by every call that runs device work: one thread at a time
        #: dispatches.  A post or a request is ~100 small torch ops, each
        #: giving up and retaking the GIL; unserialised handler threads
        #: queue behind each other's Python at every op.
        self._lock = threading.Lock()
        self.batch_window_s = batch_window_s
        self.max_batch = max_batch
        self._bcond = threading.Condition()
        self._pending: list[dict] = []
        self.search_threshold = search_threshold
        self.top_k = top_k
        #: > 0 pins every batched extraction to one shape: the batch axis
        #: padded to max_batch, the subfingerprint bucket fixed at the cap
        #: (longer clips truncate).
        self.n_sub_cap = n_sub_cap
        #: Number of extraction dispatches (observability and tests).
        self.extract_dispatches = 0
        self.stream_cap = stream_cap
        self.max_sessions = max_sessions
        #: Largest library live sessions are served against: the incremental
        #: matcher holds unpacked ``[L * S, 2 * pairs]`` bf16 planes (25x the
        #: packed size; float32 where a hit count could pass 256) plus
        #: ``L x (S + stream_cap)`` float32 diagonals a session, so opens
        #: past it are refused with a typed 429.
        self.stream_library_max = stream_library_max
        #: A session is evictable once idle this long; /stream/open never
        #: destroys an actively-posting session (it 429s instead).
        self.stream_idle_evict_s = stream_idle_evict_s
        self._slock = threading.Lock()
        self._sessions: dict[str, dict] = {}
        self._template: IncrementalLibraryMatcher | None = None
        #: Pooled sessions share one slot-batched matcher
        #: (``StreamSessionPool``): posts arriving within
        #: ``stream_flush_window_s`` fold in one call and one top-k of their
        #: sessions' slots.  Scores are bitwise equal to the per-session
        #: matchers'.
        self.stream_pool = stream_pool
        self.stream_flush_window_s = stream_flush_window_s
        self._pool: StreamSessionPool | None = None
        self._pcond = threading.Condition()
        self._ppending: list[dict] = []

    @contextlib.contextmanager
    def _dispatch(self, wait_span: str = "serve.dispatch_wait"):
        """Device work: under ``_lock`` (acquiring it is the span
        ``wait_span``), with the service's device as the calling thread's
        current device."""
        with profiling.stage(wait_span):
            self._lock.acquire()
        try:
            with (torch.cuda.device(self.device) if self.device.type == "cuda"
                  else contextlib.nullcontext()):
                yield
        finally:
            self._lock.release()

    @property
    def _use_search(self) -> bool:
        return len(self.library) > self.search_threshold

    def _decode_bytes(self, payload: bytes):
        suffix = (".caf" if payload[:4] == b"caff"
                  else ".aiff" if payload[:4] == b"FORM"
                  else ".au" if payload[:4] == b".snd" else ".wav")
        with tempfile.NamedTemporaryFile(suffix=suffix) as f:
            f.write(payload)
            f.flush()
            return decode_audio_file(f.name)

    def _count_dispatch(self) -> None:
        with self._lock:                 # += on a counter is not atomic
            self.extract_dispatches += 1

    def _fingerprint_clip(self, clip) -> Fingerprint:
        with self._dispatch():
            pos, neg, n = extract_fingerprint(clip, self.config, device=self.device)
        self._count_dispatch()
        return Fingerprint.from_planes(pos[:n], neg[:n], self.config.subfingerprint_length)

    def _respond(self, fp: Fingerprint) -> dict:
        if fp.num_subfingerprints == 0:
            raise errors.DecodeError("clip too short to fingerprint")
        with self._dispatch():
            if self._use_search:
                return self._response_from_topk(*self.library.search(fp, top_k=self.top_k))
            scores = self.library.match(fp)
        return self._response_from_scores(scores)

    def _response_from_topk(self, idx, scores) -> dict:
        return {"track": self.names[int(idx[0])], "score": float(scores[0]),
                "top": [{"track": self.names[int(i)], "score": float(s)}
                        for i, s in zip(idx, scores)]}

    def _response_from_scores(self, scores: np.ndarray) -> dict:
        best = int(np.argmax(scores))
        return {"track": self.names[best], "score": float(scores[best]),
                "scores": {n: float(s) for n, s in zip(self.names, scores)}}

    def identify(self, payload: bytes) -> dict:
        if self.batch_window_s <= 0:
            return self._respond(self._fingerprint_clip(self._decode_bytes(payload)))
        return self._identify_batched(payload)

    def identify_fingerprint(self, payload: bytes) -> dict:
        """Identify an uploaded fingerprint (the string golden form): the
        essay's division of labour, match only, no extraction here."""
        return self._respond(self._parse_fingerprint_text(payload))

    # -- micro-batching -------------------------------------------------------

    def _identify_batched(self, payload: bytes) -> dict:
        decoded = self._decode_bytes(payload)    # decode stays per-thread
        entry = {"clip": decoded, "done": threading.Event(), "fp": None, "error": None}
        with self._bcond:
            self._pending.append(entry)
            is_leader = len(self._pending) == 1
            if len(self._pending) >= self.max_batch:
                self._bcond.notify_all()         # wake the leader early
        if is_leader:
            with self._bcond:
                self._bcond.wait_for(lambda: len(self._pending) >= self.max_batch,
                                     timeout=self.batch_window_s)
                batch, self._pending = self._pending, []
            # A burst larger than max_batch runs in chunks: every taken
            # entry is processed here, so no follower is left waiting.
            for start in range(0, len(batch), self.max_batch):
                self._run_batch(batch[start:start + self.max_batch])
        else:
            entry["done"].wait()
        if entry["error"] is not None:
            raise entry["error"]
        if entry.get("topk") is not None:       # searched in the batch
            return self._response_from_topk(*entry["topk"])
        if entry.get("scores") is not None:     # matched in the batch
            return self._response_from_scores(entry["scores"])
        return self._respond(entry["fp"])

    def _run_batch(self, batch: list[dict]) -> None:
        try:
            with self._dispatch():
                pos, neg, n_subs = extract_fingerprint_batch(
                    [e["clip"] for e in batch], self.config,
                    pad_batch_to=self.max_batch if self.n_sub_cap else 0,
                    n_sub_cap=self.n_sub_cap, device=self.device)
            self._count_dispatch()
            for i, e in enumerate(batch):
                n = int(n_subs[i])
                e["fp"] = Fingerprint.from_planes(pos[i, :n], neg[i, :n],
                                                  self.config.subfingerprint_length)
            # The batch is matched in one call too (clips too short to
            # fingerprint raise DecodeError in their own thread).
            matchable = [e for e in batch if e["fp"].num_subfingerprints > 0]
            if matchable:
                fps_m = [e["fp"] for e in matchable]
                if self.n_sub_cap and len(fps_m) < self.max_batch:
                    # Fixed shapes reach the match stage: empty fingerprints
                    # (count 0, score 0) pad the query batch.
                    empty = np.zeros((0, fps_m[0].pairs), np.uint8)
                    fps_m += [Fingerprint.from_planes(
                        empty, empty, self.config.subfingerprint_length)] * (
                        self.max_batch - len(fps_m))
                with self._dispatch():
                    if self._use_search:
                        idx, sc = self.library.search_many(fps_m, top_k=self.top_k)
                        for i, e in enumerate(matchable):
                            e["topk"] = (idx[i], sc[i])
                    else:
                        for e, s in zip(matchable, self.library.match_many(fps_m)):
                            e["scores"] = s
        except Exception:  # noqa: BLE001 - isolate the failing clip(s):
            # re-run each clip alone, on the same device through the same
            # kernels, so one pathological request fails only itself, as on
            # the unbatched path.
            for e in batch:
                try:
                    e["fp"] = self._fingerprint_clip(e["clip"])
                except Exception as exc_one:  # noqa: BLE001
                    e["error"] = exc_one
        finally:
            for e in batch:
                e["done"].set()

    def fingerprint(self, payload: bytes) -> dict:
        fp = self._fingerprint_clip(self._decode_bytes(payload))
        return {"n": fp.num_subfingerprints, "fingerprint": fp.to_string()}

    def health(self) -> dict:
        return {"ok": True, "tracks": len(self.library)}

    # -- live-recognition streaming sessions ----------------------------------
    #
    # The phone fingerprints locally and posts only the new subfingerprints
    # of its recording; the server folds them into per-session diagonal
    # state and answers with the running best match.  A session's state is
    # L x (S + stream_cap) float32 diagonals (~20 MB at 16k tracks, cap
    # 256), so sessions are capped and idle ones evicted LRU.

    def _parse_fingerprint_text(self, payload: bytes) -> Fingerprint:
        with profiling.stage("serve.parse", bytes=len(payload)) as span:
            try:
                text = payload.decode("ascii")
            except UnicodeDecodeError as e:
                raise errors.InvalidArgumentError(
                    f"fingerprint payload is not ASCII: {e}") from None
            text = text.strip()
            if text and set(text) - set("01+"):
                raise errors.InvalidArgumentError(
                    "fingerprint string may contain only '0', '1' and '+'")
            first = text.split("+", 1)[0] if text else ""
            if first and len(first) != self.config.subfingerprint_length:
                raise errors.InvalidArgumentError(
                    f"fingerprint subfingerprint length {len(first)} does not "
                    f"match server config ({self.config.subfingerprint_length})")
            try:
                fp = Fingerprint.from_string(text, self.config.subfingerprint_length)
            except ValueError as e:             # ragged subfingerprints
                raise errors.InvalidArgumentError(str(e)) from None
            span.set(rows=fp.num_subfingerprints)
            return fp

    def stream_open(self) -> dict:
        if len(self.library) > self.stream_library_max:
            raise errors.ResourceExhaustedError(
                f"live-recognition sessions are limited to libraries of "
                f"<= {self.stream_library_max} tracks (this one has "
                f"{len(self.library)}); use /identify-fingerprint")
        with self._slock:
            self._ensure_template()
            if len(self._sessions) >= self.max_sessions:
                # Evict the least-recently-used session only if it is idle:
                # a server full of live streams refuses new opens rather
                # than destroy an active client's state.
                victim = min(self._sessions, key=lambda k: self._sessions[k]["t"])
                if time.monotonic() - self._sessions[victim]["t"] < self.stream_idle_evict_s:
                    raise errors.ResourceExhaustedError(
                        f"all {self.max_sessions} session slots hold "
                        "active streams; retry shortly")
                del self._sessions[victim]
                if self.stream_pool:
                    with (profiling.stage("pool.close", cause="evict") as span, self._pcond,
                          self._dispatch("pool.dispatch_wait")):
                        span.elapsed("waited_ns")
                        self._pool.close(victim)
            sid = uuid.uuid4().hex[:16]
            sess = {"t": time.monotonic(), "lock": threading.Lock()}
            if self.stream_pool:
                with profiling.stage("pool.open") as span, self._pcond:
                    span.elapsed("waited_ns")
                    self._pool.open(sid)
            else:
                with self._dispatch():
                    sess["m"] = self._template.clone_empty()
            self._sessions[sid] = sess
        return {"session": sid}

    def _stream_session(self, sid: str) -> dict:
        with self._slock:
            sess = self._sessions.get(sid)
        if sess is None:
            raise errors.InvalidArgumentError(f"unknown session {sid!r}")
        return sess

    def stream_update(self, sid: str, payload: bytes) -> dict:
        sess = self._stream_session(sid)
        fp = self._parse_fingerprint_text(payload)
        k = fp.num_subfingerprints
        if self.stream_pool:
            return self._stream_update_pooled(sess, sid, fp, k)
        with sess["lock"], self._dispatch():
            m = sess["m"]
            if k:
                if m.n + k > m.n_cap:
                    raise errors.InvalidArgumentError(
                        f"stream age {m.n + k} exceeds the session cap "
                        f"({m.n_cap}); close and re-open")
                m.update_bucketed(fp.pos[None], fp.neg[None])
            sess["t"] = time.monotonic()
            return self._stream_result(m)

    def _stream_update_pooled(self, sess: dict, sid: str, fp, k: int) -> dict:
        """Pooled post: queue the increment, then fold every queued post in
        one call (leader/follower over ``stream_flush_window_s``, as
        identify batches) and answer all waiters from one top-k of the
        slots of their sessions still open."""
        entry = {"sid": sid, "done": threading.Event(), "error": None, "result": None,
                 "request": profiling.current().request, "flush": None}
        with profiling.stage("pool.enqueue", rows=k) as span, self._pcond:
            span.elapsed("waited_ns")
            if sid not in self._pool._slot:
                raise errors.InvalidArgumentError(f"unknown session {sid!r}")
            if k:
                age = self._pool.age(sid) + self._pool.pending(sid)
                if age + k > self.stream_cap:
                    raise errors.InvalidArgumentError(
                        f"stream age {age + k} exceeds the session cap "
                        f"({self.stream_cap}); close and re-open")
                self._pool.post(sid, fp.pos, fp.neg)
            self._ppending.append(entry)
            is_leader = len(self._ppending) == 1
            if len(self._ppending) >= self.max_sessions:
                self._pcond.notify_all()         # wake the leader early
        if is_leader:
            with contextlib.ExitStack() as held:
                with profiling.stage("pool.window",
                                     timeout_ns=int(self.stream_flush_window_s * 1e9)) as span:
                    held.enter_context(self._pcond)
                    span.elapsed("waited_ns")
                    if self.stream_flush_window_s > 0:
                        # The wait releases the lock, so concurrent posts can
                        # join this flush; a full window wakes the leader early.
                        self._pcond.wait_for(lambda: len(self._ppending) >= self.max_sessions,
                                             timeout=self.stream_flush_window_s)
                batch, self._ppending = self._ppending, []
                try:
                    with self._dispatch("pool.dispatch_wait"):
                        flush = self._fold("post", [en["request"] for en in batch])
                        # A session's row in the top-k; one closed while
                        # queued has none.
                        row = {sid: i for i, sid in enumerate(dict.fromkeys(
                            en["sid"] for en in batch if en["sid"] in self._pool._slot))}
                        sc, ix = self._rank("post", list(row))
                    for en in batch:
                        en["flush"] = flush
                        i = row.get(en["sid"])
                        if i is None:
                            en["error"] = errors.InvalidArgumentError(
                                f"unknown session {en['sid']!r}")
                        else:
                            en["result"] = self._pool_result(en["sid"], sc[i], ix[i])
                except Exception as e:  # noqa: BLE001 - fail all waiters
                    for en in batch:
                        if en["error"] is None and en["result"] is None:
                            en["error"] = e
                finally:
                    for en in batch:
                        en["done"].set()
        else:
            with profiling.stage("pool.wait"):
                entry["done"].wait()
        profiling.current().set(flush=entry["flush"])
        if entry["error"] is not None:
            raise entry["error"]
        sess["t"] = time.monotonic()
        return entry["result"]

    def _fold(self, cause: str, requests=None):
        """``StreamSessionPool.flush`` as the span ``pool.flush``; returns
        the span's id (None while nothing records).  Callers hold
        ``_pcond`` and ``_lock``."""
        with profiling.stage("pool.flush", cause=cause) as span:
            self._pool.flush()
            span.set(**self._pool.last_flush)
            if requests is not None:
                span.set(requests=requests)
        return span.id

    def _rank(self, cause: str, sids: list[str]):
        """``StreamSessionPool.top_k`` of the sessions ``sids`` (their slots'
        scores, the top-k and the copy to the host; rows in their order) as
        the span ``pool.top_k``: ``slots_scored`` counts the rows scored,
        ``slots_used`` the sessions answered."""
        with profiling.stage("pool.top_k", cause=cause, slots_used=len(sids)) as span:
            sc, ix = self._pool.top_k(self.top_k, sids)
            span.set(slots_scored=len(sc))
            return sc, ix

    def _top_result(self, sc: np.ndarray, ix: np.ndarray, n: int) -> dict:
        if n == 0:
            return {"track": None, "score": 0.0, "top": [], "n": 0}
        return {"track": self.names[int(ix[0])], "score": float(sc[0]),
                "top": [{"track": self.names[int(i)], "score": float(s)}
                        for i, s in zip(ix, sc)],
                "n": int(n)}

    def _pool_result(self, sid: str, sc: np.ndarray, ix: np.ndarray) -> dict:
        return self._top_result(sc, ix, self._pool.age(sid))

    def _stream_result(self, m: IncrementalLibraryMatcher) -> dict:
        if m.n == 0:
            return self._top_result(None, None, 0)
        # Device-side top-k: top_k winners a post, not the [L] score plane.
        sc, ix = m.top_k(self.top_k)
        return self._top_result(sc[0], ix[0], m.n)

    def _ensure_template(self) -> None:
        """Build the per-library matcher the sessions share, once (callers
        hold ``_slock``)."""
        with self._dispatch():
            if self.stream_pool:
                if self._pool is None:
                    self._pool = StreamSessionPool(
                        self.library, slots=self.max_sessions, n_cap=self.stream_cap,
                        config=self.config, device=self.device)
            elif self._template is None:
                self._template = IncrementalLibraryMatcher(
                    self.library, batch=1, n_cap=self.stream_cap, config=self.config,
                    device=self.device)

    def save_sessions(self, dir_path: str) -> int:
        """Checkpoint every live session's state (one npz a session) so a
        restart keeps streams whose audio only ever existed as posted
        increments.  Returns the count.  Checkpoints of sessions no longer
        live are removed: the directory mirrors the session table."""
        os.makedirs(dir_path, exist_ok=True)
        with self._slock:
            items = list(self._sessions.items())
        live = {f"{sid}.npz" for sid, _ in items}
        for fname in os.listdir(dir_path):
            if fname.endswith(".npz") and fname not in live:
                os.unlink(os.path.join(dir_path, fname))
        if self.stream_pool:
            with self._pcond, self._dispatch("pool.dispatch_wait"):
                self._fold("save")          # pending posts become device state
                for sid, _ in items:
                    self._pool.save_session(sid, os.path.join(dir_path, f"{sid}.npz"))
            return len(items)
        for sid, sess in items:
            with sess["lock"], self._dispatch():
                sess["m"].save_state(os.path.join(dir_path, f"{sid}.npz"))
        return len(items)

    def load_sessions(self, dir_path: str) -> int:
        """Restore sessions saved by :meth:`save_sessions` against the same
        library (the state key is checked a file).  Returns the count.
        Unreadable or mismatched checkpoints are skipped with a warning: one
        bad file must not keep the server from booting."""
        count = 0
        with self._slock:
            self._ensure_template()
            for fname in sorted(os.listdir(dir_path)):
                if not fname.endswith(".npz"):
                    continue
                if len(self._sessions) >= self.max_sessions:
                    break
                sid = fname[:-4]
                sess = {"t": time.monotonic(), "lock": threading.Lock()}
                try:
                    if self.stream_pool:
                        with self._pcond, self._dispatch():
                            self._pool.open(sid)
                            try:
                                self._pool.restore_session(sid, os.path.join(dir_path, fname))
                            except Exception:
                                self._pool.close(sid)
                                raise
                    else:
                        with self._dispatch():
                            m = self._template.clone_empty()
                            m.restore_state(os.path.join(dir_path, fname))
                        sess["m"] = m
                except Exception as e:  # noqa: BLE001 - skip, do not brick boot
                    print(f"skipping session checkpoint {fname}: {e}", file=sys.stderr)
                    continue
                self._sessions[sid] = sess
                count += 1
        return count

    def stream_peek(self, sid: str) -> dict:
        """The running result of a session without posting (``GET
        /stream/<id>``).  Counts as activity, so a polling client does not
        become evictable."""
        sess = self._stream_session(sid)
        if self.stream_pool:
            with self._pcond, self._dispatch("pool.dispatch_wait"):
                if sid not in self._pool._slot:
                    raise errors.InvalidArgumentError(f"unknown session {sid!r}")
                self._fold("peek")          # fold this session's queued posts
                sc, ix = self._rank("peek", [sid])
                sess["t"] = time.monotonic()
                return self._pool_result(sid, sc[0], ix[0])
        with sess["lock"], self._dispatch():
            sess["t"] = time.monotonic()
            return self._stream_result(sess["m"])

    def stream_close(self, sid: str) -> dict:
        with self._slock:
            sess = self._sessions.pop(sid, None)
        if sess is None:
            raise errors.InvalidArgumentError(f"unknown session {sid!r}")
        if self.stream_pool:
            with (profiling.stage("pool.close", cause="close") as span, self._pcond,
                  self._dispatch("pool.dispatch_wait")):
                span.elapsed("waited_ns")
                if sid not in self._pool._slot:
                    raise errors.InvalidArgumentError(f"unknown session {sid!r}")
                self._fold("close")         # fold any queued posts first
                sc, ix = self._rank("close", [sid])
                result = self._pool_result(sid, sc[0], ix[0])
                self._pool.close(sid)
                return result
        with sess["lock"], self._dispatch():
            return self._stream_result(sess["m"])


class IdentificationServer(ThreadingHTTPServer):
    """The HTTP server, one thread a request."""

    #: Listen backlog.  ``socketserver``'s default of 5 drops the connections
    #: of a burst of concurrent clients, which then wait out TCP's SYN
    #: retransmits (1 s, then 3 s).
    request_queue_size = 128


def _route(path: str) -> str:
    """A request path with a session id in it replaced by ``<id>``."""
    if path.startswith("/stream/") and path != "/stream/open":
        return "/stream/<id>/close" if path.endswith("/close") else "/stream/<id>"
    return path


def make_server(service: IdentificationService, host: str = "127.0.0.1",
                port: int = 0) -> IdentificationServer:
    """Build (not start) the HTTP server; ``server.server_address[1]`` is the
    bound port (ephemeral when ``port=0``)."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: dict) -> None:
            with profiling.stage("serve.respond", status=code) as span:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                span.set(bytes=len(body))

        def do_GET(self):
            with profiling.stage("serve.request", method="GET", route=_route(self.path)):
                self._get()

        def do_POST(self):
            with profiling.stage("serve.request", method="POST", route=_route(self.path)):
                self._post()

        def _get(self):
            try:
                if self.path == "/healthz":
                    self._send(200, service.health())
                elif self.path.startswith("/stream/"):
                    self._send(200, service.stream_peek(self.path[len("/stream/"):]))
                else:
                    self._send(404, {"error": "not found"})
            except errors.AudioDetectiveError as e:
                self._send(400, {"error": str(e), "status": e.status})
            except Exception as e:  # noqa: BLE001 - the serving edge must not die
                self._send(500, {"error": str(e)})

        def _post(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = self.rfile.read(length)
                if self.path == "/identify":
                    self._send(200, service.identify(payload))
                elif self.path == "/identify-fingerprint":
                    self._send(200, service.identify_fingerprint(payload))
                elif self.path == "/fingerprint":
                    self._send(200, service.fingerprint(payload))
                elif self.path == "/stream/open":
                    self._send(200, service.stream_open())
                elif self.path.startswith("/stream/") and self.path.endswith("/close"):
                    self._send(200, service.stream_close(
                        self.path[len("/stream/"):-len("/close")]))
                elif self.path.startswith("/stream/"):
                    self._send(200, service.stream_update(self.path[len("/stream/"):],
                                                          payload))
                else:
                    self._send(404, {"error": "not found"})
            except errors.ResourceExhaustedError as e:
                self._send(429, {"error": str(e), "status": e.status})
            except errors.AudioDetectiveError as e:
                self._send(400, {"error": str(e), "status": e.status})
            except Exception as e:  # noqa: BLE001 - the serving edge must not die
                self._send(500, {"error": str(e)})

        def log_message(self, *a):  # quiet test output
            pass

    return IdentificationServer((host, port), Handler)


def serve_forever(service: IdentificationService, host: str = "0.0.0.0",
                  port: int = 8080) -> None:  # pragma: no cover - CLI entry
    make_server(service, host, port).serve_forever()
