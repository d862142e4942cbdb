"""A phone in live recognition: ``sessions`` concurrent live sessions over
HTTP against the configuration's library, served by the program's pooled
sessions.  Each session opens, posts the next ``post_rows`` subfingerprints
of a library entry (a share ``flip_rate`` of its sign pairs redrawn, as a
new recording of the same bird gives) every ``period_s`` for ``posts``
posts, and closes; a new session then opens in its slot.  Slots start
staggered over the first period: an open loop at ``sessions / period_s``
posts a second.  Checked: every answer's top track against its entry and
its age against the posts made, and for posts drawn from the seed the
served top list (tracks and scores) against the reference's exact top list
of the session's accumulated fingerprint over the whole library."""

from __future__ import annotations

import math
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench import gen, payloads, serve
from portbench.reference import match


class Driver:
    def __init__(self, run):
        self.run = run
        t = run.traffic
        self.n_rows = t["posts"] * t["post_rows"]
        lifetime = t["posts"] * t["period_s"]
        self.per_slot = math.ceil(run.seconds / lifetime) + 1
        self.records: list[dict] = []
        self._lib_planes = None

    def _instances(self, counts: np.ndarray, pos_w, neg_w):
        """Each session's entry and its posted planes ``[n_rows, pairs]``."""
        r, t = self.run, self.run.traffic
        n = t["sessions"] * self.per_slot
        pick = payloads.rng(r.seed, 51)
        self.entries = pick.choice(np.flatnonzero(counts >= self.n_rows), n, replace=False)
        idx = torch.from_numpy(self.entries).to(pos_w.device)
        cls = (match.unpack(pos_w[idx, :self.n_rows], r.geom.pairs).cpu().numpy()
               + 2 * match.unpack(neg_w[idx, :self.n_rows], r.geom.pairs).cpu().numpy())
        redraw = pick.random(cls.shape) < t["flip_rate"]
        cls = np.where(redraw, pick.integers(0, 3, cls.shape), cls)
        self.q_pos, self.q_neg = (cls == 1).astype(np.uint8), (cls == 2).astype(np.uint8)

    def setup(self) -> None:
        from lbaudiodetective_torch.config import FingerprintConfig
        from lbaudiodetective_torch.models.library import FingerprintLibrary
        from lbaudiodetective_torch.serving import IdentificationService

        r, t = self.run, self.run.traffic
        self.words = gen.library(r.seed, r.config, r.device)
        self.lib_host = tuple(t.cpu() for t in self.words)
        self._instances(self.lib_host[2].numpy(), *self.words[:2])
        rows = t["post_rows"]
        texts = [[payloads.planes_text(self.q_pos[j, k:k + rows], self.q_neg[j, k:k + rows])
                  for k in range(0, self.n_rows, rows)] for j in range(len(self.entries))]
        if r.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(r.device)
        svc = r.config["service"]
        cfg = FingerprintConfig(**r.config["geometry"])
        self.library = FingerprintLibrary(*self.words, r.geom.pairs, cfg)
        del self.words
        self.service = IdentificationService(
            self.library, [f"track_{i}" for i in range(len(self.library))], cfg,
            top_k=svc["top_k"], max_sessions=svc["max_sessions"], stream_cap=svc["stream_cap"],
            stream_library_max=svc["stream_library_max"], stream_pool=svc["stream_pool"],
            stream_flush_window_s=svc["stream_flush_window_s"], device=r.device)
        self.server = serve.Server(self.service)
        self._warm(texts)
        self.client = serve.Client(
            {"kind": "posts", "sessions": t["sessions"], "period_s": t["period_s"],
             "seconds": r.seconds, "texts": texts}, r.work_dir)
        self.client.ready()

    def _warm(self, texts) -> None:
        """Every slot opens a session, all post their texts together post
        by post (every age a fold sees), and close."""
        from portbench import client

        addr = self.server.addr
        n = self.run.traffic["sessions"]
        with ThreadPoolExecutor(n) as pool:
            sids = list(pool.map(lambda _: client.call(addr, "POST", "/stream/open")[1]["session"],
                                 range(n)))
            for k in range(len(texts[0])):
                list(pool.map(lambda s: client.call(addr, "POST", f"/stream/{s[0]}",
                                                    texts[s[1]][k].encode("ascii")),
                              zip(sids, range(n))))
            list(pool.map(lambda s: client.call(addr, "POST", f"/stream/{s}/close"), sids))

    def wrap(self, tracer) -> None:
        """No public call of the program lies between the HTTP handler and
        the session pool; the traced run reads the device alone."""

    def window(self, seconds: float) -> None:
        self.client.go(self.server.addr)
        self.records = self.client.wait()
        print(f"portbench: {serve.summary(self.records, seconds)}", file=sys.stderr, flush=True)

    def end_to_end(self) -> dict:
        return {"post_p95_ms": min(serve.p95_ms(self.records), 1e9)}

    def counts(self) -> tuple[int, int]:
        return len(self.records), sum(r["status"] != 200 for r in self.records)

    def counters(self) -> dict:
        return {"posts": len(self.records)}

    def release(self) -> None:
        self.server.stop()
        del self.service, self.library
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def _scores(self, planes: list[tuple[np.ndarray, np.ndarray]],
                dtype=torch.float64) -> torch.Tensor:
        """``[len(planes), L]`` reference scores of accumulated fingerprints
        (``[n, pairs]`` pos and neg planes) over the whole library."""
        r, dev = self.run, self.run.device
        if self._lib_planes is None:
            pairs = r.geom.pairs
            self._lib_planes = (match.unpack(self.lib_host[0].to(dev), pairs),
                                match.unpack(self.lib_host[1].to(dev), pairs),
                                self.lib_host[2].to(dev))
        n_max = max(p.shape[0] for p, _ in planes)
        q_pos = torch.zeros((len(planes), n_max, r.geom.pairs), dtype=torch.uint8)
        q_neg = torch.zeros_like(q_pos)
        for j, (p, q) in enumerate(planes):
            q_pos[j, :p.shape[0]] = torch.from_numpy(p)
            q_neg[j, :q.shape[0]] = torch.from_numpy(q)
        nq = torch.tensor([p.shape[0] for p, _ in planes])
        return match.scores(q_pos.to(dev), q_neg.to(dev), nq, *self._lib_planes,
                            match.mask_pairs(r.geom.pairs, 0, r.geom.subfingerprint_length),
                            dtype=dtype).cpu()

    def control(self):
        """Put the reference's scores in bfloat16 in the place of the
        session pool's answers: each session's posts are kept as they are
        queued, and after a flush every session that posted since the last
        gets the top list of its accumulated fingerprint's bfloat16 scores
        over the whole library.  The pool still folds, so each answer's age
        is its own.  Returns what puts the program back."""
        from lbaudiodetective_torch.streaming.incremental import StreamSessionPool

        orig = {n: getattr(StreamSessionPool, n) for n in ("open", "post", "close", "top_k")}
        slots: dict[str, int] = {}
        posted: dict[str, list] = {}
        fresh: set[str] = set()

        def open_(pool, sid):
            slots[sid], posted[sid] = orig["open"](pool, sid), []
            return slots[sid]

        def post(pool, sid, pos, neg):
            orig["post"](pool, sid, pos, neg)
            if pos.shape[0]:
                posted[sid].append((np.asarray(pos, np.uint8), np.asarray(neg, np.uint8)))
                fresh.add(sid)

        def close(pool, sid):
            orig["close"](pool, sid)
            slots.pop(sid, None)
            posted.pop(sid, None)
            fresh.discard(sid)

        def top_k(pool, k):
            sc, ix = np.zeros((pool.slots, k)), np.zeros((pool.slots, k), np.int64)
            sids = sorted(fresh)
            fresh.clear()
            if sids:
                low = self._scores([tuple(np.concatenate(x) for x in zip(*posted[sid]))
                                    for sid in sids], dtype=torch.bfloat16)
                top = torch.sort(low, dim=1, descending=True, stable=True)
                for j, sid in enumerate(sids):
                    sc[slots[sid]] = top.values[j, :k].numpy()
                    ix[slots[sid]] = top.indices[j, :k].numpy()
            return sc, ix

        for name, f in (("open", open_), ("post", post), ("close", close), ("top_k", top_k)):
            setattr(StreamSessionPool, name, f)

        def restore():
            for name, f in orig.items():
                setattr(StreamSessionPool, name, f)

        return restore

    def check(self) -> list[tuple[str, float, float]]:
        r, t = self.run, self.run.traffic
        lim, rows, k_top = t["limits"], t["post_rows"], self.run.config["service"]["top_k"]
        failed = sum(rec["status"] != 200 for rec in self.records)
        misses = 0
        for rec in self.records:
            ans = rec["answer"] or {}
            misses += (rec["status"] != 200
                       or ans.get("track") != f"track_{self.entries[rec['instance']]}"
                       or ans.get("n") != rows * (rec["post"] + 1))
        ok = [rec for rec in self.records if rec["status"] == 200]
        pick = payloads.rng(r.seed, 52).choice(len(ok), min(t["checked"], len(ok)), replace=False)
        recs = [ok[j] for j in pick]
        ref = self._scores([(self.q_pos[rec["instance"], :rows * (rec["post"] + 1)],
                             self.q_neg[rec["instance"], :rows * (rec["post"] + 1)]) for rec in recs])
        best = torch.sort(ref, dim=1, descending=True).values[:, :k_top]
        gap = 0.0
        for j, rec in enumerate(recs):
            top = (rec["answer"] or {}).get("top") or []
            if len(top) != k_top:
                gap = max(gap, 1.0)
                continue
            idx = torch.tensor([int(e["track"].split("_")[1]) for e in top])
            served = torch.tensor([e["score"] for e in top], dtype=torch.float64)
            gap = max(gap, float((served - ref[j, idx]).abs().max()),
                      float((served - best[j]).abs().max()))
        return [("failed", float(failed), 0.0), ("top1_misses", float(misses), lim["top1_misses"]),
                ("top_gap", gap, lim["top_gap"])]
