"""Offline enrollment: ``AudioDetective.process_decoded_batch`` on batches
of decoded clips, back to back (a closed loop).  The clips are brown noise
made on the device from the seed, a few distinct batches; the window runs
whole batches until ``--seconds`` have passed.  Checked: the fingerprints
of clips drawn from the seed among those the window produced, against the
reference's float64 extraction of the same samples."""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from portbench import gen, payloads
from portbench.reference import extract


class Driver:
    def __init__(self, run):
        self.run = run
        t = run.traffic
        self.batch = t["batch"]
        g = run.geom
        self.n_proc = int(t["clip_seconds"] * g.processing_sample_rate)
        self.file_frames = int(t["clip_seconds"] * g.file_sample_rate)
        self.n_sub = g.n_sub(self.file_frames, self.n_proc)
        self.kept: list[tuple[int, int, object]] = []    # (batch, clip, fingerprint)
        self.calls = 0
        self.elapsed = 0.0

    def setup(self) -> None:
        from lbaudiodetective_torch.config import FingerprintConfig
        from lbaudiodetective_torch.io.decode import DecodedAudio
        from lbaudiodetective_torch.models.detective import AudioDetective

        r, g = self.run, self.run.geom
        n = r.traffic["distinct_batches"]
        self.audio = gen.brown_noise(r.seed, 31, n * self.batch, self.n_proc, r.device).cpu().numpy()
        self.batches = [[DecodedAudio(self.audio[k * self.batch + i], g.processing_sample_rate,
                                      self.file_frames, g.file_sample_rate)
                         for i in range(self.batch)] for k in range(n)]
        self.det = AudioDetective(FingerprintConfig(**r.config["geometry"]), device=r.device)
        self.det.process_decoded_batch(self.batches[0])     # builds the kernels; one shape

    def wrap(self, tracer) -> None:
        from lbaudiodetective_torch.models.detective import AudioDetective

        g = self.run.geom

        def info(args, kwargs, out):
            clips = args[1]
            return {"clips": len(clips),
                    "n_sub": [g.n_sub(c.file_frames, c.proc_frames) for c in clips]}

        tracer.wrap(AudioDetective, "process_decoded_batch", info)

    def window(self, seconds: float) -> None:
        keep = self.run.traffic["kept_a_call"]
        t0 = time.perf_counter()
        while True:
            k = self.calls % len(self.batches)
            fps = self.det.process_decoded_batch(self.batches[k])
            for i in payloads.rng(self.run.seed, 32, self.calls).choice(self.batch, keep, replace=False):
                self.kept.append((k, int(i), fps[i] if i < len(fps) else None))
            self.calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.elapsed = time.perf_counter() - t0

    def end_to_end(self) -> dict:
        return {"clips_per_s": self.calls * self.batch / self.elapsed}

    def counts(self) -> tuple[int, int]:
        return self.calls, 0

    def counters(self) -> dict:
        return {"batches": self.calls}

    def release(self) -> None:
        del self.det
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def control(self):
        """Put the reference's extraction in TF32 in the place of
        ``process_decoded_batch`` (every clip of each call, in blocks of
        ``control_block``); returns what puts the program back."""
        from lbaudiodetective_torch.models.detective import AudioDetective

        r, orig = self.run, AudioDetective.process_decoded_batch

        def reference(det, clips):
            n_sub = {r.geom.n_sub(c.file_frames, c.proc_frames) for c in clips}
            assert len(n_sub) == 1, "the traffic's clips have one length"
            audio = torch.from_numpy(np.stack([c.samples for c in clips])).to(r.device)
            pos, neg = extract.fingerprints(audio, n_sub.pop(), r.geom, precision="tf32",
                                            block=r.traffic["control_block"])
            pos, neg = pos.cpu().numpy(), neg.cpu().numpy()
            return [types.SimpleNamespace(pos=pos[i], neg=neg[i]) for i in range(len(clips))]

        AudioDetective.process_decoded_batch = reference
        return lambda: setattr(AudioDetective, "process_decoded_batch", orig)

    def check(self) -> list[tuple[str, float, float]]:
        r = self.run
        pick = payloads.rng(r.seed, 33).choice(len(self.kept), min(r.traffic["checked"], len(self.kept)),
                                               replace=False)
        rows = [self.kept[j] for j in pick]
        audio = torch.from_numpy(np.stack([self.audio[k * self.batch + i] for k, i, _ in rows]))
        ref_pos, ref_neg = extract.fingerprints(audio.to(r.device), self.n_sub, r.geom)
        worst = 0.0
        for j, (_, _, fp) in enumerate(rows):
            if fp is None:
                worst = 1.0
                continue
            off = extract.pairs_off(torch.from_numpy(fp.pos)[None], torch.from_numpy(fp.neg)[None],
                                    ref_pos[j:j + 1].cpu(), ref_neg[j:j + 1].cpu())
            worst = max(worst, float(off[0]))
        return [("bits_off", worst, r.traffic["limits"]["bits_off"])]
