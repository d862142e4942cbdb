"""One tiny step of every sharded path on an n-slot mesh (the counterpart of
the JAX package's ``__graft_entry__.py::dryrun_multichip``).

    python -m lbaudiodetective_torch.parallel.dryrun [n_slots] [device]

runs, on ``n_slots`` slots of ``device`` (the card by default; ``cpu``
too): data-parallel extraction, the library-sharded match on unpacked and
packed planes, ring all-pairs, ring dedup, the sharded two-stage search,
the sharded library with its incremental matcher, the time-sharded long
match and the device-split pipeline.  Each result is checked against a
self match; a failed check raises.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from lbaudiodetective_torch.config import FingerprintConfig
from lbaudiodetective_torch.device import DEFAULT_DEVICE, resolve_device
from lbaudiodetective_torch.ops.extract import required_padded_length


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device: torch.device | str = DEFAULT_DEVICE) -> None:
    """Data-parallel extraction, library-sharded matching and the ring
    paths on a ``(data, library)`` mesh of ``n_devices`` slots on
    ``device``."""
    from lbaudiodetective_torch.models.fingerprint import Fingerprint
    from lbaudiodetective_torch.models.library import FingerprintLibrary
    from lbaudiodetective_torch.ops.match_packed import (pack_bits_device,
                                                         phase_strided_query_planes)
    from lbaudiodetective_torch.parallel import (
        ShardedFingerprintLibrary, extract_data_parallel, make_mesh, match_library_sharded,
        match_library_sharded_packed, match_long_time_sharded, ring_all_pairs_scores,
        ring_dedup_topk_packed)
    from lbaudiodetective_torch.parallel.mesh import unshard
    from lbaudiodetective_torch.parallel.pipeline import DeviceSplitPipeline
    from lbaudiodetective_torch.parallel.sharded_packed import search_library_sharded_packed
    from lbaudiodetective_torch.streaming.incremental import IncrementalLibraryMatcher

    dev = resolve_device(device, "dryrun_multichip")
    config = FingerprintConfig()
    n_rows = config.rows_per_frame                        # 1 subfingerprint a clip
    rng = np.random.default_rng(0)
    mesh = make_mesh(n_devices, devices=[dev] * n_devices)
    data_ax = mesh.shape["data"]
    batch = max(8, data_ax) + (-max(8, data_ax)) % data_ax
    audio = torch.from_numpy(rng.standard_normal(
        (batch, required_padded_length(config, n_rows))).astype(np.float32) * 0.1).to(dev)
    n_sub = torch.ones(batch, dtype=torch.int32, device=dev)

    # 1) Data-parallel extraction.
    pos, neg = (unshard(x) for x in extract_data_parallel(audio, n_sub, config, n_rows, mesh))

    # 2) Library-sharded match, the library being the extracted batch.
    scores = unshard(match_library_sharded(pos[0], neg[0], 1, pos, neg, n_sub, mesh, 0,
                                           config.subfingerprint_length))
    _check(abs(float(scores[0]) - 1.0) < 1e-5, f"sharded self-match {float(scores[0])}")

    # 3) Ring all-pairs over the library axis: every diagonal is a self match.
    ring = unshard(ring_all_pairs_scores(pos, neg, n_sub, mesh))
    _check(torch.allclose(ring.diagonal(), torch.ones(batch, device=dev), atol=1e-5),
           "ring all-pairs diagonal")

    # 3b) The packed paths: match and ring dedup.
    pairs = config.num_wavelet_pairs
    pos_w, neg_w = pack_bits_device(pos), pack_bits_device(neg)
    packed = unshard(match_library_sharded_packed(pos_w[0], neg_w[0], 1, pos_w, neg_w, n_sub,
                                                  pairs, mesh))
    _check(torch.equal(packed, scores), "packed and unpacked sharded scores differ")
    dd_scores, dd_idx = (unshard(x) for x in ring_dedup_topk_packed(pos_w, neg_w, n_sub,
                                                                      pairs, mesh, k=2))
    _check(bool((dd_idx != torch.arange(batch, device=dev)[:, None]).all()),
           "ring dedup kept a self match")

    # 3c) Sharded two-stage search.
    stride = 2
    qcp, qcn, ncp = phase_strided_query_planes(pos[0].cpu().numpy(), neg[0].cpu().numpy(), 1,
                                               stride)
    s_idx, s_scores = search_library_sharded_packed(
        pos_w[0], neg_w[0], 1, pack_bits_device(torch.from_numpy(qcp).to(dev)),
        pack_bits_device(torch.from_numpy(qcn).to(dev)), ncp, pos_w, neg_w, n_sub,
        pos_w[:, ::stride].contiguous(), neg_w[:, ::stride].contiguous(),
        torch.clamp(n_sub // stride, min=1), pairs, mesh, shortlist=2, top_k=1)
    _check(int(s_idx[0]) == 0 and abs(float(s_scores[0]) - 1.0) < 1e-5,
           f"sharded search self-match {s_idx[0]} {s_scores[0]}")

    # 3d) The sharded library (5 entries: the library axis pads) and its
    # incremental matcher.
    fps = [Fingerprint.from_planes(pos[i, :1].cpu().numpy(), neg[i, :1].cpu().numpy(),
                                   config.subfingerprint_length) for i in range(5)]
    slib = ShardedFingerprintLibrary(FingerprintLibrary.from_fingerprints(fps, config, dev),
                                     mesh)
    sl_scores = slib.match(fps[0])
    _check(sl_scores.shape == (5,) and abs(sl_scores[0] - 1.0) < 1e-5,
           f"sharded library self-match {sl_scores}")
    sl_idx, sl_sc = slib.search(fps[0], top_k=2, coarse_stride=1, shortlist=1)
    _check(int(sl_idx[0]) == 0 and abs(float(sl_sc[0]) - 1.0) < 1e-5,
           f"sharded library search {sl_idx} {sl_sc}")
    inc = IncrementalLibraryMatcher(slib, batch=2, n_cap=1, config=config, device=dev)
    q_pos = np.stack([fps[0].pos[:1], fps[1].pos[:1]])
    q_neg = np.stack([fps[0].neg[:1], fps[1].neg[:1]])
    inc.update(q_pos, q_neg)
    inc_scores = inc.scores()
    _check(inc_scores.shape == (2, 5) and abs(inc_scores[0, 0] - 1.0) < 1e-5
           and abs(inc_scores[1, 1] - 1.0) < 1e-5, f"sharded incremental {inc_scores[:, :2]}")
    inc.update(q_pos, q_neg)                             # grows past n_cap=1
    _, tk_ix = inc.top_k(1)
    _check(inc.n_cap >= 2 and int(tk_ix[0, 0]) == 0 and int(tk_ix[1, 0]) == 1,
           f"sharded grown top-k {tk_ix[:, 0]}")

    # 4) Long match with fp1's time axis over "data".
    lp = (rng.random((64 * data_ax, pairs)) < 0.4).astype(np.uint8)
    ln = ((rng.random((64 * data_ax, pairs)) < 0.4) & (lp == 0)).astype(np.uint8)
    long_score = match_long_time_sharded(lp, ln, lp.shape[0], lp[5:21], ln[5:21], 16, mesh,
                                         axis="data")
    _check(0.99 < long_score <= 1.0 + 1e-6, f"long self-match {long_score}")

    # 5) Device-split pipeline: extraction on one half of the slots,
    # matching on the other.
    if n_devices >= 2 and batch % (n_devices - n_devices // 2) == 0:
        slots = list(mesh.slots.flat)
        pipe = DeviceSplitPipeline(pos.cpu().numpy(), neg.cpu().numpy(), n_sub.cpu().numpy(),
                                   slots[:n_devices // 2], slots[n_devices // 2:], config)
        audio_np = audio.cpu().numpy()
        ones = np.ones(batch, np.int64)
        _check(pipe.submit(audio_np, ones) is None, "pipeline returned a batch early")
        out = pipe.drain()
        _check(out.shape == (batch, batch) and abs(float(out[0, 0]) - 1.0) < 1e-5,
               f"device-split pipeline self-match {out[0, 0]}")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
                     sys.argv[2] if len(sys.argv) > 2 else DEFAULT_DEVICE)
    print("dryrun_multichip: ok")
