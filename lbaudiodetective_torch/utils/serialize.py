"""Canonical on-disk fingerprint format.

The reference only sketches serialization (a test-only string form,
LBAudioDetectiveTests.m:22-37); the essay's server stores fingerprints in a DB
(PDF §3.2.5).  Here fingerprints persist as ``.npz`` with packed uint32 planes
plus a parameter hash, so a library DB can be memory-mapped/sharded and a
loaded fingerprint refuses to match against one extracted under different
parameters.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

from lbaudiodetective_torch.config import FingerprintConfig
from lbaudiodetective_torch.models.fingerprint import Fingerprint

FORMAT_VERSION = 1


def config_params_hash(config: FingerprintConfig) -> str:
    payload = json.dumps({
        "processing_sample_rate": config.processing_sample_rate,
        "window_size": config.window_size,
        "analysis_stride": config.analysis_stride,
        "pitch_step_count": config.pitch_step_count,
        "rows_per_frame": config.rows_per_frame,
        "subfingerprint_length": config.subfingerprint_length,
        "min_frequency": config.min_frequency,
        "hop_domain": config.hop_domain,
        "file_sample_rate": config.file_sample_rate,
        "integer_hop": config.integer_hop,
    }, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def save_fingerprint(path: str, fp: Fingerprint, config: FingerprintConfig) -> None:
    pos_words, neg_words = fp.packed()
    np.savez_compressed(
        path,
        version=np.int32(FORMAT_VERSION),
        pos=pos_words, neg=neg_words,
        pairs=np.int32(fp.pairs),
        subfingerprint_length=np.int32(fp.subfingerprint_length),
        params_hash=np.bytes_(config_params_hash(config).encode()),
    )


def load_fingerprint(path: str, config: FingerprintConfig | None = None) -> Fingerprint:
    with np.load(path) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported fingerprint format version {int(z['version'])}")
        if config is not None:
            stored = bytes(z["params_hash"]).decode()
            if stored != config_params_hash(config):
                raise ValueError(
                    "fingerprint parameter hash mismatch: extracted under a "
                    f"different configuration ({stored})")
        return Fingerprint.from_packed(z["pos"], z["neg"], int(z["pairs"]),
                                       int(z["subfingerprint_length"]))


def _padded_planes(fps: list[Fingerprint], l_pad: int | None = None
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, int, int]:
    """Pack a fingerprint list into padded ``[L, S_max, words]`` planes.

    Returns (pos, neg, counts, pairs, s_max, words); ``l_pad`` pads the entry
    axis (trailing entries have count 0 and never match)."""
    if not fps:
        raise ValueError("empty library")
    pairs = fps[0].pairs
    s_max = max(f.num_subfingerprints for f in fps)
    packed = [f.packed() for f in fps]
    words = packed[0][0].shape[-1] if s_max else (pairs + 31) // 32
    l = l_pad if l_pad is not None else len(fps)
    pos = np.zeros((l, s_max, words), np.uint32)
    neg = np.zeros((l, s_max, words), np.uint32)
    counts = np.zeros(l, np.int32)
    for i, (p, n) in enumerate(packed):
        counts[i] = p.shape[0]
        pos[i, :p.shape[0]] = p
        neg[i, :n.shape[0]] = n
    return pos, neg, counts, pairs, int(s_max), int(words)


def save_library(path: str, fps: list[Fingerprint], config: FingerprintConfig) -> None:
    """Padded library DB: one file, ``[L, S_max, words]`` planes + counts."""
    pos, neg, counts, pairs, _, _ = _padded_planes(fps)
    np.savez_compressed(path, version=np.int32(FORMAT_VERSION), pos=pos, neg=neg,
                        counts=counts, pairs=np.int32(pairs),
                        subfingerprint_length=np.int32(fps[0].subfingerprint_length),
                        params_hash=np.bytes_(config_params_hash(config).encode()))


def load_library(path: str, config: FingerprintConfig | None = None
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Returns (pos_words [L,S,W], neg_words, counts [L], pairs)."""
    with np.load(path) as z:
        if config is not None:
            stored = bytes(z["params_hash"]).decode()
            if stored != config_params_hash(config):
                raise ValueError("library parameter hash mismatch")
        return z["pos"], z["neg"], z["counts"], int(z["pairs"])


# --------------------------------------------------------------------------- #
# Sharded, memory-mapped library DB (SURVEY §5 checkpoint/resume: "library DB
# = memory-mapped shards; resumable pod jobs reload shard-local DB").  Each
# shard is plain uncompressed .npy (np.load(mmap_mode="r") maps it without
# copying), so a restarted slice re-attaches only its own shard — the analog
# of the essay server's per-bird DB (PDF §3.2.5), laid out for the mesh's
# "library" axis instead of a SQL table.
# --------------------------------------------------------------------------- #


def save_library_sharded(dir_path: str, fps: list[Fingerprint],
                         config: FingerprintConfig, n_shards: int) -> None:
    """Split a padded library into ``n_shards`` equal mmap-able shards.

    Entries are padded so every shard holds ``ceil(L / n_shards)`` entries
    (trailing entries have count 0 and never match), keeping per-shard shapes
    identical — the static-shape requirement of the sharded matcher.
    """
    import os

    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if not fps:
        raise ValueError("empty library")
    os.makedirs(dir_path, exist_ok=True)
    per = -(-len(fps) // n_shards)
    pos, neg, counts, pairs, s_max, words = _padded_planes(
        fps, l_pad=per * n_shards)
    manifest = {
        "version": FORMAT_VERSION, "n_shards": n_shards, "entries": len(fps),
        "entries_per_shard": per, "s_max": s_max, "words": words,
        "pairs": int(pairs),
        "subfingerprint_length": int(fps[0].subfingerprint_length),
        "params_hash": config_params_hash(config),
    }
    with open(f"{dir_path}/manifest.json", "w") as f:
        json.dump(manifest, f)
    for s in range(n_shards):
        sl = slice(s * per, (s + 1) * per)
        np.save(f"{dir_path}/shard_{s:04d}_pos.npy", pos[sl])
        np.save(f"{dir_path}/shard_{s:04d}_neg.npy", neg[sl])
        np.save(f"{dir_path}/shard_{s:04d}_counts.npy", counts[sl])


def save_library_sharded_planes(dir_path: str, pos_words: np.ndarray,
                                neg_words: np.ndarray, counts: np.ndarray,
                                pairs: int, subfingerprint_length: int,
                                config: FingerprintConfig,
                                n_shards: int) -> None:
    """:func:`save_library_sharded` for an already-packed library (the
    device-resident form — e.g. persisting a served
    ShardedFingerprintLibrary without round-tripping through Fingerprint
    objects).  Same on-disk format / manifest; entries pad to equal
    shard sizes with count-0 tails."""
    import os

    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    l = int(pos_words.shape[0])
    if l == 0:
        raise ValueError("empty library")
    os.makedirs(dir_path, exist_ok=True)
    per = -(-l // n_shards)
    pad = per * n_shards - l
    pos = np.pad(np.asarray(pos_words), ((0, pad), (0, 0), (0, 0)))
    neg = np.pad(np.asarray(neg_words), ((0, pad), (0, 0), (0, 0)))
    cnt = np.pad(np.asarray(counts), (0, pad))
    manifest = {
        "version": FORMAT_VERSION, "n_shards": n_shards, "entries": l,
        "entries_per_shard": per, "s_max": int(pos.shape[1]),
        "words": int(pos.shape[2]), "pairs": int(pairs),
        "subfingerprint_length": int(subfingerprint_length),
        "params_hash": config_params_hash(config),
    }
    with open(f"{dir_path}/manifest.json", "w") as f:
        json.dump(manifest, f)
    for s in range(n_shards):
        sl = slice(s * per, (s + 1) * per)
        np.save(f"{dir_path}/shard_{s:04d}_pos.npy", pos[sl])
        np.save(f"{dir_path}/shard_{s:04d}_neg.npy", neg[sl])
        np.save(f"{dir_path}/shard_{s:04d}_counts.npy", cnt[sl])


def load_library_shard(dir_path: str, shard: int,
                       config: FingerprintConfig | None = None,
                       mmap: bool = True
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
    """Re-attach one shard (the restart path of a slice-local matcher).

    Returns (pos_words, neg_words, counts, manifest); arrays are read-only
    memory maps when ``mmap`` (no host copy until touched).
    """
    with open(f"{dir_path}/manifest.json") as f:
        manifest = json.load(f)
    if manifest["version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported library format version {manifest['version']}")
    if config is not None and manifest["params_hash"] != config_params_hash(config):
        raise ValueError("library parameter hash mismatch")
    if not 0 <= shard < manifest["n_shards"]:
        raise ValueError(f"shard {shard} out of range")
    mode = "r" if mmap else None
    pos = np.load(f"{dir_path}/shard_{shard:04d}_pos.npy", mmap_mode=mode)
    neg = np.load(f"{dir_path}/shard_{shard:04d}_neg.npy", mmap_mode=mode)
    counts = np.load(f"{dir_path}/shard_{shard:04d}_counts.npy", mmap_mode=mode)
    return pos, neg, counts, manifest
