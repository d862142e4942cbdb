"""ShardedFingerprintLibrary: a FingerprintLibrary split over a mesh's
``"library"`` slots (port of the JAX package's
``parallel/sharded_library.py``).

The packed planes split over the library slots (views of the library's own
words where a slot shares its device; the entry axis zero-padded to a
multiple of the slot count, with count 0), queries are replicated, and
every slot matches its resident shard in place with the packed matcher
(the match kernel on CUDA).  Duck-type compatible with
:class:`~lbaudiodetective_torch.models.library.FingerprintLibrary` for the
serving edge (``len``, ``match``, ``match_many``, ``identify``, ``search``,
``search_many``, ``device``, ``pos_words``), so
:class:`~lbaudiodetective_torch.serving.IdentificationService`, the
incremental matcher and the streaming identifier take one unchanged.
Scores equal the single-device library's bit for bit.  Every slot must be
in this process.
"""

from __future__ import annotations

import json

import numpy as np
import torch
import torch.nn.functional as F

from lbaudiodetective_torch.models.fingerprint import Fingerprint
from lbaudiodetective_torch.models.library import FingerprintLibrary, stack_query_planes
from lbaudiodetective_torch.ops.match_packed import (pack_bits_device,
                                                     phase_strided_query_planes)
from lbaudiodetective_torch.parallel.mesh import Mesh, shard, unshard
from lbaudiodetective_torch.parallel.sharded_packed import (
    match_many_library_sharded_packed, search_many_library_sharded_packed)
from lbaudiodetective_torch.utils import serialize


class ShardedFingerprintLibrary:
    """``library`` with its entry axis split over ``mesh``'s ``"library"``
    slots.  ``pos_words``, ``neg_words`` and ``counts`` are the inner
    library's (a checkpoint key hashes them); ``pos_shards``,
    ``neg_shards`` and ``count_shards`` the padded per-slot pieces.
    ``device`` is the first slot's."""

    def __init__(self, library: FingerprintLibrary, mesh: Mesh):
        slots = mesh.require_local("library", "ShardedFingerprintLibrary")
        self.inner = library
        self.mesh = mesh
        self.config = library.config
        self.pairs = library.pairs
        self.pos_words = library.pos_words
        self.neg_words = library.neg_words
        self.counts = library.counts
        self.device = slots[0].device
        self._l = len(library)
        self.pos_shards = shard(library.pos_words, mesh, "library")
        self.neg_shards = shard(library.neg_words, mesh, "library")
        self.count_shards = shard(library.counts, mesh, "library")
        self._coarse_cache: dict = {}

    def __len__(self) -> int:
        return self._l

    @property
    def n_padded(self) -> int:
        """Entries over every shard, the zero-count padding included."""
        return sum(int(c.shape[0]) for c in self.count_shards)

    # -- persistence (the restart path) -------------------------------------

    def save_sharded(self, dir_path: str, n_shards: int | None = None) -> None:
        """Persist in ``utils.serialize``'s sharded format (by default one
        shard file a library slot); both packages read it."""
        serialize.save_library_sharded_planes(
            dir_path, self.inner.pos_words.cpu().numpy().view(np.uint32),
            self.inner.neg_words.cpu().numpy().view(np.uint32),
            self.inner.counts.cpu().numpy(), self.pairs,
            self.config.subfingerprint_length, self.config,
            n_shards or self.mesh.shape["library"])

    @classmethod
    def load_sharded(cls, dir_path: str, mesh: Mesh,
                     config=None) -> "ShardedFingerprintLibrary":
        """Re-attach an on-disk sharded library to a mesh (any shard count:
        the planes are joined, trimmed to the true entry count, placed on
        the first slot's device and split over the mesh's library axis).
        ``config`` arms the parameter-hash guard."""
        with open(f"{dir_path}/manifest.json") as f:
            manifest = json.load(f)
        parts = [serialize.load_library_shard(dir_path, s, config)[:3]
                 for s in range(manifest["n_shards"])]
        n = manifest["entries"]
        device = mesh.axis_slots("library")[0].device
        lib = FingerprintLibrary.from_arrays(
            np.concatenate([p[0] for p in parts])[:n], np.concatenate([p[1] for p in parts])[:n],
            np.concatenate([p[2] for p in parts])[:n], manifest["pairs"], config, device)
        return cls(lib, mesh)

    # -- internals ------------------------------------------------------------

    def _query_words(self, planes: np.ndarray) -> torch.Tensor:
        return pack_bits_device(torch.from_numpy(planes).to(self.device))

    def _coarse_shards(self, stride: int, chunk: int) -> tuple[list, list, list]:
        """Strided, contiguous per-slot coarse planes, each zero-padded to a
        multiple of the chunk the search will use; cached per (stride,
        chunk)."""
        key = (stride, chunk)
        if key not in self._coarse_cache:
            chunk = min(chunk, int(self.count_shards[0].shape[0]))
            out = ([], [], [])
            for p, n, c in zip(self.pos_shards, self.neg_shards, self.count_shards):
                pad = (-c.shape[0]) % chunk
                out[0].append(F.pad(p[:, ::stride], (0, 0, 0, 0, 0, pad)))
                out[1].append(F.pad(n[:, ::stride], (0, 0, 0, 0, 0, pad)))
                out[2].append(F.pad((c + stride - 1) // stride, (0, pad)))
            self._coarse_cache[key] = out
        return self._coarse_cache[key]

    # -- the FingerprintLibrary surface --------------------------------------

    def match(self, query: Fingerprint, comparison_range: int = 0) -> np.ndarray:
        """``[L]`` scores of a query against every entry, each shard matched
        on its slot."""
        return self.match_many([query], comparison_range)[0]

    def match_many(self, queries: list[Fingerprint],
                   comparison_range: int = 0) -> np.ndarray:
        """``[B, L]`` scores of B queries: one matcher call a slot for all of
        them.  A query is clamped to the entries' rows, as
        ``FingerprintLibrary.match_many`` clamps it."""
        if not queries:
            return np.zeros((0, self._l), np.float32)
        qp, qn, nq = stack_query_planes(queries, int(self.pos_words.shape[1]))
        scores = match_many_library_sharded_packed(
            self._query_words(qp), self._query_words(qn), nq, self.pos_shards,
            self.neg_shards, self.count_shards, self.pairs, self.mesh, comparison_range,
            self.config.subfingerprint_length)
        return unshard(scores, dim=1).cpu().numpy()[:, :self._l]

    def identify(self, query: Fingerprint, comparison_range: int = 0
                 ) -> tuple[int, float]:
        scores = self.match(query, comparison_range)
        best = int(np.argmax(scores))
        return best, float(scores[best])

    def search(self, query: Fingerprint, top_k: int = 5,
               comparison_range: int = 0, shortlist: int = 1024,
               coarse_range: int = 64, coarse_stride: int = 4,
               chunk: int = 65536, coarse_phases: int | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """Two-stage coarse -> exact search, each slot shortlisting and
        re-scoring its residents, merged on the host (the single-device
        search's recall property, a shard at a time)."""
        idx, sc = self.search_many([query], top_k, comparison_range, shortlist,
                                   coarse_range, coarse_stride, chunk, coarse_phases)
        return idx[0], sc[0]

    def search_many(self, queries: list[Fingerprint], top_k: int = 5,
                    comparison_range: int = 0, shortlist: int = 1024,
                    coarse_range: int = 64, coarse_stride: int = 4,
                    chunk: int = 65536, coarse_phases: int | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched :meth:`search`: ``(indices [B, top_k], scores [B,
        top_k])``, one search call a slot for every query.  Each slot is
        asked for ``top_k`` plus the padding's count, so dropping padded
        entries (count 0, score 0) never starves the global top-k."""
        if not queries:
            return (np.zeros((0, top_k), np.int64), np.zeros((0, top_k), np.float32))
        top_k = min(top_k, self._l)
        qp, qn, nq = stack_query_planes(queries, int(self.pos_words.shape[1]))
        qcp, qcn, nc = phase_strided_query_planes(qp, qn, nq, coarse_stride, coarse_phases)
        if coarse_stride <= 1:     # stride 1 would copy the whole library
            coarse = (self.pos_shards, self.neg_shards, self.count_shards)
        else:
            coarse = self._coarse_shards(coarse_stride, chunk)
        idx, sc = search_many_library_sharded_packed(
            self._query_words(qp), self._query_words(qn), nq, self._query_words(qcp),
            self._query_words(qcn), nc, self.pos_shards, self.neg_shards,
            self.count_shards, *coarse, self.pairs, self.mesh, comparison_range,
            self.config.subfingerprint_length, coarse_range, chunk, shortlist,
            top_k=top_k + self.n_padded - self._l)
        out_i = np.zeros((len(queries), top_k), np.int64)
        out_s = np.zeros((len(queries), top_k), np.float32)
        for i in range(len(queries)):
            real = idx[i] < self._l
            out_i[i] = idx[i][real][:top_k]
            out_s[i] = sc[i][real][:top_k]
        return out_i, out_s
