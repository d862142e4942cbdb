"""The port's FingerprintLibrary vs the JAX package's, on the committed
fingerprints of the bird corpus (``tests/_cache/jaxfp_*``, read only) and
seeded synthetic ones.

Each package gets its own configs and fingerprints, carried across as
numpy planes (``jax_fp``, ``jax_config``).  Tolerances: match scores within
1e-6 (f32 sums; in practice they are equal), search indices equal and scores
within 1e-7; npz files and arrays identical in both directions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_tpu.models.library import FingerprintLibrary as JaxLibrary  # noqa: E402
from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.models.fingerprint import Fingerprint, FingerprintBuilder  # noqa: E402
from lbaudiodetective_torch.models.library import FingerprintLibrary  # noqa: E402
from tests._torch_common import jax_config, jax_fp, synthetic_library  # noqa: E402
from tests.conftest import BIRDS, CACHE  # noqa: E402

FIXTURE_KEY = "46bdaf65-4920ed19"
# The shipped coarse pass (stride 4, range 64, all phases) at the shipped
# defaults' selectivity (1024 of 2048 in tests/test_search_recall.py).
HALF = dict(shortlist=256, coarse_range=64, coarse_stride=4)


def committed_fp(name: str) -> Fingerprint:
    z = np.load(CACHE / f"jaxfp_{FIXTURE_KEY}_{name}.npz")
    return Fingerprint(z["pos"], z["neg"])


def jax_library(fps, cfg=None):
    """The JAX package's library of the same entries."""
    return JaxLibrary.from_fingerprints([jax_fp(f) for f in fps],
                                        jax_config(cfg or FingerprintConfig()))


def make_library(cls, fps, cfg=None):
    """A library of ``cls`` (the port's or the JAX package's) of ``fps``."""
    if cls is JaxLibrary:
        return jax_library(fps, cfg)
    return FingerprintLibrary.from_fingerprints(fps, cfg or FingerprintConfig(), device="cpu")


def query_for(cls, fp):
    return jax_fp(fp) if cls is JaxLibrary else fp


def random_fp(rng, n, pairs=100):
    sign = rng.random((n, pairs)) < 0.5
    nz = rng.random((n, pairs)) > 0.03
    return Fingerprint((sign & nz).astype(np.uint8), (~sign & nz).astype(np.uint8))


@pytest.fixture(scope="module")
def planted():
    """tests/test_search_recall.py's plant without the corpus audio: the
    10 committed bird fingerprints + seeded distractors (512 entries),
    queried by the committed _eql/_blu2/_rec fingerprints, offset crops and
    5 % bit flips, each labelled with its true entry; with the port's full
    scan of every query."""
    rng = np.random.default_rng(17)
    birds = [committed_fp(b) for b in BIRDS]
    lens = [f.num_subfingerprints for f in birds]
    fps = birds + [random_fp(rng, int(rng.integers(min(lens), max(lens) + 1)))
                   for _ in range(512 - len(birds))]
    queries = [(b + s, t, committed_fp(b + s))
               for s in ("_eql", "_blu2", "_rec") for t, b in enumerate(BIRDS)]
    for t in (0, 4):
        for k in (1, 2, 3):
            queries.append((f"{BIRDS[t]}_crop{k}", t,
                            Fingerprint(birds[t].pos[k:], birds[t].neg[k:])))
    for t in (2, 7):
        flips = rng.random(birds[t].pos.shape) < 0.05
        pos = np.where(flips, 1 - birds[t].pos, birds[t].pos).astype(np.uint8)
        queries.append((f"{BIRDS[t]}_flip5", t,
                        Fingerprint(pos, (birds[t].neg * (1 - pos)).astype(np.uint8))))
    lib = FingerprintLibrary.from_fingerprints(fps, FingerprintConfig(), device="cpu")
    return (lib, jax_library(fps), queries, lib.match_many([q for _, _, q in queries]))


def test_state_equals_jax_library(planted):
    lib, jlib, _, _ = planted
    np.testing.assert_array_equal(lib.pos_words.numpy().view(np.uint32),
                                  np.asarray(jlib.pos_words))
    np.testing.assert_array_equal(lib.neg_words.numpy().view(np.uint32),
                                  np.asarray(jlib.neg_words))
    np.testing.assert_array_equal(lib.counts.numpy(), np.asarray(jlib.counts))
    carried = FingerprintLibrary.from_arrays(
        np.asarray(jlib.pos_words), np.asarray(jlib.neg_words), np.asarray(jlib.counts),
        jlib.pairs, FingerprintConfig(), device="cpu")
    assert torch.equal(carried.pos_words, lib.pos_words) and len(carried) == 512
    assert lib.device == torch.device("cpu")


def test_match_and_match_many_equal_jax(planted):
    lib, jlib, queries, got = planted
    qs = [q for _, _, q in queries]
    assert got.shape == (len(qs), 512)
    jqs = [jax_fp(q) for q in qs]
    np.testing.assert_allclose(got, np.asarray(jlib.match_many(jqs)), rtol=0, atol=1e-6)
    for i in (0, 12, 31):
        single = lib.match(qs[i], chunk=200)         # chunks do not change a score
        np.testing.assert_array_equal(single, got[i])
        np.testing.assert_allclose(single, jlib.match(jqs[i]), rtol=0, atol=1e-6)
        assert lib.identify(qs[i]) == (int(np.argmax(got[i])), float(got[i].max()))
    assert lib.match_many([]).shape == (0, 512)


def test_search_many_equals_jax_and_finds_planted(planted):
    """Indices equal to the JAX package's, scores within 1e-7 and equal to
    the full scan's at those indices; every query that brute force
    identifies is found (zero misses)."""
    lib, jlib, queries, brute = planted
    qs = [q for _, _, q in queries]
    idx, scores = lib.search_many(qs, top_k=5, **HALF)
    jidx, jscores = jlib.search_many([jax_fp(q) for q in qs], top_k=5, **HALF)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=1e-7)
    identifiable = 0
    for i, (label, true_idx, _) in enumerate(queries):
        np.testing.assert_array_equal(scores[i], brute[i][idx[i]], err_msg=label)
        if int(np.argmax(brute[i])) == true_idx:
            identifiable += 1
            assert int(idx[i][0]) == true_idx, label
    assert identifiable >= 20
    for i in (3, 30):                                 # single-query search
        one = lib.search(qs[i], top_k=3, shortlist=32)
        jone = jlib.search(jax_fp(qs[i]), top_k=3, shortlist=32)
        np.testing.assert_array_equal(one[0], jone[0])
        np.testing.assert_allclose(one[1], jone[1], rtol=0, atol=1e-7)


def test_search_synthetic_recall_equals_jax():
    """tests/test_library.py's 64-entry perturbed-variant library, chunked
    coarse pass (chunk 16) at shortlist 8."""
    base_pos, base_neg, lib_pos, lib_neg = synthetic_library()
    fps = [Fingerprint(p, n) for p, n in zip(lib_pos, lib_neg)]
    query = Fingerprint(base_pos, base_neg)
    lib = FingerprintLibrary.from_fingerprints(fps, device="cpu")
    jlib = jax_library(fps)
    brute = lib.match(query)
    assert int(np.argmax(brute)) == 11
    idx, scores = lib.search(query, top_k=4, shortlist=8, chunk=16)
    jidx, jscores = jlib.search(jax_fp(query), top_k=4, shortlist=8, chunk=16)
    assert idx[0] == 11
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=1e-7)
    assert scores[0] == brute[11]


def test_search_ties_equal_jax():
    """Duplicate entries tie in both stages; both packages rank them by
    ascending index."""
    rng = np.random.default_rng(21)
    bases = [random_fp(rng, 30) for _ in range(5)]
    fps = [bases[i % 5] for i in range(40)]
    query = Fingerprint(bases[2].pos[2:], bases[2].neg[2:])
    lib = FingerprintLibrary.from_fingerprints(fps, device="cpu")
    jlib = jax_library(fps)
    for kw in (dict(shortlist=12, chunk=16), dict(shortlist=64)):
        idx, scores = lib.search(query, top_k=10, **kw)
        jidx, jscores = jlib.search(jax_fp(query), top_k=10, **kw)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_allclose(scores, jscores, rtol=0, atol=1e-7)
        assert list(idx[:8]) == [2, 7, 12, 17, 22, 27, 32, 37]


def test_small_library_search_is_exact_sort():
    rng = np.random.default_rng(22)
    fps = [random_fp(rng, int(n)) for n in rng.integers(10, 40, size=9)]
    query = Fingerprint(fps[4].pos[1:], fps[4].neg[1:])
    for cls in (FingerprintLibrary, JaxLibrary):
        lib = make_library(cls, fps)
        brute = np.asarray(lib.match(query_for(cls, query)))
        idx, scores = lib.search(query_for(cls, query), top_k=len(lib), shortlist=len(lib))
        np.testing.assert_array_equal(idx, np.argsort(-brute, kind="stable"))
        np.testing.assert_array_equal(scores, brute[idx])
        assert idx[0] == 4


def test_extend_equals_fresh():
    """In both packages: ``extend`` equals a library built at once, across a
    re-pad to a longer bucket; ``extend([])`` is the library itself."""
    rng = np.random.default_rng(23)
    fps = [random_fp(rng, n) for n in (12, 20, 9, 45, 30)]
    query = Fingerprint(fps[3].pos[2:30], fps[3].neg[2:30])
    for cls in (FingerprintLibrary, JaxLibrary):
        base = make_library(cls, fps[:3])
        grown = base.extend([query_for(cls, f) for f in fps[3:]])
        fresh = make_library(cls, fps)
        assert len(grown) == len(fresh) == 5
        for a, b in ((grown.pos_words, fresh.pos_words), (grown.neg_words, fresh.neg_words),
                     (grown.counts, fresh.counts)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_allclose(np.asarray(grown.match(query_for(cls, query))),
                                   np.asarray(fresh.match(query_for(cls, query))),
                                   rtol=0, atol=1e-6)
        assert grown.extend([]) is grown
    with pytest.raises(ValueError, match="pair count"):
        FingerprintLibrary.from_fingerprints(fps, device="cpu").extend(
            [random_fp(rng, 5, pairs=64)])


def test_load_honours_stored_length(tmp_path):
    """A config-less load of a library built at subfingerprint_length 128
    (64 pairs, two words a row) adopts the stored length, in both packages
    and across them."""
    cfg = FingerprintConfig(subfingerprint_length=128)
    rng = np.random.default_rng(3)
    fps = []
    for _ in range(4):
        b = FingerprintBuilder(cfg.subfingerprint_length)
        for _ in range(6):
            b.add_subfingerprint(rng.integers(0, 2, 128).astype(bool))
        fps.append(b.freeze())
    lib = FingerprintLibrary.from_fingerprints(fps, cfg, device="cpu")
    assert lib.pos_words.shape[2] == 2
    lib.save(str(tmp_path / "short.npz"))
    jax_library(fps, cfg).save(str(tmp_path / "short_jax.npz"))
    for name in ("short.npz", "short_jax.npz"):
        for cls in (FingerprintLibrary, JaxLibrary):
            path = str(tmp_path / name)
            loaded = (cls.load(path, device="cpu") if cls is FingerprintLibrary
                      else cls.load(path))
            assert loaded.config.subfingerprint_length == 128
            np.testing.assert_allclose(np.asarray(loaded.match(query_for(cls, fps[1]))),
                                       lib.match(fps[1]), rtol=0, atol=1e-7)


def test_npz_interchange_both_ways(tmp_path):
    rng = np.random.default_rng(24)
    fps = [random_fp(rng, int(n)) for n in rng.integers(5, 50, size=6)]
    cfg = FingerprintConfig()
    lib = FingerprintLibrary.from_fingerprints(fps, cfg, device="cpu")
    jlib = jax_library(fps, cfg)
    lib.save(str(tmp_path / "port.npz"))
    jlib.save(str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    query = Fingerprint(fps[2].pos[3:], fps[2].neg[3:])
    from_jax = FingerprintLibrary.load(str(tmp_path / "jax.npz"), cfg, device="cpu")
    from_port = JaxLibrary.load(str(tmp_path / "port.npz"), jax_config(cfg))
    np.testing.assert_array_equal(from_jax.match(query), lib.match(query))
    np.testing.assert_allclose(np.asarray(from_port.match(jax_fp(query))), lib.match(query),
                               rtol=0, atol=1e-6)
    other = FingerprintConfig(analysis_stride=32)
    for cls, name in ((FingerprintLibrary, "jax.npz"), (FingerprintLibrary, "port.npz"),
                      (JaxLibrary, "port.npz")):
        with pytest.raises(ValueError, match="hash mismatch"):
            cls.load(str(tmp_path / name), jax_config(other) if cls is JaxLibrary else other)


def test_library_refuses_bad_state():
    words = np.zeros((3, 8, 4), np.uint32)
    with pytest.raises(TypeError):
        FingerprintLibrary.from_arrays(words.astype(np.int64), words, np.zeros(3), 100,
                                       device="cpu")
    with pytest.raises(ValueError, match="words per row"):
        FingerprintLibrary.from_arrays(words, words, np.zeros(3), 64, device="cpu")
    with pytest.raises(ValueError, match="counts"):
        FingerprintLibrary.from_arrays(words, words, np.array([0, 9, 1]), 100, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        FingerprintLibrary.from_fingerprints([], device="cpu")


def test_cuda_library_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    rng = np.random.default_rng(25)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FingerprintLibrary.from_fingerprints([random_fp(rng, 8)], device="cuda")
