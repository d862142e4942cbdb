"""The port's incremental library matcher and session pool
(``streaming/incremental.py``) vs the JAX package's on the CPU.

Bitwise: at every tick the running scores equal the JAX
``IncrementalLibraryMatcher``'s, the port's unpacked
``match_one_vs_many_padded`` on the accumulated planes and its packed
matcher (the match kernel's plain version); pooled slots equal
per-session matchers; growth past ``n_cap`` changes no bit.  A state saved
by either package restores in the other (the same npz, the same key)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_tpu.config import FingerprintConfig as JaxConfig  # noqa: E402
from lbaudiodetective_tpu.models.library import FingerprintLibrary as JaxLibrary  # noqa: E402
from lbaudiodetective_tpu.streaming import incremental as jax_inc  # noqa: E402
from lbaudiodetective_torch.models.fingerprint import Fingerprint  # noqa: E402
from lbaudiodetective_torch.models.library import FingerprintLibrary  # noqa: E402
from lbaudiodetective_torch.ops.match import match_one_vs_many_padded  # noqa: E402
from lbaudiodetective_torch.ops.match_packed import (  # noqa: E402
    match_one_vs_many_packed, pack_bits_device)
from lbaudiodetective_torch.streaming.incremental import (  # noqa: E402
    IncrementalLibraryMatcher, StreamSessionPool)
from tests._torch_common import jax_fp  # noqa: E402

PAIRS = 100


def _planes(rng, n):
    pos = (rng.random((n, PAIRS)) < 0.45).astype(np.uint8)
    neg = ((rng.random((n, PAIRS)) < 0.45) & (pos == 0)).astype(np.uint8)
    return pos, neg


def _libraries(fps):
    """The port's library on the CPU and the JAX package's of the same
    entries."""
    return (FingerprintLibrary.from_fingerprints(fps, device="cpu"),
            JaxLibrary.from_fingerprints([jax_fp(f) for f in fps], JaxConfig()))


def _full_scores(lib, qpos, qneg, n, comparison_range=0):
    """[B, L] scores of the port's unpacked matcher on the accumulated planes,
    one stream at a time."""
    from lbaudiodetective_torch.utils import packing

    lp = torch.from_numpy(packing.unpack_bits(lib.pos_words.numpy().view(np.uint32), PAIRS))
    ln = torch.from_numpy(packing.unpack_bits(lib.neg_words.numpy().view(np.uint32), PAIRS))
    return np.stack([match_one_vs_many_padded(
        torch.from_numpy(qpos[b, :n]), torch.from_numpy(qneg[b, :n]), torch.tensor(n),
        lp, ln, lib.counts, comparison_range).numpy() for b in range(qpos.shape[0])])


def _packed_scores(lib, qpos, qneg, n, comparison_range=0):
    """[B, L] scores of the port's packed matcher (the match kernel's plain
    version) on the accumulated planes.  ``FingerprintLibrary.match_many``
    would clamp queries longer than its rows, as the reference's does."""
    qp, qn = (pack_bits_device(torch.from_numpy(x[:, :n])) for x in (qpos, qneg))
    return match_one_vs_many_packed(
        qp, qn, torch.full((qpos.shape[0],), n, dtype=torch.int32), lib.pos_words,
        lib.neg_words, lib.counts, PAIRS, comparison_range).numpy()


@pytest.fixture(scope="module")
def grown_case():
    """24 entries of 1-12 rows (both orientations and the crossover), four
    20-subfingerprint streams; stream 0 echoes entry 3 shifted by 2."""
    rng = np.random.default_rng(5)
    fps = []
    for n in [1, 3, 6, 9, 12] * 5:
        p, q = _planes(rng, n)
        fps.append(Fingerprint(p, q))
    fps = fps[:24]
    qpos, qneg = (np.zeros((4, 20, PAIRS), np.uint8) for _ in range(2))
    for i in range(4):
        qpos[i], qneg[i] = _planes(rng, 20)
    qpos[0, 2:2 + fps[3].num_subfingerprints] = fps[3].pos
    qneg[0, 2:2 + fps[3].num_subfingerprints] = fps[3].neg
    return _libraries(fps), qpos, qneg


@pytest.mark.parametrize("comparison_range", [0, 64])
def test_incremental_equals_jax_and_full_every_tick(grown_case, comparison_range):
    (lib, jlib), qpos, qneg = grown_case
    inc = IncrementalLibraryMatcher(lib, batch=4, n_cap=4, comparison_range=comparison_range,
                                    stream_group=2, device="cpu")
    ref = jax_inc.IncrementalLibraryMatcher(jlib, batch=4, n_cap=4,
                                            comparison_range=comparison_range, stream_group=2)
    n = 0
    for k in [3, 1, 4, 2, 5, 5]:            # mixed k, grows 4 -> 8 -> 16 -> 32
        padded = [np.zeros((4, k + 2, PAIRS), np.uint8) for _ in range(2)]
        padded[0][:, :k], padded[1][:, :k] = qpos[:, n:n + k], qneg[:, n:n + k]
        inc.update(*padded, k_valid=k)
        ref.update(*padded, k_valid=k)
        n += k
        got = inc.scores()
        np.testing.assert_array_equal(got, ref.scores())
        np.testing.assert_array_equal(got, _full_scores(lib, qpos, qneg, n, comparison_range))
        np.testing.assert_array_equal(got, _packed_scores(lib, qpos, qneg, n, comparison_range))
        sc, ix = inc.top_k(3)
        jsc, jix = ref.top_k(3)
        np.testing.assert_array_equal(ix, jix)
        np.testing.assert_array_equal(sc, jsc)
    assert inc.n == 20 and inc.n_cap == 32
    assert int(got[0].argmax()) == 3 and got[0, 3] > 0.9


def test_incremental_n_cap_guard():
    rng = np.random.default_rng(0)
    lib, _ = _libraries([Fingerprint(*_planes(rng, 4))])
    inc = IncrementalLibraryMatcher(lib, batch=1, n_cap=4, grow=False, device="cpu")
    pos = np.zeros((1, 3, PAIRS), np.uint8)
    inc.update(pos, pos)
    with pytest.raises(ValueError, match="n_cap"):
        inc.update(pos, pos)


def test_update_bucketed_and_tensor_inputs_equal_raw_updates():
    rng = np.random.default_rng(11)
    lib, _ = _libraries([Fingerprint(*_planes(rng, 8))])
    qpos, qneg = _planes(rng, 13)
    a = IncrementalLibraryMatcher(lib, batch=1, n_cap=16, device="cpu")
    b = IncrementalLibraryMatcher(lib, batch=1, n_cap=16, device="cpu")
    n = 0
    for k in (3, 1, 7, 2):
        a.update(qpos[None, n:n + k], qneg[None, n:n + k])
        b.update_bucketed(torch.from_numpy(qpos[None, n:n + k]),
                          torch.from_numpy(qneg[None, n:n + k]))
        n += k
        np.testing.assert_array_equal(a.scores(), b.scores())
    assert a.n == b.n == n


def test_top_k_breaks_ties_toward_the_lower_index():
    rng = np.random.default_rng(2)
    fp = Fingerprint(*_planes(rng, 6))
    other = Fingerprint(*_planes(rng, 6))
    lib, jlib = _libraries([other, fp, other, fp, fp])
    inc = IncrementalLibraryMatcher(lib, batch=1, device="cpu")
    ref = jax_inc.IncrementalLibraryMatcher(jlib, batch=1)
    inc.update(fp.pos[None, :4], fp.neg[None, :4])
    ref.update(fp.pos[None, :4], fp.neg[None, :4])
    sc, ix = inc.top_k(5)
    assert ix[0].tolist() == [1, 3, 4, 0, 2] == np.asarray(ref.top_k(5)[1])[0].tolist()
    assert sc[0, 0] == 1.0


@pytest.mark.parametrize("overlap", [False, True])
def test_hit_counts_past_256_stay_exact(overlap):
    """At 200 pairs, a library whose entries set both bits of a pair,
    queried by planes that do too, has hit counts up to 400, which bf16
    rounds: the matcher then keeps float32 planes, and bf16 ones only while
    every count is at most ``pairs``.  Scores equal the JAX matcher's either
    way (its hits are exact float32 sums), and the packed matcher's where
    the planes are disjoint: with overlapping ones both packages' running
    sums count a '11' pair twice in the possible hits, the packed matchers'
    ``popcount(p | n)`` once."""
    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch.utils import packing

    pairs, s, n = 200, 12, 10
    rng = np.random.default_rng(23)
    lp, ln = (rng.random((2, 6, s, pairs)) < 0.9).astype(np.uint8)
    qp, qn = (rng.random((2, 2, n, pairs)) < 0.9).astype(np.uint8)
    if not overlap:
        ln &= 1 - lp
        qn &= 1 - qp
    counts = np.array([12, 12, 9, 12, 4, 12], np.int32)
    for x in (lp, ln):
        x[np.arange(s)[None, :] >= counts[:, None]] = 0          # rows past an entry's count
    words = packing.pack_bits(lp), packing.pack_bits(ln)
    lib = FingerprintLibrary.from_arrays(*words, counts, pairs,
                                         FingerprintConfig(subfingerprint_length=2 * pairs),
                                         device="cpu")
    jcfg = JaxConfig(subfingerprint_length=2 * pairs)
    ref = jax_inc.IncrementalLibraryMatcher(JaxLibrary(*words, counts, pairs, jcfg), batch=2,
                                            config=jcfg)
    inc = IncrementalLibraryMatcher(lib, batch=2, config=lib.config, device="cpu")
    inc.update(qp, qn)
    ref.update(qp, qn)
    assert inc._dtype == (torch.float32 if overlap else torch.bfloat16)
    got = inc.scores()
    np.testing.assert_array_equal(got, ref.scores())
    if not overlap:
        np.testing.assert_array_equal(got, match_one_vs_many_packed(
            pack_bits_device(torch.from_numpy(qp)), pack_bits_device(torch.from_numpy(qn)),
            torch.full((2,), n, dtype=torch.int32), lib.pos_words, lib.neg_words,
            lib.counts, pairs, 0, 2 * pairs).numpy())


def test_session_pool_equals_per_session_matchers_and_jax_pool():
    """Asynchronous posts folded per flush equal dedicated per-session
    matchers (and the JAX pool) through uneven schedules, shared and
    distinct ages in one flush, slot reuse and growth."""
    rng = np.random.default_rng(31)
    lib, jlib = _libraries([Fingerprint(*_planes(rng, 6)) for _ in range(4)])
    pool = StreamSessionPool(lib, slots=3, n_cap=4, device="cpu")
    jpool = jax_inc.StreamSessionPool(jlib, slots=3, n_cap=4)
    refs, streams = {}, {}

    def open_(sid):
        assert pool.open(sid) == jpool.open(sid)
        refs[sid] = IncrementalLibraryMatcher(lib, batch=1, n_cap=4, device="cpu")
        streams[sid] = _planes(rng, 16)

    def post(sid, k):
        a0 = refs[sid].n + pool.pending(sid)
        p, q = streams[sid]
        pool.post(sid, p[a0:a0 + k], q[a0:a0 + k])
        jpool.post(sid, p[a0:a0 + k], q[a0:a0 + k])

    def flush_and_check():
        for sid, parts in list(pool._pending.items()):
            refs[sid].update(np.concatenate([x for x, _ in parts])[None],
                             np.concatenate([x for _, x in parts])[None])
        assert pool.flush() == jpool.flush()
        sc, ix = pool.top_k(2)
        jsc, jix = jpool.top_k(2)
        np.testing.assert_array_equal(sc, jsc)
        np.testing.assert_array_equal(ix, jix)
        for sid, ref in refs.items():
            if sid in pool._slot:
                want = ref.scores()[0]
                np.testing.assert_array_equal(pool.scores_for(sid), want, err_msg=sid)
                one = pool.top_k(2, [sid])          # this session's slot alone
                np.testing.assert_array_equal(one[0][0], sc[pool._slot[sid]], err_msg=sid)
                np.testing.assert_array_equal(one[1][0], ix[pool._slot[sid]], err_msg=sid)
                np.testing.assert_array_equal(ix[pool._slot[sid]],
                                              np.argsort(-want, kind="stable")[:2])
                assert pool.age(sid) == ref.n

    open_("a")
    open_("b")
    post("a", 3)
    post("b", 3)                                # two slots at one age
    flush_and_check()
    post("b", 2)
    post("a", 1)
    flush_and_check()
    open_("c")
    post("c", 4)
    post("b", 1)
    post("b", 2)                                # two posts, one flush
    flush_and_check()
    post("a", 5)                                # a grows past n_cap=4
    flush_and_check()
    assert pool._m.n_cap >= 9
    slot_b = pool._slot["b"]
    pool.close("b")
    jpool.close("b")
    del refs["b"]
    open_("d")
    assert pool._slot["d"] == slot_b and pool.age("d") == 0
    post("d", 2)
    flush_and_check()
    assert pool.flush() == 0
    with pytest.raises(KeyError):
        pool.post("nope", *_planes(rng, 1))
    with pytest.raises(RuntimeError):
        pool.open("e")                          # 3 slots, all taken


#: name: (pool capacity n_cap, comparison_range, overlapping planes, sharded)
FOLD_CASES = {"mixed_ages": (64, 0, False, False), "grows_n_cap": (4, 0, False, False),
              "comparison_range": (64, 37, False, False),
              "overlapping_planes": (64, 0, True, False), "sharded_mesh": (4, 0, False, True)}


def _fold_libraries(rng, overlap: bool):
    """Seven entries of 2-11 rows; with ``overlap``, entries and posted
    rows that set both bits of some pairs (the words may hold them)."""
    from lbaudiodetective_torch.config import FingerprintConfig
    from lbaudiodetective_torch.utils import packing

    counts = np.array([6, 11, 2, 9, 4, 11, 7], np.int32)
    lp, ln = np.zeros((2, counts.size, 11, PAIRS), np.uint8)
    for e, n in enumerate(counts):
        lp[e, :n], ln[e, :n] = _planes(rng, n)
        if overlap:
            ln[e, :n] |= lp[e, :n] & (rng.random((n, PAIRS)) < 0.3)
    words = packing.pack_bits(lp).view(np.int32), packing.pack_bits(ln).view(np.int32)
    return (FingerprintLibrary.from_arrays(*words, counts, PAIRS, FingerprintConfig(),
                                           device="cpu"),
            JaxLibrary(*(x.view(np.uint32) for x in words), counts, PAIRS, JaxConfig()))


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_posting_slot_fold_equals_matchers_and_jax_pool(case):
    """The pool folds only the slots that posted (the fold kernel's plain
    version): every slot's state equals, bit for bit, a per-session
    matcher's lockstep ``update`` of the same rows, and its scores the JAX
    pool's, through flushes with slots at different ages and counts, slots
    that post nothing, posts that grow ``n_cap``, a comparison range,
    overlapping planes, and a library on a 4-way sharded CPU mesh.  A row
    with ``k_valid`` 0 leaves its slot untouched."""
    n_cap, comparison_range, overlap, sharded = FOLD_CASES[case]
    rng = np.random.default_rng(71)
    lib, jlib = _fold_libraries(rng, overlap)
    if sharded:
        from lbaudiodetective_torch.parallel.mesh import make_mesh
        from lbaudiodetective_torch.parallel.sharded_library import ShardedFingerprintLibrary

        lib = ShardedFingerprintLibrary(lib, make_mesh(8, library_parallelism=4, device="cpu"))
    pool = StreamSessionPool(lib, slots=5, n_cap=n_cap, comparison_range=comparison_range,
                             device="cpu")
    jpool = jax_inc.StreamSessionPool(jlib, slots=5, n_cap=n_cap,
                                      comparison_range=comparison_range)
    streams, refs = {}, {}
    for sid in "abcd":
        assert pool.open(sid) == jpool.open(sid)
        p, q = _planes(rng, 24)
        if overlap:
            q |= p & (rng.random(p.shape) < 0.2)
        streams[sid] = p, q
        refs[sid] = IncrementalLibraryMatcher(lib, batch=1, n_cap=n_cap,
                                              comparison_range=comparison_range, device="cpu")

    def check(sids):
        for sid in sids:
            got, want = pool._m.slot_state(pool._slot[sid]), refs[sid].slot_state(0)
            np.testing.assert_array_equal(got[0], want[0], err_msg=sid)
            cap = min(got[1].shape[-1], want[1].shape[-1])
            np.testing.assert_array_equal(got[1][..., :cap], want[1][..., :cap], err_msg=sid)
            assert not got[1][..., cap:].any() and not want[1][..., cap:].any()
            scores = pool.scores_for(sid)
            np.testing.assert_array_equal(scores, refs[sid].scores()[0], err_msg=sid)
            np.testing.assert_array_equal(scores, np.asarray(jpool.scores_for(sid)), err_msg=sid)

    # Each flush: {session: rows per post}; sessions left out post nothing.
    for flush in ({"a": [3], "b": [3], "c": [1]}, {"a": [2], "c": [5], "d": [4]},
                  {"b": [1, 2], "d": [4]}, {"a": [6], "c": [2], "d": [1]}):
        for sid, posts in flush.items():
            for k in posts:
                a0 = pool.age(sid) + pool.pending(sid)
                p, q = (x[a0:a0 + k] for x in streams[sid])
                pool.post(sid, p, q)
                jpool.post(sid, p, q)
                refs[sid].update(p[None], q[None])
        assert pool.flush() == jpool.flush() == len(flush)
        assert pool.last_flush["slots_folded"] == len(flush)
        check("abcd")
    assert [pool.age(sid) for sid in "abcd"] == [11, 6, 8, 9]
    assert pool._m.n_cap == (16 if n_cap == 4 else n_cap)

    # A row with k_valid 0 folds nothing; the other row folds as a post.
    slots = [pool._slot["b"], pool._slot["a"]]
    p, q = (np.stack([x[6:8], y[11:13]]) for x, y in zip(streams["b"], streams["a"]))
    before = pool._m.slot_state(slots[0])
    assert pool._m.update_slots(p, q, [0, 2], pool._age[slots], slots) == 1
    pool._age[slots[1]] += 2
    refs["a"].update(p[1:], q[1:])
    jpool.post("a", p[1], q[1])
    jpool.flush()
    for x, y in zip(pool._m.slot_state(slots[0]), before):
        np.testing.assert_array_equal(x, y)
    check("a")

    with pytest.raises(ValueError, match="single-group"):
        IncrementalLibraryMatcher(lib, batch=2, stream_group=1, device="cpu").update_slots(
            p, q, [1, 1], [0, 0], [0, 1])


@pytest.mark.parametrize("sharded", [False, True])
def test_top_k_of_chosen_slots_equals_those_rows_of_the_full_call(sharded):
    """Scoring only the slots asked for changes no bit: ``top_k_slots``,
    ``scores_slots`` and ``StreamSessionPool.top_k`` restricted to one slot,
    to an unsorted subset (a slot at age 0 among them) and to every slot
    equal those rows of the unrestricted call, scores and indices, at mixed
    slot ages, with tied library entries, on one device and on a 4-way
    sharded CPU mesh; and they equal the JAX pool's full top-k rows."""
    rng = np.random.default_rng(61)
    fps = [Fingerprint(*_planes(rng, n)) for n in (6, 9, 4, 11, 7)]
    fps += [fps[1], fps[3]]                     # entries 5 and 6 tie 1 and 3
    lib, jlib = _libraries(fps)
    if sharded:
        from lbaudiodetective_torch.parallel.mesh import make_mesh
        from lbaudiodetective_torch.parallel.sharded_library import ShardedFingerprintLibrary

        lib = ShardedFingerprintLibrary(lib, make_mesh(8, library_parallelism=4, device="cpu"))
    pool = StreamSessionPool(lib, slots=6, n_cap=4, device="cpu")
    jpool = jax_inc.StreamSessionPool(jlib, slots=6, n_cap=4)
    sids = list("abcdef")
    for sid in sids:
        assert pool.open(sid) == jpool.open(sid)
    streams = {"a": (fps[1].pos, fps[1].neg), "b": _planes(rng, 5), "c": (fps[3].pos, fps[3].neg),
               "d": _planes(rng, 2), "e": _planes(rng, 3)}       # "f" stays at age 0
    for part in (slice(0, 4), slice(4, None)):  # two flushes; a and c grow past n_cap=4
        for sid, (p, q) in streams.items():
            if p[part].shape[0]:
                pool.post(sid, p[part], q[part])
                jpool.post(sid, p[part], q[part])
        pool.flush()
        jpool.flush()
    assert [pool.age(sid) for sid in sids] == [9, 5, 11, 2, 3, 0]
    m, slot = pool._m, pool._slot
    full_scores = m.scores_slots(pool._age)
    for k in (1, 3):
        full = m.top_k_slots(k, pool._age)
        jfull = [np.asarray(x) for x in jpool.top_k(k)]
        np.testing.assert_array_equal(full[0], jfull[0])
        np.testing.assert_array_equal(full[1], jfull[1])
        for chosen in (["c"], ["e", "a", "f", "b"], sids):
            rows = [slot[sid] for sid in chosen]
            for got in (m.top_k_slots(k, pool._age, rows), pool.top_k(k, chosen)):
                for g, f, j in zip(got, full, jfull):
                    assert g.shape == (len(rows), k)
                    np.testing.assert_array_equal(g, f[rows], err_msg=str(chosen))
                    np.testing.assert_array_equal(g, j[rows], err_msg=str(chosen))
            np.testing.assert_array_equal(m.scores_slots(pool._age, rows), full_scores[rows])
    sc, ix = pool.top_k(3, ["a", "c", "f"])
    assert ix[0, :2].tolist() == [1, 5] and sc[0, 0] == sc[0, 1] == 1.0     # ties: lower first
    assert ix[1, :2].tolist() == [3, 6] and sc[1, 0] == sc[1, 1] == 1.0
    assert not sc[2].any() and ix[2].tolist() == [0, 1, 2]                  # age 0: all zero
    for sid in sids:
        np.testing.assert_array_equal(pool.scores_for(sid), full_scores[slot[sid]])


def test_state_roundtrip_and_cross_package(tmp_path):
    """A clone restored from a checkpoint continues exactly; a checkpoint
    of either package restores in the other; another library, other neg
    planes or another comparison range are refused."""
    rng = np.random.default_rng(23)
    fps = [Fingerprint(*_planes(rng, 5)) for _ in range(3)]
    lib, jlib = _libraries(fps)
    qpos, qneg = (np.zeros((2, 12, PAIRS), np.uint8) for _ in range(2))
    for i in range(2):
        qpos[i], qneg[i] = _planes(rng, 12)
    m = IncrementalLibraryMatcher(lib, batch=2, n_cap=4, device="cpu")
    jm = jax_inc.IncrementalLibraryMatcher(jlib, batch=2, n_cap=4)
    for a, b in ((0, 3), (3, 7)):               # grows past n_cap=4
        m.update(qpos[:, a:b], qneg[:, a:b])
        jm.update(qpos[:, a:b], qneg[:, a:b])
    path, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    m.save_state(path)
    jm.save_state(jpath)
    assert m._state_key() == jm._state_key()
    fresh = m.clone_empty()
    fresh.restore_state(jpath)                  # the JAX package's checkpoint
    jfresh = jm.clone_empty()
    jfresh.restore_state(path)                  # the port's checkpoint
    assert fresh.n == jfresh.n == 7 and fresh.n_cap == m.n_cap
    np.testing.assert_array_equal(fresh.scores(), m.scores())
    np.testing.assert_array_equal(np.asarray(jfresh.scores()), m.scores())
    for x in (m, fresh, jfresh):
        x.update(qpos[:, 7:12], qneg[:, 7:12])
    np.testing.assert_array_equal(fresh.scores(), m.scores())
    np.testing.assert_array_equal(np.asarray(jfresh.scores()), m.scores())

    other, _ = _libraries([Fingerprint(*_planes(rng, 5))])
    negless, _ = _libraries([Fingerprint(f.pos, np.zeros_like(f.neg)) for f in fps])
    for refuse in (IncrementalLibraryMatcher(other, batch=2, n_cap=4, device="cpu"),
                   IncrementalLibraryMatcher(negless, batch=2, n_cap=4, device="cpu"),
                   IncrementalLibraryMatcher(lib, batch=2, n_cap=4, comparison_range=8,
                                             device="cpu")):
        with pytest.raises(ValueError, match="different library"):
            refuse.restore_state(path)


def test_pool_checkpoints_restore_in_matchers_and_the_jax_pool(tmp_path):
    rng = np.random.default_rng(41)
    lib, jlib = _libraries([Fingerprint(*_planes(rng, 6)) for _ in range(3)])
    p, q = _planes(rng, 10)
    pool = StreamSessionPool(lib, slots=2, n_cap=4, device="cpu")
    pool.open("x")
    pool.post("x", p[:6], q[:6])
    with pytest.raises(ValueError, match="flush"):
        pool.save_session("x", str(tmp_path / "x.npz"))
    pool.flush()
    pool.save_session("x", str(tmp_path / "x.npz"))
    single = IncrementalLibraryMatcher(lib, batch=1, n_cap=4, device="cpu")
    single.restore_state(str(tmp_path / "x.npz"))
    np.testing.assert_array_equal(single.scores()[0], pool.scores_for("x"))
    jpool = jax_inc.StreamSessionPool(jlib, slots=2, n_cap=16)
    jpool.open("x")
    jpool.restore_session("x", str(tmp_path / "x.npz"))
    single.save_state(str(tmp_path / "y.npz"))
    pool2 = StreamSessionPool(lib, slots=2, n_cap=2, device="cpu")    # grows to 8
    pool2.open("y")
    pool2.restore_session("y", str(tmp_path / "y.npz"))
    for pl in (pool, pool2, jpool):
        sid = "y" if pl is pool2 else "x"
        pl.post(sid, p[6:], q[6:])
        pl.flush()
    np.testing.assert_array_equal(pool2.scores_for("y"), pool.scores_for("x"))
    np.testing.assert_array_equal(np.asarray(jpool.scores_for("x")), pool.scores_for("x"))


def test_matcher_checks_its_device():
    rng = np.random.default_rng(1)
    lib, _ = _libraries([Fingerprint(*_planes(rng, 4))])
    with pytest.raises(ValueError, match="not on meta"):
        IncrementalLibraryMatcher(lib, batch=1, device="meta")
    with pytest.raises(ValueError, match="divide"):
        IncrementalLibraryMatcher(lib, batch=3, stream_group=2, device="cpu")
