"""The port's time-sharded long matcher (``lbaudiodetective_torch/parallel/
long_match.py``) on an 8-slot CPU ring against the JAX package's
``match_long_time_sharded`` on its 8 virtual CPU devices and against the
port's blockwise ``match_long_padded``: within 1e-5, the JAX package's own
bar (tests/test_long_match_sharded.py), on its inputs, ragged counts
included."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from lbaudiodetective_tpu.oracle.pipeline import oracle_match_fingerprints  # noqa: E402
from lbaudiodetective_tpu.parallel.long_match import (  # noqa: E402
    match_long_time_sharded as jax_time_sharded)
from lbaudiodetective_torch.ops.match import match_long_padded  # noqa: E402
from lbaudiodetective_torch.parallel.long_match import match_long_time_sharded  # noqa: E402
from lbaudiodetective_torch.parallel.mesh import Mesh, Slot, make_mesh  # noqa: E402

PAIRS = 128


def _random_fp(rng, n, density=0.45):
    pos = (rng.random((n, PAIRS)) < density).astype(np.uint8)
    neg = ((rng.random((n, PAIRS)) < density) & (pos == 0)).astype(np.uint8)
    return pos, neg


def _embed_query(rng, pos1, neg1, at, n2, flip=0.05):
    pos2, neg2 = pos1[at:at + n2].copy(), neg1[at:at + n2].copy()
    fl = rng.random((n2, PAIRS)) < flip
    return (np.where(fl, neg2, pos2).astype(np.uint8),
            np.where(fl, pos1[at:at + n2], neg2).astype(np.uint8))


@pytest.fixture(scope="module")
def meshes():
    slots = np.array([Slot(i, torch.device("cpu")) for i in range(8)], dtype=object)
    return JaxMesh(np.array(jax.devices()[:8]), ("time",)), Mesh(slots, ("time",))


def _blockwise(pos1, neg1, n1, pos2, neg2, n2, chunk):
    s1p = -(-n1 // chunk) * chunk
    pad = ((0, s1p - n1), (0, 0))
    return float(match_long_padded(np.pad(pos1, pad), np.pad(neg1, pad), n1, pos2, neg2, n2,
                                   chunk=chunk, device="cpu"))


@pytest.mark.parametrize("n1, n2, at, chunk", [(10_240, 64, 7_391, 512), (1_200, 24, 831, 256),
                                               (1_037, 29, None, 128)])
def test_time_sharded_equals_jax_and_blockwise(meshes, n1, n2, at, chunk):
    jmesh, mesh = meshes
    rng = np.random.default_rng(n1)
    pos1, neg1 = _random_fp(rng, n1)
    pos2, neg2 = (_random_fp(rng, n2) if at is None       # ragged, no planted match
                  else _embed_query(rng, pos1, neg1, at, n2))
    got = match_long_time_sharded(pos1, neg1, n1, pos2, neg2, n2, mesh, axis="time")
    ref = jax_time_sharded(pos1, neg1, n1, pos2, neg2, n2, jmesh, axis="time")
    assert abs(got - ref) < 1e-5, (got, ref)
    blockwise = _blockwise(pos1, neg1, n1, pos2, neg2, n2, chunk)
    assert abs(got - blockwise) < 1e-5, (got, blockwise)
    if at is not None:
        assert got > 0.8
    if n1 <= 1_200:
        oracle = oracle_match_fingerprints((pos1, neg1), (pos2, neg2))
        assert abs(got - oracle) < 1e-5


@pytest.mark.parametrize("comparison_range", [0, 37])
def test_time_sharded_on_a_data_axis_and_padded_rows(comparison_range):
    """The default axis of a (data, library) mesh; counts below the planes'
    rows (zero-padded), and the refusals."""
    mesh = make_mesh(8, device="cpu")                       # data axis 4
    rng = np.random.default_rng(9)
    pos1, neg1 = _random_fp(rng, 300)
    pos2, neg2 = _embed_query(rng, pos1, neg1, 101, 40)
    pos1[250:], neg1[250:] = 0, 0
    pos2[33:], neg2[33:] = 0, 0
    got = match_long_time_sharded(pos1, neg1, 250, pos2, neg2, 33, mesh,
                                  comparison_range=comparison_range)
    ref = float(match_long_padded(np.pad(pos1, ((0, 84), (0, 0))), np.pad(neg1, ((0, 84), (0, 0))),
                                  250, pos2, neg2, 33, comparison_range, chunk=128, device="cpu"))
    assert abs(got - ref) < 1e-5
    assert match_long_time_sharded(pos1[:0], neg1[:0], 0, pos2, neg2, 33, mesh) == 0.0
    with pytest.raises(ValueError, match="longer side"):
        match_long_time_sharded(pos2, neg2, 40, pos1, neg1, 300, mesh)
