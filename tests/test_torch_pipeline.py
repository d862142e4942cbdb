"""The port's pipelines (``lbaudiodetective_torch/parallel/pipeline.py``)
on the CPU: ``PipelinedIdentifier`` and ``DeviceSplitPipeline`` (extract
on 4 slots, match on 4 others) return each batch's scores one submit late,
equal to extracting and matching directly and to the JAX package's
pipelines on the same batches (the JAX side on its virtual CPU devices),
bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lbaudiodetective_tpu.ops.match import match_one_vs_many_padded  # noqa: E402
from lbaudiodetective_tpu.parallel import pipeline as jax_pipeline  # noqa: E402
from lbaudiodetective_torch.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_torch.ops.extract import required_padded_length  # noqa: E402
from lbaudiodetective_torch.parallel.mesh import make_mesh  # noqa: E402
from lbaudiodetective_torch.parallel.pipeline import (  # noqa: E402
    DeviceSplitPipeline, PipelinedIdentifier)
from tests._torch_common import jax_config  # noqa: E402
from tests.test_match import random_fp  # noqa: E402


def _library(rng, l, s_lib, lo):
    lib = [random_fp(rng, int(n)) for n in rng.integers(lo, s_lib + 1, size=l)]
    pos = np.zeros((l, s_lib, 100), np.uint8)
    neg = np.zeros_like(pos)
    counts = np.zeros(l, np.int32)
    for i, (p, n) in enumerate(lib):
        counts[i] = p.shape[0]
        pos[i, :p.shape[0]], neg[i, :n.shape[0]] = p, n
    return pos, neg, counts


def _batches(rng, cfg, b, n=3, n_sub=1):
    t_pad = required_padded_length(cfg, cfg.rows_per_frame * n_sub)
    return [((rng.standard_normal((b, t_pad)) * 0.1).astype(np.float32),
             np.full(b, n_sub, np.int64)) for _ in range(n)]


def _direct(pipe, audio, n_subs, lib):
    """The JAX package's one-vs-many matcher on the port's extracted planes."""
    pos, neg = pipe._extract(audio, n_subs)
    if isinstance(pos, list):
        pos, neg = torch.cat(pos)[:len(n_subs)], torch.cat(neg)[:len(n_subs)]
    s = max(lib[0].shape[1], pos.shape[1])
    pad = lambda a: np.pad(a, ((0, 0), (0, s - a.shape[1]), (0, 0)))   # noqa: E731
    lp, ln = (jnp.asarray(pad(x)) for x in lib[:2])
    return np.stack([np.asarray(match_one_vs_many_padded(
        jnp.asarray(pad(pos.numpy())[i]), jnp.asarray(pad(neg.numpy())[i]), jnp.int32(n),
        lp, ln, jnp.asarray(lib[2]))) for i, n in enumerate(n_subs)])


@pytest.mark.parametrize("n_sub", [1, 2])
def test_pipeline_equals_direct_and_jax(n_sub):
    cfg = FingerprintConfig()
    rng = np.random.default_rng(90)
    lib = _library(rng, 6, 16, 4)
    batches = _batches(rng, cfg, 2, n_sub=n_sub)
    pipe = PipelinedIdentifier(*lib, cfg, device="cpu")
    assert pipe.submit(*batches[0]) is None                 # one batch late
    results = [pipe.submit(*batches[1])] + list(pipe.run(batches[2:]))
    assert len(results) == 3 and pipe.drain() is None
    jax_results = list(jax_pipeline.PipelinedIdentifier(*lib, jax_config(cfg)).run(batches))
    for (audio, n_subs), got, ref in zip(batches, results, jax_results):
        assert got.shape == (2, 6) and got.dtype == np.float32
        np.testing.assert_array_equal(got, _direct(pipe, audio, n_subs, lib))
        np.testing.assert_array_equal(got, ref)


def test_device_split_pipeline_equals_fused_and_jax():
    mesh = make_mesh(8, device="cpu")
    slots = list(mesh.slots.flat)
    cfg = FingerprintConfig()
    rng = np.random.default_rng(91)
    lib = _library(rng, 8, 8, 3)
    batches = _batches(rng, cfg, 4)
    pipe = DeviceSplitPipeline(*lib, slots[:4], slots[4:], cfg)
    assert [s.index for s in pipe.mesh_m.axis_slots("library")] == [4, 5, 6, 7]
    pos0, _ = pipe._extract(*batches[0])
    assert len(pos0) == 4 and pos0[0].shape[0] == 1          # one clip a slot
    outs = [pipe.submit(*b) for b in batches]
    assert outs[0] is None
    outs = outs[1:] + [pipe.drain()]
    fused = PipelinedIdentifier(*lib, cfg, device="cpu")
    jdevs = jax.devices()
    jpipe = jax_pipeline.DeviceSplitPipeline(*lib, jdevs[:4], jdevs[4:], jax_config(cfg))
    jouts = [jpipe.submit(*b) for b in batches][1:] + [jpipe.drain()]
    for (audio, n_subs), got, ref in zip(batches, outs, jouts):
        fused.submit(audio, n_subs)
        np.testing.assert_array_equal(got, fused.drain())
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="disjoint"):
        DeviceSplitPipeline(*lib, slots[:4], slots[3:7], cfg)
    with pytest.raises(ValueError, match="divide the match submesh"):
        DeviceSplitPipeline(*lib, slots[:5], slots[5:], cfg)
    with pytest.raises(TypeError, match="Slot"):
        DeviceSplitPipeline(*lib, ["cpu"], ["cpu"], cfg)
