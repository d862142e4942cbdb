"""End-to-end extraction of the port vs the JAX package and the live NumPy
oracle on synthetic clips (the bar of tests/test_extract_parity.py: >= 99.9 %
of bits), plus batch == single, zeroed padding, silence, and the rows
implementation each config takes on each device."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_tpu.config import FingerprintConfig  # noqa: E402
from lbaudiodetective_tpu.io.decode import DecodedAudio  # noqa: E402
from lbaudiodetective_torch.ops.extract import (  # noqa: E402
    extract_fingerprint, extract_fingerprint_batch, rows_impl)
from lbaudiodetective_torch.ops.match import match_fingerprints  # noqa: E402
from tests._torch_common import bit_agreement, synth_clip  # noqa: E402

CONFIGS = {
    "parity": FingerprintConfig(),
    "proc": FingerprintConfig(hop_domain="proc"),
    "fractional_hop": FingerprintConfig(integer_hop=False),
}


@pytest.mark.parametrize("cfg_name,seconds", [
    ("parity", 3.0), ("parity", 1.5), ("proc", 13.0), ("fractional_hop", 2.5)])
def test_extract_matches_jax_and_oracle(cfg_name, seconds):
    from lbaudiodetective_tpu.ops.extract import extract_fingerprint as jax_extract
    from lbaudiodetective_tpu.oracle.pipeline import oracle_fingerprint

    cfg = CONFIGS[cfg_name]
    clip = synth_clip(21, seconds, cfg)
    pos, neg, n = extract_fingerprint(clip, cfg)
    assert n > 0 and pos.shape == (n, 100) and pos.dtype == np.uint8
    assert not (pos & neg).any()
    jpos, jneg, jn = jax_extract(clip, cfg)
    assert jn == n
    assert bit_agreement(pos, neg, jpos[:n], jneg[:n]) >= 0.999
    opos, oneg = oracle_fingerprint(clip, cfg)
    assert opos.shape[0] == n
    assert bit_agreement(pos, neg, opos, oneg) >= 0.999


def test_batch_equals_single_and_padding_is_zero():
    cfg = CONFIGS["parity"]
    clips = [synth_clip(30 + i, s, cfg) for i, s in enumerate((2.0, 3.0, 1.2))]
    bpos, bneg, n_subs = extract_fingerprint_batch(clips, cfg)
    assert bpos.shape == (3, 16, 100)
    for i, c in enumerate(clips):
        pos, neg, n = extract_fingerprint(c, cfg)
        assert n == n_subs[i]
        np.testing.assert_array_equal(bpos[i, :n], pos)
        np.testing.assert_array_equal(bneg[i, :n], neg)
        assert bpos[i, n:].sum() == 0 and bneg[i, n:].sum() == 0
    # Static-shape serving form: padded batch and capped bucket.
    ppos, pneg, pn = extract_fingerprint_batch(clips, cfg, pad_batch_to=4, n_sub_cap=9)
    assert ppos.shape == (3, 16, 100)
    np.testing.assert_array_equal(pn, np.minimum(n_subs, 9))
    for i in range(3):
        np.testing.assert_array_equal(ppos[i, :pn[i]], bpos[i, :pn[i]])


def test_silence_extracts_all_zero_and_scores_zero():
    cfg = CONFIGS["parity"]
    rate, file_rate = cfg.processing_sample_rate, cfg.file_sample_rate
    d = DecodedAudio(np.zeros(int(3.0 * rate), np.float32), rate,
                     int(3.0 * file_rate), file_rate)
    pos, neg, n = extract_fingerprint(d, cfg)
    assert n > 0 and not pos.any() and not neg.any()
    assert match_fingerprints((pos, neg), (pos, neg)) == 0.0


def test_short_clip_has_no_subfingerprints():
    cfg = CONFIGS["parity"]
    d = synth_clip(3, 0.2, cfg)
    pos, neg, n = extract_fingerprint(d, cfg)
    assert n == 0 and pos.shape == (0, 100)


def test_rows_implementation_per_device():
    """CUDA takes the kernels where the reference takes its v3 kernel, and
    raises for a config whose reference kernel has no port yet."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert rows_impl(CONFIGS["parity"], cuda) == "v3"
    assert rows_impl(CONFIGS["proc"], cuda) == "v3"
    assert rows_impl(CONFIGS["parity"], cpu) == "v3"
    assert rows_impl(CONFIGS["fractional_hop"], cpu) == "xla"
    with pytest.raises(NotImplementedError, match="fused_rows.py::fused_band_rows"):
        rows_impl(CONFIGS["fractional_hop"], cuda)
    big_frames = FingerprintConfig(rows_per_frame=256)
    assert rows_impl(big_frames, cpu) == "conv"
    with pytest.raises(NotImplementedError, match="fused_band_rows_v3"):
        rows_impl(big_frames, cuda)
    low_band = FingerprintConfig(min_frequency=1.0)
    assert rows_impl(low_band, cuda) == "xla"


@pytest.mark.parametrize("cfg_kwargs", [dict(rows_per_frame=256),
                                        dict(min_frequency=1.0)])
def test_other_rows_paths_match_jax(cfg_kwargs):
    """The conv path (frames that are not 128 x 32) and the packed-rfft path
    (band edges at bin 0) against the JAX package on the CPU."""
    from lbaudiodetective_tpu.ops.extract import extract_fingerprint as jax_extract

    cfg = FingerprintConfig(**cfg_kwargs)
    clip = synth_clip(23, 4.0, cfg)
    pos, neg, n = extract_fingerprint(clip, cfg)
    jpos, jneg, jn = jax_extract(clip, cfg)
    assert n == jn > 0
    assert bit_agreement(pos, neg, jpos[:n], jneg[:n]) >= 0.999
