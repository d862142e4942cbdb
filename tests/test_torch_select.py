"""Top-128 sign-class select of the port vs the JAX Pallas kernel (interpret
mode) and a numpy stable argsort: element-exact, ties, zeros, NaN and inf
included.  The CUDA kernel's own test is in tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lbaudiodetective_torch.ops.kernels.select_signs import (  # noqa: E402
    select_sign_classes, select_sign_classes_plain)
from tests._torch_common import numpy_select, select_cases  # noqa: E402

CASES = select_cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_select_matches_jax_kernel_and_stable_sort(case):
    import jax.numpy as jnp

    from lbaudiodetective_tpu.ops.pallas.select_signs import select_sign_classes_padded

    x = CASES[case]
    got = select_sign_classes(torch.from_numpy(x)).numpy()       # CPU: plain version
    assert got.shape == (x.shape[0], 128) and got.dtype == np.int32
    np.testing.assert_array_equal(got, numpy_select(x))
    ref = np.asarray(select_sign_classes_padded(jnp.asarray(x), f_blk=8, interpret=True))
    np.testing.assert_array_equal(got, ref)


def test_plain_select_any_width_and_k():
    """The plain version serves frames of any width (the sort path of
    configs whose frames are not 4096 wide)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 1024)).astype(np.float32)
    got = select_sign_classes_plain(torch.from_numpy(x), k=60).numpy()
    np.testing.assert_array_equal(got.reshape(15, 60), numpy_select(x.reshape(15, 1024), 60))


def test_select_rejects_bad_shapes():
    with pytest.raises(ValueError):
        select_sign_classes(torch.zeros((4, 2048)))
    with pytest.raises(TypeError):
        select_sign_classes(torch.zeros((4, 4096), dtype=torch.float64))
