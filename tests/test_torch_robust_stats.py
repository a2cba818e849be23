"""K1, the rank-selection trimmed mean / median of the robust aggregators:
the port's plain version (what its wrapper runs on a CPU tensor, and what the
CUDA kernel is held bit-equal to on the card) against the reference's Pallas
kernel in interpret mode, the sort definition and numpy's median."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from fedml_tpu.ops.robust_stats import trimmed_mean_1d as jax_trimmed_mean_1d  # noqa: E402

from fedml_tpu_torch.ops import robust_stats as rs  # noqa: E402


def _x(C, D, seed):
    return np.random.default_rng(seed).normal(size=(C, D)).astype(np.float32)


@pytest.mark.parametrize("D", [100, 700])
@pytest.mark.parametrize("C", [3, 4, 5, 8, 10, 16])
def test_plain_matches_reference_kernel_every_k(C, D):
    x = _x(C, D, 10 * C + D)
    for k in range((C - 1) // 2 + 1):
        got = rs.trimmed_mean_1d(torch.from_numpy(x), k)
        want = jax_trimmed_mean_1d(jnp.asarray(x), k, use_kernel=True, interpret=True)
        assert got.dtype == torch.float32 and got.shape == (D,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            got.numpy(), rs.trimmed_mean_sort(torch.from_numpy(x), k).numpy(),
            rtol=1e-6, atol=1e-7,
        )


@pytest.mark.parametrize("C", [3, 4, 7, 8])
def test_median_matches_numpy_odd_and_even(C):
    x = _x(C, 300, C + 50)
    got = rs.median_1d(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.median(x, axis=0), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_integer_ties_equal_the_sort_reference_exactly(k):
    """Integer-valued floats sum exactly, so only the kept multiset decides
    the result: under heavy ties the stable index tie-break must keep what
    a stable sort's window keeps, bit for bit."""
    x = np.random.default_rng(0).integers(-3, 4, size=(6, 500)).astype(np.float32)
    got = rs.trimmed_mean_1d(torch.from_numpy(x), k)
    s = np.sort(x, axis=0)
    np.testing.assert_array_equal(got.numpy(), np.mean(s[k : 6 - k], axis=0).astype(np.float32))


def test_single_client_median_is_that_client():
    x = _x(1, 37, 2)
    got = rs.median_1d(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), x[0])
    assert rs.LAUNCHES[rs.KERNEL_NAME] == 0  # the CPU path launches nothing


@pytest.mark.parametrize("C,k", [(4, 2), (5, 3), (2, 1), (3, -1)])
def test_trim_window_must_leave_a_value(C, k):
    with pytest.raises(ValueError, match="trim_k"):
        rs.trimmed_mean_1d(torch.zeros(C, 8), k)


def test_half_precision_input_is_reduced_in_float32():
    x = _x(5, 64, 6)
    got = rs.trimmed_mean_1d(torch.from_numpy(x).to(torch.bfloat16), 1)
    want = rs.trimmed_mean_plain(torch.from_numpy(x).to(torch.bfloat16).float(), 1)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.numpy())
