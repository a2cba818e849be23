"""Weak-DP noise (``robustness.add_gaussian_noise``) and the weak-DP round
(``algorithms/fedavg_robust.py``) against ``fedml_tpu`` on the CPU.

The port cannot draw JAX's threefry normals, so its noise is a hook
(``noise_fn``); ``torch_parity.jax_noise_fn`` hands it the reference's own
draws — one key a leaf, split in ``jax.tree_util`` order over the whole
variables tree, each draw in the reference's layout (HWIO kernels)
transposed into the port's. With those draws:

- ``add_gaussian_noise`` equals the reference's bit for bit on the
  weights and leaves the running statistics untouched;
- 2 weak-DP rounds of the FEMNIST slice (clip to 5, noise 0.025 after the
  average) match the reference at the slice's tolerance."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from fedml_tpu.algorithms.fedavg_robust import NOISE_FOLD as JAX_NOISE_FOLD  # noqa: E402
from fedml_tpu.robustness import add_gaussian_noise as jax_add_noise  # noqa: E402

from fedml_tpu_torch.algorithms.fedavg import NOISE_FOLD  # noqa: E402
from fedml_tpu_torch.bridge import from_flax, to_flax_variables  # noqa: E402
from fedml_tpu_torch.robustness import add_gaussian_noise  # noqa: E402

from torch_parity import (  # noqa: E402
    assert_slice_close, jax_noise_fn, private_reference_programs, run_slice,
)


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _variables(seed: int):
    rng = np.random.default_rng(seed)
    tree = {
        "params": {
            "conv1": {"kernel": rng.normal(size=(5, 5, 1, 8)), "bias": rng.normal(size=(8,))},
            "fc": {"kernel": rng.normal(size=(32, 10)), "bias": rng.normal(size=(10,))},
        },
        "batch_stats": {"bn": {"mean": rng.normal(size=(8,)), "var": rng.random(8)}},
    }
    return jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)


@pytest.mark.parametrize("round_idx,stddev", [(0, 0.025), (3, 1.5)])
def test_noise_equals_the_reference_on_weights_only(round_idx, stddev):
    tree = _variables(round_idx)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), round_idx + 1), NOISE_FOLD)
    want = jax_add_noise(jax.tree_util.tree_map(jnp.asarray, tree), key, stddev)
    port = from_flax(tree)
    draw = lambda names, shapes: jax_noise_fn(7)(round_idx, NOISE_FOLD, names, shapes)  # noqa: E731
    got = to_flax_variables(add_gaussian_noise(port, draw, stddev))
    for (path, g), (_, w) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                 jax.tree_util.tree_flatten_with_path(want)[0], strict=True):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))
    for k, v in port.items():
        if k.startswith("batch_stats."):
            assert torch.equal(from_flax(got)[k], v), k  # statistics untouched
        else:
            assert not torch.equal(from_flax(got)[k], v), k
    assert NOISE_FOLD == JAX_NOISE_FOLD


def test_default_noise_is_seeded_and_round_keyed():
    from fedml_tpu_torch.algorithms.fedavg import seeded_noise_fn

    fn = seeded_noise_fn(0, torch.device("cpu"))
    a = fn(1, NOISE_FOLD, ["w", "b"], [(3, 4), (4,)])
    b = fn(1, NOISE_FOLD, ["w", "b"], [(3, 4), (4,)])
    c = fn(2, NOISE_FOLD, ["w", "b"], [(3, 4), (4,)])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and a[0].dtype == torch.float32


def test_weak_dp_rounds_match_the_reference():
    """2 rounds; the params and rows at the slice's tolerance
    (assert_slice_close: rtol 1e-4, atol 1e-5, rows 1e-4)."""
    japi, tapi = run_slice(robust={"defense_type": "weak_dp", "norm_bound": 5.0,
                                   "stddev": 0.025}, rounds=2)
    assert_slice_close(japi, tapi, rounds=2)
