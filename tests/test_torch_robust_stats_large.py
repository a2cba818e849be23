"""K1 for cohorts above 16 clients (the port's chunk kernel on the card):
the port's plain version — what its wrapper runs on a CPU tensor, and what
the CUDA kernel is held bit-equal to on the card — against the reference's
sort path, its Pallas kernel in interpret mode and the sort definition, at
C in {65, 128, 200}; and RobustFedAvgAPI with 70 clients a round against
the reference's, on the transport tests' logistic-regression model."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import fedml_tpu.config as jcfg  # noqa: E402
from fedml_tpu.ops.robust_stats import median_1d as jax_median_1d  # noqa: E402
from fedml_tpu.ops.robust_stats import trimmed_mean_1d as jax_trimmed_mean_1d  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.ops import robust_stats as rs  # noqa: E402

from torch_parity import LR, jax_round_perm_fn, private_reference_programs  # noqa: E402



def tol(C):
    """rtol 1e-6 with atol 2e-7 (test_torch_robust_stats.py's atol 1e-7 is
    for cohorts up to 16): the kept values are summed in float32 in index
    order here and in sorted order (or XLA's pairwise order) in the
    reference, and the rounding of a float32 sum grows with its number of
    terms. Measured, the largest error beyond rtol over these cases is
    0.90e-7, 1.27e-7 and 0.86e-7 at C = 65, 128 and 200. A wrong rank keeps
    a wrong order statistic and moves a coordinate by the gap between two
    of them over C - 2k: on these inputs 0.8e-3 to 1.9e-3 at the median
    coordinate, four orders of magnitude above this limit."""
    return dict(rtol=1e-6, atol=2e-7)


def _x(C, D, seed):
    return np.random.default_rng(seed).normal(size=(C, D)).astype(np.float32)


def _ks(C):
    return sorted({0, 1, C // 4, C // 2 - 1, rs.median_trim_k(C)})


@pytest.mark.parametrize("D", [1, 300])
@pytest.mark.parametrize("C", [65, 128, 200])
def test_plain_matches_reference_sort_path(C, D):
    x = _x(C, D, 7 * C + D)
    for k in _ks(C):
        got = rs.trimmed_mean_1d(torch.from_numpy(x), k)
        want = jax_trimmed_mean_1d(jnp.asarray(x), k, use_kernel=False)
        assert got.dtype == torch.float32 and got.shape == (D,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol(C), err_msg=f"k={k}")
        np.testing.assert_allclose(
            got.numpy(), rs.trimmed_mean_sort(torch.from_numpy(x), k).numpy(), **tol(C)
        )
    np.testing.assert_allclose(
        rs.median_1d(torch.from_numpy(x)).numpy(),
        np.asarray(jax_median_1d(jnp.asarray(x), use_kernel=False)), **tol(C),
    )


@pytest.mark.parametrize("C", [65, 128, 200])
def test_integer_ties_equal_the_reference_exactly(C):
    """Integer-valued floats sum exactly: under heavy ties only the kept
    multiset decides the result, so the stable index tie-break must keep
    what the reference's sort window keeps, bit for bit."""
    x = np.random.default_rng(C).integers(-4, 5, size=(C, 300)).astype(np.float32)
    for k in _ks(C):
        got = rs.trimmed_mean_1d(torch.from_numpy(x), k)
        s = np.sort(x, axis=0)[k : C - k].sum(axis=0)
        np.testing.assert_array_equal(got.numpy(), (s / np.float32(C - 2 * k)).astype(np.float32))
        want = jax_trimmed_mean_1d(jnp.asarray(x), k, use_kernel=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-7)


def test_plain_matches_reference_kernel_in_interpret_mode():
    C, D = 65, 300
    x = _x(C, D, 3)
    for k in (1, rs.median_trim_k(C)):
        got = rs.trimmed_mean_1d(torch.from_numpy(x), k)
        want = jax_trimmed_mean_1d(jnp.asarray(x), k, use_kernel=True, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol(C))


@pytest.mark.parametrize("C,k", [(65, 33), (128, 64), (200, -1)])
def test_trim_window_is_the_only_limit(C, k):
    with pytest.raises(ValueError, match="trim_k"):
        rs.trimmed_mean_1d(torch.zeros(C, 4), k)


def _robust_case(cfg_mod, per_round: int):
    return cfg_mod.RunConfig(
        data=cfg_mod.DataConfig(batch_size=-1),
        fed=cfg_mod.FedConfig(client_num_in_total=80, client_num_per_round=per_round,
                              comm_round=2, epochs=1, frequency_of_the_test=1),
        train=cfg_mod.TrainConfig(lr=0.1),
        seed=LR["seed"],
    )


@pytest.mark.parametrize(
    "robust", [{"defense_type": "median"}, {"defense_type": "trimmed_mean", "num_byzantine": 5}],
    ids=lambda r: r["defense_type"],
)
def test_robust_round_with_70_clients_matches_reference(robust, tmp_path):
    """Two rounds of 70 of 80 clients (full batch, so the shuffles do not
    matter): the same cohorts, and the params within the robust-round
    test's tolerance."""
    import jax

    from fedml_tpu.algorithms.fedavg_robust import RobustFedAvgAPI as JaxRobust
    from fedml_tpu.data.synthetic import synthetic_classification as jax_synthetic
    from fedml_tpu.models import create_model as jax_create_model
    from fedml_tpu.robustness import RobustConfig as JaxRobustConfig

    from fedml_tpu_torch.algorithms import RobustFedAvgAPI
    from fedml_tpu_torch.bridge import from_flax, to_flax
    from fedml_tpu_torch.data.synthetic import synthetic_classification
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.robustness import RobustConfig

    per_round = 70
    data_kw = dict(num_clients=80, num_classes=3, feat_shape=(5,), samples_per_client=12,
                   partition_method="homo", seed=LR["data_seed"])
    with private_reference_programs(tmp_path):
        japi = JaxRobust(_robust_case(jcfg, per_round), jax_synthetic(**data_kw),
                         jax_create_model("lr", "synthetic", (5,), 3),
                         robust=JaxRobustConfig(**robust))
        tapi = RobustFedAvgAPI(_robust_case(tcfg, per_round), synthetic_classification(**data_kw),
                               create_model("lr", "synthetic", (5,), 3),
                               robust=RobustConfig(**robust), device="cpu",
                               perm_fn=jax_round_perm_fn(LR["seed"], per_round))
        tapi.global_vars = from_flax(jax.device_get(japi.global_vars)["params"])
        for r in range(2):
            assert np.array_equal(np.asarray(tapi.scheduler.select(r)),
                                  np.asarray(japi.scheduler.select(r)))
        japi.train()
        tapi.train()
    got, want = to_flax(tapi.global_vars)["linear"], jax.device_get(japi.global_vars)["params"]["linear"]
    for leaf in want:
        np.testing.assert_allclose(got[leaf], np.asarray(want[leaf]), rtol=1e-4, atol=1e-5,
                                   err_msg=leaf)
    for trow, jrow in zip(tapi.history, japi.history, strict=True):
        assert abs(trow["Test/Acc"] - jrow["Test/Acc"]) <= 1e-4
