"""The port's q-FedAvg against the reference's on the CPU: the server step
``qfedavg_update`` as an oracle on random trees, q = 0 reducing it to the
uniform mean of the client models, and the round at q = 1 on the CNN slice
(F_k one float32 forward at the broadcast model before local training).

Tolerances: the update to float32 rounding (rtol 1e-5, atol 1e-6: ‖g_k‖²
sums 1e4 squares in another order); the slice as the FedAvg slice is held
(rtol 1e-4, atol 1e-5 on the params, 1e-4 on the rows)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from fedml_tpu.algorithms.qfedavg import QFedAvgAPI as JaxQFedAvg  # noqa: E402
from fedml_tpu.algorithms.qfedavg import qfedavg_update as jax_qfedavg_update  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.algorithms.qfedavg import QFedAvgAPI, qfedavg_update  # noqa: E402
from fedml_tpu_torch.data.synthetic import synthetic_classification  # noqa: E402

from torch_parity import (  # noqa: E402
    assert_slice_close, lr_config, lr_data, private_reference_programs,
    torch_lr_model, trained_pair,
)


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _trees(seed, K=5):
    rng = np.random.default_rng(seed)
    shapes = {"a": (30, 40), "b": (70,)}
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    c = {k: (g[k][None] + 0.1 * rng.normal(size=(K,) + s)).astype(np.float32)
         for k, s in shapes.items()}
    losses = rng.uniform(0.2, 3.0, size=K).astype(np.float32)
    return g, c, losses


@pytest.mark.parametrize("q", [0.0, 0.5, 1.0, 2.0])
def test_update_matches_reference(q):
    g, c, losses = _trees(int(q * 10))
    want = jax_qfedavg_update({k: jax.numpy.asarray(v) for k, v in g.items()},
                              {k: jax.numpy.asarray(v) for k, v in c.items()},
                              jax.numpy.asarray(losses), 0.1, q)
    got = qfedavg_update({k: torch.from_numpy(v) for k, v in g.items()},
                         {k: torch.from_numpy(v) for k, v in c.items()},
                         torch.from_numpy(losses), 0.1, q)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6)


def test_q0_is_the_uniform_mean():
    """Δ_k = g_k and h_k = 1/lr, so w − lr/K·Σ (w − w_k)/lr = mean_k w_k.
    Tolerance: float32 rounding of the two expressions (atol 1e-6)."""
    g, c, losses = _trees(3)
    got = qfedavg_update({k: torch.from_numpy(v) for k, v in g.items()},
                         {k: torch.from_numpy(v) for k, v in c.items()},
                         torch.from_numpy(losses), 0.1, 0.0)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), c[k].mean(axis=0), rtol=0, atol=1e-6)


def test_q1_slice_matches_reference():
    japi, tapi = trained_pair(JaxQFedAvg, QFedAvgAPI, jax_kw={"q": 1.0}, torch_kw={"q": 1.0})
    tapi.train()
    assert_slice_close(japi, tapi)


@pytest.mark.parametrize("train", [{"momentum": 0.9}, {"client_optimizer": "adam"}])
def test_refuses_other_than_plain_sgd(train):
    with pytest.raises(ValueError, match="q-FedAvg"):
        QFedAvgAPI(lr_config(tcfg, {"lr": 0.1, **train}), lr_data(synthetic_classification),
                   torch_lr_model(), device="cpu")
