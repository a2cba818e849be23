"""The port's FedNova against the reference's on the CPU: the round on the
CNN slice (ragged shards, so ragged τ_i), the closed-form accumulation
factor with momentum, a momentum round on the logistic-regression fixture,
and equal τ reducing to FedAvg.

Tolerances: the slice as the FedAvg slice is held (rtol 1e-4, atol 1e-5
on the params, 1e-4 on the rows: the same float32 steps summed in another
order by another library, over 3 rounds of batch-20 SGD); the factor to
float32 rounding (rtol 1e-6)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from fedml_tpu.algorithms.fednova import FedNovaAPI as JaxFedNova  # noqa: E402
from fedml_tpu.algorithms.fednova import _accum_factor as jax_accum_factor  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.algorithms import FedAvgAPI  # noqa: E402
from fedml_tpu_torch.algorithms.fednova import FedNovaAPI, _accum_factor  # noqa: E402
from fedml_tpu_torch.data.synthetic import synthetic_classification  # noqa: E402

from torch_parity import (  # noqa: E402
    assert_slice_close, lr_config, lr_data, lr_pair, private_reference_programs,
    torch_lr_model, trained_pair,
)


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def test_fednova_slice_matches_reference():
    japi, tapi = trained_pair(JaxFedNova, FedNovaAPI)
    tapi.train()
    assert_slice_close(japi, tapi)


@pytest.mark.parametrize("momentum", [0.0, 0.5, 0.9])
def test_accumulation_factor_matches_reference(momentum):
    tau = np.array([0.0, 1.0, 2.0, 7.0, 13.0], np.float32)
    want = np.asarray(jax_accum_factor(jax.numpy.asarray(tau), momentum))
    got = _accum_factor(torch.from_numpy(tau), momentum).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if momentum:  # the reference optimizer's step-by-step sum Σ (1 − ρ^k)/(1 − ρ)
        steps = [sum((1 - momentum**k) / (1 - momentum) for k in range(1, int(t) + 1))
                 for t in tau]
        np.testing.assert_allclose(got, steps, rtol=1e-5)


def test_momentum_round_matches_reference():
    """Local momentum 0.5, batch 4 (a few steps a client): a_i from the
    closed form on both sides."""
    japi, tapi = lr_pair(JaxFedNova, FedNovaAPI, train={"momentum": 0.5}, batch_size=4)
    japi.train()
    tapi.train()
    assert_slice_close(japi, tapi, rtol=1e-5, atol=1e-6, row_tol=1e-5, rounds=3)


def test_equal_steps_give_fedavg():
    """Every client one full-batch step (τ_i = 1): a_i = 1, τ_eff = 1 and
    the nova update is the weighted average. Tolerance: float32 rounding of
    the two expressions (atol 1e-6)."""
    _, nova = lr_pair(JaxFedNova, FedNovaAPI)
    _, avg = lr_pair(JaxFedNova, FedAvgAPI)
    nova.train()
    avg.train()
    for k, v in avg.global_vars.items():
        torch.testing.assert_close(nova.global_vars[k], v, rtol=0, atol=1e-6)


@pytest.mark.parametrize("train", [{"client_optimizer": "adam"}, {"prox_mu": 0.1}])
def test_refuses_what_the_closed_form_does_not_model(train):
    cfg = lr_config(tcfg, {"lr": 0.1, **train})
    with pytest.raises(ValueError, match="FedNova"):
        FedNovaAPI(cfg, lr_data(synthetic_classification), torch_lr_model(), device="cpu")
