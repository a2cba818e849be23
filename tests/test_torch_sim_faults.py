"""Fault plans in the simulator (``FedAvgAPI._apply_participation_faults``)
against ``fedml_tpu`` on the CPU, on the transport tests' full-batch
logistic-regression fixture (4 clients, all in every round) and on the
FEMNIST slice at batch 20:

- each round's survivors equal the reference's, a crashed client is
  counted once, and the ``faults/*`` row is the reference's;
- when the plan drops a whole cohort, the first selected client is spared
  and no fault is recorded for it;
- the rounds on the shrunken cohorts match the reference's (ROUND_TOL on
  the full-batch fixture; the slice's tolerance on the slice, whose
  shuffles split the round key over the surviving cohort, as the
  reference's do)."""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import fedml_tpu.config as jcfg  # noqa: E402
from fedml_tpu.algorithms import FedAvgAPI as JaxFedAvg  # noqa: E402
from fedml_tpu.data.synthetic import synthetic_classification as jax_synthetic  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.algorithms import FedAvgAPI, RobustFedAvgAPI  # noqa: E402
from fedml_tpu_torch.data.synthetic import synthetic_classification  # noqa: E402
from fedml_tpu_torch.robustness import RobustConfig  # noqa: E402

from torch_parity import (  # noqa: E402
    assert_slice_close, jax_lr_model, jax_round_perm_fn, lr_config, lr_data,
    private_reference_programs, share_init, slice_configs, slice_data, slice_models,
    torch_lr_model,
)

# full batch: one step of every sample, so only summation order differs
ROUND_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _with_plan(cfg, plan: dict, **fed):
    return cfg.replace(fed=dataclasses.replace(cfg.fed, fault_plan=json.dumps(plan), **fed))


def _lr_pair(plan, rounds=3):
    jc = _with_plan(lr_config(jcfg, dict(lr=0.1)), plan, comm_round=rounds)
    tc = _with_plan(lr_config(tcfg, dict(lr=0.1)), plan, comm_round=rounds)
    japi = JaxFedAvg(jc, lr_data(jax_synthetic), jax_lr_model())
    tapi = FedAvgAPI(tc, lr_data(synthetic_classification), torch_lr_model(), device="cpu")
    share_init(japi, tapi)
    return japi, tapi


def _assert_close(tapi, japi):
    for t, j in zip(tapi.history, japi.history, strict=True):
        for k in j:
            if k != "round_time_s":
                assert abs(t[k] - j[k]) <= ROUND_TOL * max(1.0, abs(j[k])), (k, t[k], j[k])
    got = tapi.global_vars
    want = jax.device_get(japi.global_vars)["params"]["linear"]
    np.testing.assert_allclose(got["linear.weight"].numpy().T, want["kernel"], atol=ROUND_TOL)
    np.testing.assert_allclose(got["linear.bias"].numpy(), want["bias"], atol=ROUND_TOL)


PLANS = {
    "dropout": {"seed": 3, "default": {"dropout_p": 0.4}},
    "crash": {"seed": 1, "default": {"dropout_p": 0.2}, "clients": {"2": {"crash_at_round": 1}}},
    "scripted": {"scripted": {"0": {"1": {"drop": True}}, "3": {"0": {"drop": True},
                                                                "2": {"drop": True}}}},
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_survivors_counters_and_rounds_equal_the_reference(name):
    japi, tapi = _lr_pair(PLANS[name])
    japi.train()
    tapi.train()
    survivors = [tapi._round_plan(r).tolist() for r in range(3)]
    assert survivors == [japi._round_plan(r)[0].tolist() for r in range(3)]
    assert any(len(s) < 4 for s in survivors)  # the plan removed someone
    assert tapi.faults.summary_row() == japi.faults.summary_row()
    assert tapi.faults.summary_row()["faults/total"] == sum(4 - len(s) for s in survivors) \
        or name == "crash"  # a crash is one event, however many rounds it silences
    _assert_close(tapi, japi)


def test_a_whole_dropped_cohort_spares_its_first_client():
    plan = {"default": {"dropout_p": 1.0}}
    japi, tapi = _lr_pair(plan, rounds=2)
    japi.train()
    tapi.train()
    for r in range(2):
        sel = tapi.scheduler.select(r).tolist()
        assert tapi._round_plan(r).tolist() == [sel[0]] == japi._round_plan(r)[0].tolist()
    row = tapi.faults.summary_row()
    assert row == japi.faults.summary_row() and row["faults/dropouts"] == 2 * 3
    _assert_close(tapi, japi)


def test_faulted_robust_rounds_of_the_slice_match_the_reference():
    """The FEMNIST slice at batch 20 under median with 6 of 12 clients a
    round and a dropout plan, 2 rounds: the shuffles split the round key
    over the surviving cohort (as the reference's do)."""
    from fedml_tpu.algorithms.fedavg_robust import RobustFedAvgAPI as JaxRobust
    from fedml_tpu.robustness import RobustConfig as JaxRobustConfig

    plan = {"seed": 2, "default": {"dropout_p": 0.3}}
    (jdata, tdata), (jmodel, tmodel) = slice_data(), slice_models()
    jconf, tconf = slice_configs(rounds=2, per_round=6)
    jconf, tconf = _with_plan(jconf, plan), _with_plan(tconf, plan)
    japi = JaxRobust(jconf, jdata, jmodel, robust=JaxRobustConfig(defense_type="median"))
    holder = []
    tapi = RobustFedAvgAPI(tconf, tdata, tmodel, robust=RobustConfig(defense_type="median"),
                           device="cpu",
                           perm_fn=jax_round_perm_fn(0, lambda r: len(holder[0]._round_plan(r))))
    holder.append(tapi)
    share_init(japi, tapi)
    japi.train()
    tapi.train()
    assert [len(tapi._round_plan(r)) for r in range(2)] != [6, 6]
    assert tapi.faults.summary_row() == japi.faults.summary_row()
    assert_slice_close(japi, tapi, rounds=2)
