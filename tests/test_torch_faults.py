"""The port's fault plans (scheduler/faults.py) against the reference's:

- ``FaultPlan.decide`` over a grid of (client, round) is the reference's
  for the same plan JSON (coin flips, crashes, device profiles, the fleet
  shorthand's tier assignment, scripted events), and so are ``tier_of``
  and ``to_json``;
- a ``FaultTrace`` round-trips to the reference's JSON bytes, and the plan
  replayed from it decides as the reference's does;
- the injector's ``summary_row`` and crash dedupe match;
- a loopback federation under a dropout and crash plan, with ``deadline_s``
  and ``min_clients``, equals the reference's from the same init: history
  rows (but their wall times), the ``faults/*`` row and the params within
  1e-5.

The federation test waits on deadlines and runs under its own time limit."""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import fedml_tpu.config as jcfg  # noqa: E402
from fedml_tpu.data.synthetic import synthetic_classification as jax_synthetic  # noqa: E402
from fedml_tpu.scheduler import faults as jfaults  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.algorithms.fedavg_transport import run_loopback_federation  # noqa: E402
from fedml_tpu_torch.bridge import from_flax, to_flax  # noqa: E402
from fedml_tpu_torch.data.synthetic import synthetic_classification  # noqa: E402
from fedml_tpu_torch.scheduler import faults as tfaults  # noqa: E402

from torch_parity import (  # noqa: E402
    LR, jax_lr_model, lr_config, lr_data, private_reference_programs, time_limit,
    torch_lr_model,
)

PLANS = {
    "coin_flips": {
        "seed": 3, "default": {"flaky_upload_p": 0.25},
        "clients": {"2": {"dropout_p": 0.5, "slowdown_s": 0.1}, "4": {"crash_at_round": 2}},
    },
    "profiles": {
        "seed": 7,
        "profiles": {"flaky_tier": {"dropout_p": 0.3, "flaky_upload_p": 0.4, "slowdown_s": 0.05}},
        "clients": {"0": "lowend_phone", "1": {"profile": "midrange_phone", "dropout_p": 0.5},
                    "5": "flaky_tier"},
    },
    "fleet": {
        "seed": 11, "num_clients": 40,
        "fleet": {"server_grade": 0.4, "midrange_phone": 0.35, "lowend_phone": 0.25},
        "clients": {"3": {"crash_at_round": 5}},
    },
    "scripted": {
        "seed": 2, "default": {"dropout_p": 0.2},
        "scripted": {"1": {"0": {"drop": True}, "3": {"flaky": True, "slowdown_s": 0.5}}},
    },
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_decides_as_the_reference(name):
    doc = PLANS[name]
    got, want = tfaults.FaultPlan.from_json(doc), jfaults.FaultPlan.from_json(doc)
    for cid in range(40):
        assert got.tier_of(cid) == want.tier_of(cid), cid
        for r in range(12):
            assert dataclasses.asdict(got.decide(cid, r)) == dataclasses.asdict(want.decide(cid, r)), (cid, r)
    assert got.has_participation_faults() == want.has_participation_faults()
    assert json.dumps(got.to_json(), sort_keys=True) == json.dumps(want.to_json(), sort_keys=True)
    spec = json.dumps(doc)
    assert tfaults.FaultPlan.from_spec(spec).to_json() == jfaults.FaultPlan.from_spec(spec).to_json()


@pytest.mark.parametrize("bad", ["{bad json", '{"clients": {"0": {"dropout": 1}}}',
                                 '{"default": {"dropout_p": 1.5}}', '{"num_clients": 3}'])
def test_malformed_plans_raise_as_the_reference(bad):
    with pytest.raises(ValueError) as want:
        jfaults.FaultPlan.from_spec(bad)
    with pytest.raises(ValueError) as got:
        tfaults.FaultPlan.from_spec(bad)
    assert str(got.value) == str(want.value)


def _trace_doc():
    return {"rounds": 6, "clients": {
        "0": {"faults": {"dropout": [[1, None], [4, None]], "slowdown": [[2, 0.25]]},
              "rounds_participated": 4, "last_seen_round": 5, "mean_train_s": 0.1,
              "p90_train_s": 0.2, "trace_complete": True},
        "3": {"faults": {"crash": [[3, None]], "flaky": [[0, None]]},
              "rounds_participated": 3, "last_seen_round": 2, "mean_train_s": 0.3,
              "p90_train_s": 0.4, "trace_complete": True},
    }}


def test_fault_trace_round_trips_to_the_reference_bytes(tmp_path):
    got = tfaults.FaultTrace.from_json(_trace_doc())
    want = jfaults.FaultTrace.from_json(_trace_doc())
    assert json.dumps(got.to_json()) == json.dumps(want.to_json())
    got.save(str(tmp_path / "port.json"))
    want.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    back = tfaults.FaultTrace.load(str(tmp_path / "ref.json"))
    assert json.dumps(back.to_json(), sort_keys=True) == json.dumps(want.to_json(), sort_keys=True)
    got_plan = tfaults.FaultPlan.from_spec(f"trace:{tmp_path / 'port.json'}")
    want_plan = jfaults.FaultPlan.from_spec(f"trace:{tmp_path / 'ref.json'}")
    for cid in range(5):
        for r in range(8):
            assert dataclasses.asdict(got_plan.decide(cid, r)) == dataclasses.asdict(
                want_plan.decide(cid, r)), (cid, r)


def test_injector_summary_row_and_crash_dedupe():
    spec = '{"clients": {"0": {"crash_at_round": 0}}}'
    got = tfaults.FaultInjector(tfaults.FaultPlan.from_spec(spec))
    want = jfaults.FaultInjector(jfaults.FaultPlan.from_spec(spec))
    for inj in (got, want):
        for r in range(5):
            inj.record(0, r, "crash")
        inj.record(1, 0, "dropout")
        inj.record(2, 1, "slowdown", detail=0.1)
    assert got.summary_row() == want.summary_row()
    assert got.summary_row()["faults/crashes"] == 1 and got.total() == want.total() == 3


# 4 clients all in every round; client 1 crashes from round 1, every client
# drops a quarter of its rounds. With min_clients 1 every round closes at
# the deadline on all its survivors (each trains in well under it)
FAULT_PLAN = {"seed": 1, "default": {"dropout_p": 0.25}, "clients": {"1": {"crash_at_round": 1}}}
DEADLINE = dict(deadline_s=1.5, min_clients=1)


def _cfg(cfg_mod, plan=True):
    cfg = lr_config(cfg_mod, dict(client_optimizer="sgd", lr=0.1))
    fed = dict(DEADLINE, fault_plan=json.dumps(FAULT_PLAN)) if plan else {}
    return cfg.replace(fed=dataclasses.replace(cfg.fed, frequency_of_the_test=1, **fed))


@time_limit(60)
def test_faulted_federation_matches_the_reference(tmp_path):
    from fedml_tpu.algorithms.fedavg_transport import run_loopback_federation as jax_loopback

    plan = tfaults.FaultPlan.from_json(FAULT_PLAN)
    lost = [[c for c in range(LR["num_clients"]) if not plan.decide(c, r).participates]
            for r in range(LR["rounds"])]
    assert all(lost) and all(len(x) < LR["num_clients"] for x in lost), lost  # the plan bites
    jdata = lr_data(jax_synthetic)
    jrows, trows = [], []
    with private_reference_programs(tmp_path):
        # a plain run first, so the faulted run's first round does not wait
        # on a compile
        jax_loopback(_cfg(jcfg, plan=False), jdata, jax_lr_model())
        jserver = jax_loopback(_cfg(jcfg), jdata, jax_lr_model(), log_fn=jrows.append)
    init = jax.device_get(jax_lr_model().init(jax.random.fold_in(jax.random.PRNGKey(LR["seed"]), 0)))
    tserver = run_loopback_federation(
        _cfg(tcfg), lr_data(synthetic_classification), torch_lr_model(), device="cpu",
        log_fn=trows.append, init_vars=from_flax(init["params"]),
    )
    assert tserver.round_idx == jserver.round_idx == LR["rounds"]
    assert tserver.dropped_uploads == jserver.dropped_uploads
    assert tserver.abandoned_rounds == jserver.abandoned_rounds

    def strip(rows):
        return [{k: v for k, v in r.items() if k != "t_s"} for r in rows]

    # the run's faults/* row is the last one logged; before it, each round's
    # scheduler row and history row, as the reference logs them
    jfault, tfault = jrows[-1], trows[-1]
    assert tfault == jfault and tfault["faults/dropouts"] == sum(len(x) for x in lost) - 2
    assert tfault["faults/crashes"] == 1

    def sched_rows(rows):
        return [r for r in rows if "scheduler/policy" in r]

    assert [r for r in trows[:-1] if "scheduler/policy" not in r] == tserver.history
    assert sched_rows(trows) == sched_rows(jrows) and len(sched_rows(trows)) == LR["rounds"]
    assert [list(r) for r in tserver.history] == [list(r) for r in jserver.history]
    for t, j in zip(strip(tserver.history), strip(jserver.history), strict=True):
        assert t.keys() == j.keys()
        for k in t:
            assert abs(t[k] - j[k]) <= 1e-5, (k, t[k], j[k])
    got = to_flax(tserver.global_vars)["linear"]
    want = jax.device_get(jserver.global_vars)["params"]["linear"]
    for leaf in want:
        np.testing.assert_allclose(got[leaf], np.asarray(want[leaf]), rtol=1e-5, atol=1e-5)
