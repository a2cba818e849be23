"""The backdoor harness (``data/edge_cases.py``,
``robustness/backdoor.py``) against ``fedml_tpu`` on the CPU:

- ``poison_clients`` poisons the same samples the same way (the arrays are
  equal), and the triggered test set is the reference's;
- one attacked round of the FEMNIST slice (two attackers, one of them in
  the round's cohort, boost γ = 10) under norm-difference clipping, the
  coordinate median (K1's plain version here) and Krum, from the
  reference's init with its shuffles, matches the reference's at the
  slice's tolerance; the attack mask follows the round's cohort;
- the attack success rate of the two runs is equal."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from fedml_tpu.data.edge_cases import PoisonSpec as JaxSpec  # noqa: E402
from fedml_tpu.data.edge_cases import attack_success_rate as jax_asr  # noqa: E402
from fedml_tpu.data.edge_cases import backdoor_test_set as jax_test_set  # noqa: E402
from fedml_tpu.data.edge_cases import poison_clients as jax_poison  # noqa: E402
from fedml_tpu.robustness import RobustConfig as JaxRobustConfig  # noqa: E402
from fedml_tpu.robustness.backdoor import AttackConfig as JaxAttack  # noqa: E402
from fedml_tpu.robustness.backdoor import BackdoorFedAvgAPI as JaxBackdoor  # noqa: E402

from fedml_tpu_torch.data.edge_cases import (  # noqa: E402
    PoisonSpec, apply_trigger, attack_success_rate, backdoor_test_set, poison_clients,
)
from fedml_tpu_torch.robustness import RobustConfig  # noqa: E402
from fedml_tpu_torch.robustness.backdoor import AttackConfig, BackdoorFedAvgAPI  # noqa: E402
from fedml_tpu_torch.scheduler import select_clients  # noqa: E402

from torch_parity import (  # noqa: E402
    SLICE, assert_slice_close, jax_noise_fn, jax_round_perm_fn, private_reference_programs,
    share_init, slice_configs, slice_data, slice_models,
)

SPEC = dict(target_label=3, poison_frac=0.5, trigger_size=3, trigger_value=2.5)


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _attackers(per_round: int):
    """A client of round 0's cohort and one that sits it out."""
    r0 = [int(c) for c in select_clients(0, SLICE["num_clients"], per_round)]
    return (r0[0], next(c for c in range(SLICE["num_clients"]) if c not in r0))


def test_poisoned_shards_and_test_set_equal_the_reference():
    jdata, tdata = slice_data()
    ids = _attackers(4)
    jp = jax_poison(jdata, ids, JaxSpec(**SPEC), seed=5)
    tp = poison_clients(tdata, ids, PoisonSpec(**SPEC), seed=5)
    for c in range(SLICE["num_clients"]):
        np.testing.assert_array_equal(tp.client_x[c], jp.client_x[c])
        np.testing.assert_array_equal(tp.client_y[c], jp.client_y[c])
        assert np.array_equal(tp.client_x[c], tdata.client_x[c]) == (c not in ids)
    assert tp.name == jp.name
    for got, want in zip(backdoor_test_set(tp, PoisonSpec(**SPEC)),
                         jax_test_set(jp, JaxSpec(**SPEC)), strict=True):
        np.testing.assert_array_equal(got, want)
    flat = np.zeros((2, 20), np.float32)
    assert (apply_trigger(flat, PoisonSpec(**SPEC))[:, :9] == 2.5).all()


@pytest.mark.parametrize("defense,per_round", [
    ("norm_diff_clipping", 4), ("median", 4), ("krum", 6),
])
def test_attacked_rounds_match_the_reference(defense, per_round):
    (jdata, tdata), (jmodel, tmodel) = slice_data(), slice_models()
    ids = _attackers(per_round)
    jdata = jax_poison(jdata, ids, JaxSpec(**SPEC), seed=0)
    tdata = poison_clients(tdata, ids, PoisonSpec(**SPEC), seed=0)
    jconf, tconf = slice_configs(rounds=1, per_round=per_round)
    robust = dict(defense_type=defense, num_byzantine=1, norm_bound=2.0)
    japi = JaxBackdoor(jconf, jdata, jmodel, robust=JaxRobustConfig(**robust),
                       attack=JaxAttack(attacker_ids=ids, boost=10.0))
    tapi = BackdoorFedAvgAPI(tconf, tdata, tmodel, robust=RobustConfig(**robust),
                             attack=AttackConfig(attacker_ids=ids, boost=10.0), device="cpu",
                             perm_fn=jax_round_perm_fn(SLICE["seed"], per_round),
                             noise_fn=jax_noise_fn(SLICE["seed"]))
    share_init(japi, tapi)
    japi.train()
    tapi.train()
    assert_slice_close(japi, tapi, rounds=1)
    # the mask follows the round's cohort: the one attacker in it
    cohort = tapi._round_plan(0).tolist()
    mask = tapi._place_batch(tapi._round_batch(cohort, 0), 0)[-1]
    assert mask.tolist() == [1.0 if c == ids[0] else 0.0 for c in cohort] and ids[1] not in cohort
    want = jax_asr(jmodel, japi.global_vars, jdata, JaxSpec(**SPEC), eval_fn=japi.eval_fn)
    got = attack_success_rate(tmodel, tapi.global_vars, tdata, PoisonSpec(**SPEC),
                              eval_fn=tapi.eval_fn)
    assert got == want


def test_the_boost_replaces_the_model_without_a_defense():
    """no_defense: one boosted attacker moves the aggregate by far more
    than the clipped run does (the clip bounds exactly the boost)."""
    (_, tdata), (_, tmodel) = slice_data(), slice_models()
    ids = _attackers(4)
    tdata = poison_clients(tdata, ids, PoisonSpec(**SPEC), seed=0)
    _, tconf = slice_configs(rounds=1)
    moved = {}
    for defense in ("no_defense", "norm_diff_clipping"):
        api = BackdoorFedAvgAPI(tconf, tdata, tmodel,
                                robust=RobustConfig(defense_type=defense, norm_bound=0.5),
                                attack=AttackConfig(attacker_ids=ids, boost=10.0), device="cpu")
        init = {k: v.clone() for k, v in api.global_vars.items()}
        api.train()
        moved[defense] = torch.sqrt(sum(((api.global_vars[k] - init[k]) ** 2).sum() for k in init))
    assert moved["no_defense"] > 4 * moved["norm_diff_clipping"]
