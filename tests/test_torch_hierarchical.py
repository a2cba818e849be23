"""The port's hierarchical FedAvg against the reference's on the CPU: 2
groups × 2 sub-rounds on the CNN slice with the reference's per-group,
per-sub-round shuffles, and ``group_comm_round`` 1 reducing to flat FedAvg.

Tolerances: the slice as the FedAvg slice is held (rtol 1e-4, atol 1e-5 on
the params, 1e-4 on the rows: the same float32 steps in another library,
twice as many a round); flat FedAvg to float32 rounding (atol 1e-6: the
cloud average re-weights the group models)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from fedml_tpu.algorithms.hierarchical import HierarchicalFedAvgAPI as JaxHier  # noqa: E402
from fedml_tpu.algorithms.hierarchical import assign_groups as jax_assign_groups  # noqa: E402

from fedml_tpu_torch.algorithms import FedAvgAPI  # noqa: E402
from fedml_tpu_torch.algorithms.hierarchical import (  # noqa: E402
    HierarchicalFedAvgAPI, assign_groups, sub_round_key,
)

from torch_parity import (  # noqa: E402
    SLICE, assert_slice_close, jax_round_perm_fn, lr_pair,
    private_reference_programs, trained_pair,
)


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _reference_perms(tapi, rounds: int):
    """The reference's shuffles: each sub-round's key split over its
    group's sampled clients."""
    sizes = {}
    for r in range(rounds):
        sampled = {int(c) for c in tapi._round_plan(r)}
        for gi, members in enumerate(tapi.groups):
            for sub in range(tapi.config.fed.group_comm_round):
                sizes[sub_round_key(r, gi, sub)] = sum(int(c) in sampled for c in members)
    return jax_round_perm_fn(SLICE["seed"], sizes.__getitem__)


@pytest.mark.parametrize("n,groups", [(12, 2), (10, 3), (7, 7)])
def test_group_assignment_matches_reference(n, groups):
    want = jax_assign_groups(n, groups, seed=3)
    got = assign_groups(n, groups, seed=3)
    assert [g.tolist() for g in got] == [np.asarray(g).tolist() for g in want]


def test_two_groups_two_sub_rounds_match_reference():
    fed = {"group_num": 2, "group_comm_round": 2}
    japi, tapi = trained_pair(JaxHier, HierarchicalFedAvgAPI, fed=fed)
    tapi.perm_fn = _reference_perms(tapi, SLICE["rounds"])
    tapi.train()
    assert_slice_close(japi, tapi)


def test_one_sub_round_is_flat_fedavg():
    """group_comm_round 1 under 2 groups: each group averages its clients,
    the cloud re-weights the group averages by their sample counts, which
    is the flat weighted average (full batch, so the shuffles play no
    part)."""
    fed = {"group_num": 2, "group_comm_round": 1}
    _, hier = lr_pair(JaxHier, HierarchicalFedAvgAPI, fed=fed)
    _, flat = lr_pair(JaxHier, FedAvgAPI, fed=fed)
    hier.train()
    flat.train()
    assert len(hier.groups) == 2
    for k, v in flat.global_vars.items():
        torch.testing.assert_close(hier.global_vars[k], v, rtol=0, atol=1e-6)
    for h, f in zip(hier.history, flat.history, strict=True):
        assert abs(h["Train/Loss"] - f["Train/Loss"]) <= 1e-6


def test_empty_round_keeps_the_global_model():
    """Explicit groups that miss the cohort: the global model stays."""
    _, tapi = lr_pair(JaxHier, HierarchicalFedAvgAPI, torch_kw={"groups": [[]]})
    before = {k: v.clone() for k, v in tapi.global_vars.items()}
    tapi.train_round(0)
    for k, v in before.items():
        assert torch.equal(tapi.global_vars[k], v)
