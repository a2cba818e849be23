"""Hierarchical (cloud-edge-device) FedAvg (port of
``fedml_tpu/algorithms/hierarchical.py``).

Clients belong to groups (edge servers). Each global round, every group runs
``group_comm_round`` FedAvg sub-rounds over its sampled clients starting
from the global model, then the cloud averages the group models weighted by
the groups' sample counts. With ``group_comm_round`` 1 this is flat FedAvg
under any split of the clients into groups.

The shuffles are keyed per group and sub-round. A sub-round's batch is
stacked with seed ``seed·1,000,003 + r·131 + gi·17 + sub``; its local
shuffles and step seeds are those of a FedAvg round whose index is
:func:`sub_round_key`: the reference folds ``(r+1)·1009 + gi·31 + sub`` into
its run key where a FedAvg round folds ``r + 1``, so ``perm_fn`` sees the
sub-round as the round ``(r+1)·1009 + gi·31 + sub − 1``."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import (
    _METRIC_KEYS, FedAvgAPI, make_fedavg_round, weighted_average,
)
from fedml_tpu_torch.device import fp32_math


def assign_groups(num_clients: int, group_num: int, seed: int = 0) -> List[np.ndarray]:
    """A random balanced client → group assignment."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_clients)
    return [np.sort(g) for g in np.array_split(perm, group_num)]


def resolve_groups(groups, num_clients: int, group_num: int, seed: int) -> List[np.ndarray]:
    """An explicit group list as arrays, or :func:`assign_groups`."""
    if groups is not None:
        return [np.asarray(g) for g in groups]
    return assign_groups(num_clients, group_num, seed=seed)


def _add(sums, metrics):
    return metrics if sums is None else {k: sums[k] + metrics[k] for k in sums}


def sub_round_key(round_idx: int, group: int, sub: int) -> int:
    """The round index ``perm_fn`` and the step seeds see for sub-round
    ``sub`` of group ``group`` in global round ``round_idx``."""
    return (round_idx + 1) * 1009 + group * 31 + sub - 1


class HierarchicalFedAvgAPI(FedAvgAPI):
    """Two-level FedAvg simulator: the FedAvg round runs every group
    sub-round; only the orchestration differs. No per-client loss vectors:
    the groups' cohorts are ragged, and power-of-choice takes the cohort
    mean here, as in the reference."""

    def __init__(self, config, data, model, groups: Sequence[np.ndarray] = None, **kw):
        super().__init__(config, data, model, **kw)
        self.groups = resolve_groups(groups, data.num_clients, config.fed.group_num, config.seed)

    def _build_round_fn(self, local_train_fn):
        return make_fedavg_round(self.model, self.config, task=self.task,
                                 local_train_fn=local_train_fn)

    def _group_round(self, round_idx: int, gi: int, members, sampled_set):
        """One group's sub-rounds from the current global model:
        ``(w_group | None, weight, metric sums | None)``. The round
        functions return new tensors, so the global model is never
        overwritten by a group."""
        cfg = self.config
        g_clients = [int(c) for c in members if int(c) in sampled_set]
        if not g_clients:
            return None, 0, None
        w_group, sums = self.global_vars, None
        for sub in range(cfg.fed.group_comm_round):
            batch = self._stack(g_clients, cfg.seed * 1_000_003 + round_idx * 131 + gi * 17 + sub)
            placed = self._place_batch(batch, sub_round_key(round_idx, gi, sub))
            with fp32_math():
                w_group, m = self.round_fn(w_group, *placed)
            sums = _add(sums, m)
        weight = sum(len(self.data.client_y[c]) for c in g_clients)
        return w_group, weight, sums

    def _cloud_average(self, group_vars, group_weights):
        """The groups' models weighted by their sample counts; a round in
        which no group had a sampled client keeps the global model."""
        if not group_vars:
            return self.global_vars
        stacked = {k: torch.stack([g[k] for g in group_vars]) for k in group_vars[0]}
        weights = torch.tensor(group_weights, dtype=torch.float32, device=self.device)
        with fp32_math():
            return weighted_average(stacked, weights)

    def train_round(self, round_idx: int):
        sampled = self._round_plan(round_idx)
        sampled_set = {int(i) for i in sampled}
        group_vars, group_weights, sums = [], [], None
        for gi, members in enumerate(self.groups):
            w_group, weight, m = self._group_round(round_idx, gi, members, sampled_set)
            if w_group is None:
                continue
            group_vars.append(w_group)
            group_weights.append(weight)
            sums = _add(sums, m)
        self.global_vars = self._cloud_average(group_vars, group_weights)
        if sums is None:  # no group had a sampled client
            sums = {k: torch.zeros((), device=self.device) for k in _METRIC_KEYS}
        return sampled, sums
