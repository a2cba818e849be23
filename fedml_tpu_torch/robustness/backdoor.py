"""The backdoor attack harness (port of ``fedml_tpu/robustness/backdoor.py``):
model-replacement boosting against the robust defenses.

Attacker clients train on locally poisoned shards (data/edge_cases.py) and
boost their upload toward model replacement, ``w_i ← w_g + γ·(w_i − w_g)``
on every leaf; with γ near the cohort size the boosted update survives the
average and installs the backdoor in one round. The defense runs after the
boost, on the server's side: norm-difference clipping bounds exactly the
boosted quantity, the median and trimmed mean (kernel K1) and Krum order
the clients around it."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import make_fedavg_round
from fedml_tpu_torch.algorithms.fedavg_robust import RobustFedAvgAPI, make_defense_hooks
from fedml_tpu_torch.robustness.robust_aggregation import RobustConfig


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    attacker_ids: tuple = ()
    boost: float = 10.0  # γ; ≈ client_num_per_round for full replacement


def boost_attackers(client_vars, global_vars, attack_mask: torch.Tensor, boost: float):
    """``w_g + γ·(w_i − w_g)`` for the clients whose mask is set, on every
    leaf (a factor of 1 leaves the others as they are)."""
    gamma = torch.where(
        attack_mask > 0, torch.full_like(attack_mask, boost), torch.ones_like(attack_mask)
    )
    return {
        k: global_vars[k] + gamma.reshape((-1,) + (1,) * (cv.ndim - 1)) * (cv - global_vars[k])
        for k, cv in client_vars.items()
    }


def make_attack_hooks(robust: RobustConfig, attack: AttackConfig):
    """(post_train, post_aggregate, aggregate_fn) of the attacked round:
    the defense's hooks (:func:`make_defense_hooks`) with the attackers'
    boost ahead of its ``post_train``. The round's extra arguments are its
    noise draw and attack mask."""
    defense_train, defense_aggregate, aggregate_fn = make_defense_hooks(robust)

    def post_train(client_vars, global_vars, noise_draw, attack_mask):
        client_vars = boost_attackers(client_vars, global_vars, attack_mask, attack.boost)
        return defense_train(client_vars, global_vars, noise_draw)

    def post_aggregate(new_global, noise_draw, attack_mask):
        return defense_aggregate(new_global, noise_draw)

    return post_train, post_aggregate, aggregate_fn


class BackdoorFedAvgAPI(RobustFedAvgAPI):
    """RobustFedAvgAPI under attack: the attackers' shards should be
    poisoned (data/edge_cases.py); their uploads are boosted inside the
    round, then the configured defense runs. The attack mask follows the
    round's actual cohort (:meth:`_round_plan`: the scheduler's policy
    less the fault plan's drops)."""

    def __init__(self, config, data, model, robust=RobustConfig(), attack=AttackConfig(), **kw):
        self.attack = attack
        self._attacker_set = set(int(a) for a in attack.attacker_ids)
        super().__init__(config, data, model, robust=robust, **kw)

    def _build_round_fn(self, local_train_fn):
        post_train, post_aggregate, aggregate_fn = make_attack_hooks(self.robust, self.attack)
        return make_fedavg_round(
            self.model, self.config, task=self.task, local_train_fn=local_train_fn,
            post_train=post_train, post_aggregate=post_aggregate, aggregate_fn=aggregate_fn,
            client_metrics=self.scheduler.wants_client_losses,
        )

    def _place_batch(self, batch, round_idx: int):
        placed = super()._place_batch(batch, round_idx)  # ends with the noise draw
        sampled = self._round_plan(round_idx)
        mask = np.array([1.0 if int(c) in self._attacker_set else 0.0 for c in sampled], np.float32)
        return placed + (torch.from_numpy(mask).to(self.device),)
