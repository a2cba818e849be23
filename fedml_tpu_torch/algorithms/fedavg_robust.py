"""FedAvg-robust — FedAvg with a defense inserted into the round (port of
``fedml_tpu/algorithms/fedavg_robust.py``).

Norm-difference clipping transforms each client's result before the
average, and weak DP adds Gaussian noise to the average after it; the
Byzantine aggregators replace the average: the median and the trimmed mean
on kernel K1, once per weight leaf per round, Krum and Multi-Krum on one
Gram product of the client matrix."""

from __future__ import annotations

import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, make_fedavg_round
from fedml_tpu_torch.robustness import (
    RobustConfig,
    add_gaussian_noise,
    make_byzantine_aggregate,
    norm_diff_clip_tree,
)


def clip_clients(client_vars, global_vars, robust: RobustConfig):
    """Each client's weights clipped to ``norm_bound`` around the global
    model, for the clip defenses (the others pass through)."""
    if robust.defense_type in ("norm_diff_clipping", "weak_dp"):
        return torch.func.vmap(
            lambda cv: norm_diff_clip_tree(cv, global_vars, robust.norm_bound)
        )(client_vars)
    return client_vars


def make_defense_hooks(robust: RobustConfig):
    """defense config → (post_train, post_aggregate, aggregate_fn), the
    hook triple the round skeleton takes; the round's extra argument is its
    noise draw."""

    def post_train(client_vars, global_vars, noise_draw=None):
        return clip_clients(client_vars, global_vars, robust)

    def post_aggregate(new_global, noise_draw=None):
        if robust.defense_type == "weak_dp":
            return add_gaussian_noise(new_global, noise_draw, robust.stddev)
        return new_global

    return post_train, post_aggregate, make_byzantine_aggregate(robust)


class RobustFedAvgAPI(FedAvgAPI):
    """FedAvg simulator with robust aggregation."""

    def __init__(self, config, data, model, robust: RobustConfig = RobustConfig(), **kw):
        self.robust = robust
        super().__init__(config, data, model, **kw)

    def _build_round_fn(self, local_train_fn):
        return make_fedavg_round(
            self.model, self.config, task=self.task, local_train_fn=local_train_fn,
            robust=self.robust, client_metrics=self.scheduler.wants_client_losses,
        )

    def _place_batch(self, batch, round_idx: int):
        return super()._place_batch(batch, round_idx) + (self._noise_draw(round_idx),)
