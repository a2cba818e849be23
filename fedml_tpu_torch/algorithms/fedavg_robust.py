"""FedAvg-robust — FedAvg with a defense inserted into the round (port of
``fedml_tpu/algorithms/fedavg_robust.py``).

Norm-difference clipping transforms each client's result before the
average; the Byzantine aggregators (median, trimmed mean) replace the
average and run on kernel K1, once per weight leaf per round. Weak-DP noise
is still to port (ROADMAP.md)."""

from __future__ import annotations

import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, make_fedavg_round
from fedml_tpu_torch.robustness import (
    RobustConfig,
    make_byzantine_aggregate,
    norm_diff_clip_tree,
)


def make_defense_hooks(robust: RobustConfig):
    """defense config → (post_train, post_aggregate, aggregate_fn), the
    hook triple the round skeleton takes."""
    if robust.defense_type == "weak_dp":
        raise NotImplementedError("defense_type 'weak_dp' is not ported yet (ROADMAP.md)")

    def post_train(client_vars, global_vars):
        if robust.defense_type == "norm_diff_clipping":
            return torch.func.vmap(
                lambda cv: norm_diff_clip_tree(cv, global_vars, robust.norm_bound)
            )(client_vars)
        return client_vars

    return post_train, None, make_byzantine_aggregate(robust)


class RobustFedAvgAPI(FedAvgAPI):
    """FedAvg simulator with robust aggregation."""

    def __init__(self, config, data, model, robust: RobustConfig = RobustConfig(), **kw):
        self.robust = robust
        super().__init__(config, data, model, **kw)

    def _build_round_fn(self, local_train_fn):
        return make_fedavg_round(
            self.model, self.config, task=self.task, local_train_fn=local_train_fn,
            robust=self.robust,
        )
