"""FedOpt — FedAvg plus a server-side optimizer (port of
``fedml_tpu/algorithms/fedopt.py``).

After the weighted average, the server treats ``w_old − w_avg`` as a
gradient and steps its own optimizer on it. The optimizers follow optax's
formulas, not ``torch.optim``'s (fedml_tpu_torch/train/optim.py): Adam's eps
outside the square root with bias correction on both moments, Yogi's
moments starting at 1e-6, Adagrad's accumulator at 0.1. The server state
(moments) persists across rounds. :func:`make_server_step` is shared by the
simulator below and the transport server (algorithms/fedavg_transport.py),
so the pseudo-gradient math lives once.

Only the parameters go through the server optimizer, and its state covers
them alone; the running statistics of a BatchNorm model keep the plain
weighted average, as the reference's non-param collections do."""

from __future__ import annotations

from typing import Callable

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.config import RunConfig, ServerConfig
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.models import ModelDef, split_stats
from fedml_tpu_torch.train import optim


def make_server_optimizer(sc: ServerConfig) -> optim.GradientTransformation:
    """``ServerConfig.server_optimizer`` → optimizer (FedAdam and FedYogi
    with b1 0.9, b2 0.99 and eps τ, as the reference)."""
    name = sc.server_optimizer.lower()
    if name == "sgd":
        return optim.sgd(sc.server_lr)
    if name in ("momentum", "sgdm"):
        return optim.sgd(sc.server_lr, momentum=sc.server_momentum or 0.9)
    if name == "adam":
        return optim.adam(sc.server_lr, b1=0.9, b2=0.99, eps=sc.tau)
    if name == "yogi":
        return optim.yogi(sc.server_lr, b1=0.9, b2=0.99, eps=sc.tau)
    if name == "adagrad":
        return optim.adagrad(sc.server_lr, eps=sc.tau)
    raise ValueError(f"unknown server_optimizer {sc.server_optimizer!r}")


def make_server_step(opt: optim.GradientTransformation) -> Callable:
    """``(old_vars, avg_vars, opt_state) -> (new_vars, new_state)``: the
    FedOpt server move on the parameters' pseudo-gradient ``old − avg``;
    the running statistics are ``avg_vars``'."""

    def server_step(old_vars, avg_vars, opt_state):
        old, _ = split_stats(old_vars)
        pseudo_grad = {k: old[k] - avg_vars[k] for k in old}
        updates, new_state = opt.update(pseudo_grad, opt_state, old)
        return {**avg_vars, **optim.apply_updates(old, updates)}, new_state

    return server_step


class FedOptAPI(FedAvgAPI):
    """FedOpt simulator: FedAvgAPI with a server-optimizer step appended to
    each round."""

    def __init__(self, config: RunConfig, data: FederatedDataset, model: ModelDef, **kw):
        super().__init__(config, data, model, **kw)
        self.server_opt = make_server_optimizer(config.server)
        self._server_step = make_server_step(self.server_opt)
        self.server_opt_state = self.server_opt.init(split_stats(self.global_vars)[0])

    def train_round(self, round_idx: int):
        old_vars = self.global_vars
        sampled, metrics = super().train_round(round_idx)
        # super() set global_vars to the plain weighted average; redo them
        # through the server optimizer
        self.global_vars, self.server_opt_state = self._server_step(
            old_vars, self.global_vars, self.server_opt_state
        )
        return sampled, metrics
