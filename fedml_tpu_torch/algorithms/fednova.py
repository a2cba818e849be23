"""FedNova — normalized averaging (port of ``fedml_tpu/algorithms/fednova.py``,
its single-device round).

Clients with ragged shards run ragged numbers of local steps τ_i, and plain
FedAvg then over-weights the clients that ran more. FedNova normalizes each
client's cumulative update by its step-accumulation factor a_i and rescales
by the effective τ:

    d_i   = (w_g − w_i) / a_i
    τ_eff = Σ p_i a_i          (p_i = n_i / Σ n)
    w'    = w_g − τ_eff Σ p_i d_i

For plain SGD a_i = τ_i; with local momentum ρ, a_i = (τ_i − ρ(1 − ρ^τ_i)
/ (1 − ρ)) / (1 − ρ), the closed form of the reference optimizer's
``local_normalizing_vec``. τ_i is the local train's ``steps`` metric: the
steps that carried data (an all-padding step is skipped and not counted),
so a client without data has a_i = 0 and contributes nothing. Only the
parameters take the nova update; the running statistics take the weighted
mean, as in FedAvg."""

from __future__ import annotations

import torch

from fedml_tpu_torch.algorithms.fedavg import _METRIC_KEYS, FedAvgAPI, train_clients
from fedml_tpu_torch.models import ModelDef, split_stats
from fedml_tpu_torch.train.client import make_local_train

_STEPS = _METRIC_KEYS.index("steps")


def _accum_factor(tau, momentum: float):
    """Closed form of the reference's ``local_normalizing_vec`` after
    ``tau`` steps."""
    if momentum:
        rho = momentum
        return (tau - rho * (1.0 - rho**tau) / (1.0 - rho)) / (1.0 - rho)
    return tau


def _validate_and_build(model: ModelDef, config, task: str, local_train_fn):
    """The guard: the closed-form a_i models plain and momentum SGD only."""
    if config.train.client_optimizer != "sgd":
        raise ValueError(
            f"FedNova requires client_optimizer='sgd' (got {config.train.client_optimizer!r})"
        )
    if config.train.prox_mu:
        raise ValueError("FedNova with prox_mu is not supported")
    local_train = local_train_fn or make_local_train(
        model, config.train, config.fed.epochs, task=task
    )
    return local_train, config.train.momentum


def nova_average(global_vars, client_vars, num_samples, tau, momentum: float):
    """The server step from the stacked client results, ``tau`` [C] the
    clients' data-carrying steps."""
    p = num_samples / torch.sum(num_samples)
    a = _accum_factor(tau, momentum)
    # a client without data: tau = 0 so a = 0, and its p is 0 too — guard
    # the division so 0/0 does not poison the sum
    a_safe = torch.where(a > 0, a, torch.ones_like(a))
    tau_eff = torch.sum(p * a)
    coeff = p * tau_eff / a_safe * (a > 0)
    params, _ = split_stats(client_vars)
    out = {}
    for k, s in client_vars.items():
        s = s.float()
        if k in params:
            g = global_vars[k]
            out[k] = g - torch.tensordot(coeff, g[None] - s, dims=1)
        else:
            out[k] = torch.tensordot(p, s, dims=1)
    return out


def make_fednova_round(model: ModelDef, config, task: str = "classification", local_train_fn=None):
    """The FedNova round, with the FedAvg round's signature
    ``(global_vars, x, y, mask, num_samples, client_perms, step_seeds=None)
    -> (global_vars', metric sums)``."""
    local_train, momentum = _validate_and_build(model, config, task, local_train_fn)

    def round_fn(global_vars, x, y, mask, num_samples, client_perms, step_seeds=None):
        client_vars, per_client, sums = train_clients(
            local_train, global_vars, x, y, mask, client_perms, step_seeds
        )
        tau = torch.stack(per_client)[:, _STEPS]
        new_global = nova_average(global_vars, client_vars, num_samples, tau, momentum)
        return new_global, dict(zip(_METRIC_KEYS, sums))

    return round_fn


class FedNovaAPI(FedAvgAPI):
    """FedNova simulator: the FedAvg skeleton with normalized averaging."""

    def _build_round_fn(self, local_train_fn):
        return make_fednova_round(self.model, self.config, task=self.task,
                                  local_train_fn=local_train_fn)
