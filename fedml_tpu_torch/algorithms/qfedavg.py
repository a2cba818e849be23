"""q-FedAvg — fair federated aggregation (port of
``fedml_tpu/algorithms/qfedavg.py``; q-FFL, Li et al., ICLR 2020).

q-FFL minimizes (1/(q+1))·Σ F_k^{q+1}, weighting high-loss clients up; q = 0
is plain FedAvg's objective, q → ∞ minimax fairness. The update:

    g_k     = (w_t − w_k) / lr
    Δ_k     = F_k^q · g_k
    h_k     = q · F_k^{q−1} · ‖g_k‖² + F_k^q / lr
    w_{t+1} = w_t − (Σ_k Δ_k) / (Σ_k h_k)

F_k is client k's training loss at the broadcast model w_t: one float32
forward over the client's real samples BEFORE local training (not the
trajectory's mean loss). At q = 0 the update is the uniform mean of the
client models."""

from __future__ import annotations

import torch

from fedml_tpu_torch.algorithms.fedavg import _METRIC_KEYS, FedAvgAPI, train_clients
from fedml_tpu_torch.models import ModelDef
from fedml_tpu_torch.train.client import make_local_train, make_task_loss


def qfedavg_update(global_vars, client_vars, losses, lr: float, q: float):
    """One q-FedAvg server step from the stacked client results
    (``client_vars`` [K, ...], ``losses`` [K] each client's F_k)."""
    eps = 1e-10
    L = torch.clamp(torch.as_tensor(losses, dtype=torch.float32), min=eps)
    deltas = {k: (g.float()[None] - client_vars[k].float()) / lr for k, g in global_vars.items()}
    gsq = sum(torch.sum(torch.square(d), dim=tuple(range(1, d.ndim))) for d in deltas.values())
    Lq = L**q
    h = q * (L ** (q - 1)) * gsq + Lq / lr
    hsum = torch.sum(h)
    return {
        k: (g.float() - torch.tensordot(Lq, deltas[k], dims=1) / hsum).to(g.dtype)
        for k, g in global_vars.items()
    }


def make_broadcast_loss(model: ModelDef, task: str = "classification"):
    """``(global_vars, x, y, mask, mask_host) -> F_k``: the mean training
    loss of ONE client's shard [S, B, ...] at the broadcast model, float32,
    ``train=False``. All-padding steps add nothing and are skipped."""
    task_loss = make_task_loss(task)

    @torch.no_grad()
    def broadcast_loss(gv, xc, yc, mc, mc_host):
        sums = torch.zeros(2, dtype=torch.float32, device=mc.device)
        has_data = (mc_host.sum(dim=1) > 0).tolist()
        for s in range(xc.shape[0]):
            if not has_data[s]:
                continue
            logits, _ = model.apply(gv, xc[s], train=False)
            loss, _, total = task_loss(logits, yc[s], mc[s])
            sums = sums + torch.stack([loss * total, total])
        return sums[0] / torch.clamp(sums[1], min=1.0)

    return broadcast_loss


def make_qfedavg_round(model: ModelDef, config, q: float, task: str = "classification",
                       local_train_fn=None):
    """The q-FedAvg round, with the FedAvg round's signature: the plain
    round's local trains, the weighted average replaced by the q-FFL
    update."""
    local_train = local_train_fn or make_local_train(
        model, config.train, config.fed.epochs, task=task
    )
    broadcast_loss = make_broadcast_loss(model, task)
    lr = config.train.lr

    def round_fn(global_vars, x, y, mask, num_samples, client_perms, step_seeds=None):
        mask_host = mask.cpu()
        losses = torch.stack([
            broadcast_loss(global_vars, x[j], y[j], mask[j], mask_host[j])
            for j in range(x.shape[0])
        ])
        client_vars, _, sums = train_clients(
            local_train, global_vars, x, y, mask, client_perms, step_seeds
        )
        new_global = qfedavg_update(global_vars, client_vars, losses, lr, q)
        return new_global, dict(zip(_METRIC_KEYS, sums))

    return round_fn


class QFedAvgAPI(FedAvgAPI):
    """q-FedAvg simulator on the FedAvg skeleton."""

    def __init__(self, config, data, model, q: float = 1.0, **kw):
        if config.train.client_optimizer != "sgd" or config.train.momentum:
            raise ValueError(
                "q-FedAvg's h_k normalizer is defined on plain-SGD local steps (the paper's "
                f"L-estimate 1/lr) — got {config.train.client_optimizer!r}, "
                f"momentum={config.train.momentum}"
            )
        self.q = float(q)
        super().__init__(config, data, model, **kw)

    def _build_round_fn(self, local_train_fn):
        return make_qfedavg_round(self.model, self.config, self.q, task=self.task,
                                  local_train_fn=local_train_fn)
