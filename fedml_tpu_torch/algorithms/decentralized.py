"""Decentralized online learning: DSGD and push-sum gossip over a topology
(port of ``fedml_tpu/algorithms/decentralized.py``).

All N workers are one stacked leading axis. Each iteration every worker
takes one SGD step on its next streaming sample (a vmapped gradient), then
the workers mix: ``params ← W @ params`` with W the row-stochastic mixing
matrix of partition/topology.py. Push-sum also carries the weights ω and
reports z = x/ω; its debiasing needs a column-stochastic matrix, so it
mixes with Wᵀ (x ← Wᵀx, ω ← Wᵀω), which averages correctly on directed
topologies where DSGD's mixing is biased. The loss is the binary
cross-entropy of the first logit (the logistic-regression model of the
reference's decentralized runs); regret is the running mean of the
per-iteration mean loss."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.device import DeviceLike, fp32_math, resolve_device
from fedml_tpu_torch.models import ModelDef


def _binary_loss(model: ModelDef):
    def loss_fn(params, x, y):
        logits, _ = model.apply(params, x, train=True)
        logit = logits.reshape(-1)[:1]
        return F.binary_cross_entropy_with_logits(logit, y.reshape(-1)[:1])

    return loss_fn


def make_decentralized_run(model: ModelDef, mixing_matrix: np.ndarray, lr: float,
                           wd: float = 0.0, variant: str = "dsgd",
                           loss_fn: Optional[Callable] = None):
    """``run(stacked_params, x, y) -> (final_params, per-iteration loss [T])``
    with x [N, T, *feat] (worker-major streams) and y [N, T] binary
    targets."""
    if variant not in ("dsgd", "pushsum"):
        raise ValueError(f"variant must be 'dsgd' or 'pushsum', got {variant!r}")
    W = torch.as_tensor(np.asarray(mixing_matrix, np.float32))
    if variant == "pushsum":
        W = W.T.contiguous()  # push mass along the out-edges
    N = W.shape[0]
    grad_fn = torch.func.vmap(torch.func.grad_and_value(loss_fn or _binary_loss(model)))

    def run(stacked_params, x, y):
        Wd = W.to(x.device)
        params = dict(stacked_params)
        omega = torch.ones(N, dtype=torch.float32, device=x.device)
        losses = []
        with fp32_math():
            for t in range(x.shape[1]):
                grads, loss = grad_fn(params, x[:, t][:, None], y[:, t][:, None])
                params = {k: p - lr * (grads[k] + wd * p) for k, p in params.items()}
                params = {k: torch.einsum("ij,j...->i...", Wd, p) for k, p in params.items()}
                if variant == "pushsum":
                    omega = Wd @ omega
                losses.append(torch.mean(loss))
            if variant == "pushsum":
                params = {k: p / omega.reshape((N,) + (1,) * (p.ndim - 1))
                          for k, p in params.items()}
        return params, torch.stack(losses)

    return run


class DecentralizedAPI:
    """Driver (counterpart of the reference's ``DecentralizedAPI``): stacked
    worker params, the run, and the regret. Each worker's init comes from a
    generator seeded from (seed, worker); ``device=None`` runs on the
    card."""

    def __init__(self, model: ModelDef, topology, lr: float = 0.1, wd: float = 0.0,
                 variant: str = "dsgd", seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model, self.topology, self.variant = model, topology, variant
        N = topology.topology.shape[0]
        inits = [model.init(torch.Generator().manual_seed(
            int(np.random.SeedSequence([seed, i]).generate_state(1)[0]))) for i in range(N)]
        self.params = {k: torch.stack([v[k] for v in inits]).to(self.device) for k in inits[0]}
        self.run_fn = make_decentralized_run(model, topology.topology, lr, wd, variant)

    def run(self, x: np.ndarray, y: np.ndarray) -> dict:
        xt = torch.as_tensor(np.asarray(x), device=self.device)
        yt = torch.as_tensor(np.asarray(y, np.float32), device=self.device)
        self.params, losses = self.run_fn(self.params, xt, yt)
        losses = losses.cpu().numpy()
        regret = np.cumsum(losses) / (np.arange(len(losses)) + 1)
        return {"losses": losses, "regret": regret}
