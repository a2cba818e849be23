"""FedNAS — federated architecture search over the DARTS space (port of
``fedml_tpu/algorithms/fednas.py``).

Each sampled client splits its data into halves, train and val, and per
epoch runs architecture steps (∇α of the loss on the val half, Adam
b1 = 0.5, b2 = 0.999) and then weight steps (∇w on the train half, SGD
momentum 0.9); both kinds of step update the running statistics. The
round ends with one sample-weighted average of w, α and the statistics,
and the genotype derived from the averaged ``alpha_normal`` is recorded.

``arch_grad`` selects the architect:

- ``"first"``: ∇α of the val loss at the current weights;
- ``"second"``: ∇α L_val(w − ξ·∇w L_train(w, α), α), the virtual step
  plain SGD of ξ (``w_lr`` by default), differentiated through with
  ``torch.autograd.grad(create_graph=True)`` — a second derivative through
  every layer, BatchNorm's included (ops/fused_batchnorm.py). The running
  statistics are read, never written, inside the unrolled loss.

The cohort is ``select_clients(round, N, k)``. The initial variables are a
hook (``init_vars``): the reference draws α and the weights from JAX's
threefry stream; the default draws them from a CPU generator seeded with
``seed``."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.algorithms.fedavg import weighted_average
from fedml_tpu_torch.device import DeviceLike, fp32_math, resolve_device
from fedml_tpu_torch.models import ModelDef, Variables, split_stats
from fedml_tpu_torch.models.darts import DARTSNetwork, derive_genotype
from fedml_tpu_torch.scheduler import select_clients
from fedml_tpu_torch.train.optim import adam, apply_updates, sgd


def _split_arch(params: Variables):
    """(α, weights) of the parameters."""
    arch = {k: v for k, v in params.items() if k.startswith("alpha_")}
    return arch, {k: v for k, v in params.items() if not k.startswith("alpha_")}


def _leaf(params: Variables) -> Variables:
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


class FedNASAPI:
    """``device=None`` runs on the card and raises without one; pass
    ``device="cpu"`` for the CPU."""

    def __init__(
        self,
        data,
        num_classes: int,
        input_shape,
        ch: int = 8,
        cells: int = 2,
        steps: int = 2,
        w_lr: float = 0.025,
        arch_lr: float = 3e-3,
        batch_size: int = 16,
        seed: int = 0,
        arch_grad: str = "first",
        xi: Optional[float] = None,
        device: DeviceLike = None,
        init_vars: Optional[Variables] = None,
    ):
        if arch_grad not in ("first", "second"):
            raise ValueError(f"arch_grad must be 'first' or 'second', got {arch_grad!r}")
        self.device = resolve_device(device)
        self.arch_grad = arch_grad
        self.xi = w_lr if xi is None else xi
        self.data = data
        self.steps = steps
        shape = tuple(input_shape)
        self.model = ModelDef(
            DARTSNetwork(num_classes=num_classes, ch=ch, cells=cells, steps=steps,
                         in_ch=shape[-1]),
            shape, num_classes, has_batch_stats=True, name="darts")
        if init_vars is None:
            init_vars = self.model.init(torch.Generator().manual_seed(seed))
        self.variables = {k: v.to(self.device) for k, v in init_vars.items()}
        self.w_opt = sgd(w_lr, momentum=0.9)
        self.arch_opt = adam(arch_lr, b1=0.5, b2=0.999)
        self.batch_size = batch_size
        self.genotype_history: List = []

    def _loss(self, params, stats, x, y):
        """(train-mode CE, the new running statistics)."""
        logits, new_vars = self.model.apply({**params, **stats}, x, train=True)
        return F.cross_entropy(logits, y), {k: new_vars[k] for k in stats}

    def _step(self, variables, opt_state, x, y, update_arch: bool):
        """One step of α (``update_arch``) or of the weights, the other
        held; the running statistics take the step's batch statistics."""
        params, stats = split_stats(variables)
        arch, weights = _split_arch(params)
        target, other = (arch, weights) if update_arch else (weights, arch)
        opt = self.arch_opt if update_arch else self.w_opt
        t = _leaf(target)
        loss, new_stats = self._loss({**other, **t}, stats, x, y)
        grads = dict(zip(t, torch.autograd.grad(loss, list(t.values()))))
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, target)
            target = apply_updates(target, updates)
        return {**other, **target, **new_stats}, opt_state, loss.detach()

    def unrolled_arch_grads(self, variables, xv, yv, xt, yt):
        """(val loss, α's gradient) of the unrolled architect at
        ``variables``: α's gradient of the val loss at
        w' = w − ξ·∇w L_train(w, α), through the virtual step."""
        params, stats = split_stats(variables)
        arch, weights = _split_arch(params)
        a, w = _leaf(arch), _leaf(weights)
        train_loss, _ = self._loss({**w, **a}, stats, xt, yt)
        g_w = torch.autograd.grad(train_loss, list(w.values()), create_graph=True)
        w2 = {k: w[k] - self.xi * g for k, g in zip(w, g_w)}
        loss, _ = self._loss({**w2, **a}, stats, xv, yv)
        return loss.detach(), dict(zip(a, torch.autograd.grad(loss, list(a.values()))))

    def _second_order_arch_step(self, variables, opt_state, xv, yv, xt, yt):
        """One α step of the unrolled architect; the weights and the
        running statistics are kept."""
        loss, grads = self.unrolled_arch_grads(variables, xv, yv, xt, yt)
        params, stats = split_stats(variables)
        arch, weights = _split_arch(params)
        with torch.no_grad():
            updates, opt_state = self.arch_opt.update(grads, opt_state, arch)
            arch = apply_updates(arch, updates)
        return {**weights, **arch, **stats}, opt_state, loss

    def _local_search(self, variables, x, y, epochs: int):
        """Per epoch: α steps on the val half, then weight steps on the
        train half."""
        dev, B = self.device, self.batch_size
        x = torch.as_tensor(np.asarray(x)).to(dev)
        y = torch.as_tensor(np.asarray(y)).to(dev, torch.int64)
        half = len(y) // 2
        xt, yt, xv, yv = x[:half], y[:half], x[half:], y[half:]
        arch, weights = _split_arch(split_stats(variables)[0])
        w_os, a_os = self.w_opt.init(weights), self.arch_opt.init(arch)
        loss = torch.zeros(())
        for _ in range(epochs):
            for s in range(0, max(len(yv) - B + 1, 1), B):
                if self.arch_grad == "second":
                    t = s % max(len(yt) - B + 1, 1)
                    variables, a_os, _ = self._second_order_arch_step(
                        variables, a_os, xv[s : s + B], yv[s : s + B], xt[t : t + B], yt[t : t + B])
                else:
                    variables, a_os, _ = self._step(
                        variables, a_os, xv[s : s + B], yv[s : s + B], update_arch=True)
            for s in range(0, max(len(yt) - B + 1, 1), B):
                variables, w_os, loss = self._step(
                    variables, w_os, xt[s : s + B], yt[s : s + B], update_arch=False)
        return variables, float(loss)

    def train_round(self, round_idx: int, client_num_per_round: int, epochs: int = 1):
        """One search round; returns the round's genotype."""
        sampled = select_clients(round_idx, self.data.num_clients, client_num_per_round)
        locals_, weights_n = [], []
        with fp32_math():
            for ci in sampled:
                v, _ = self._local_search(
                    self.variables, self.data.client_x[ci], self.data.client_y[ci], epochs)
                locals_.append(v)
                weights_n.append(len(self.data.client_y[ci]))
            stacked = {k: torch.stack([v[k] for v in locals_]) for k in self.variables}
            self.variables = weighted_average(
                stacked, torch.tensor(weights_n, dtype=torch.float32, device=self.device))
        geno = derive_genotype(self.variables["alpha_normal"], steps=self.steps)
        self.genotype_history.append((round_idx, geno))
        return geno

    @torch.no_grad()
    def evaluate(self, x, y, batch_size: int = 64) -> float:
        correct = 0
        x, y = np.asarray(x), np.asarray(y)
        with fp32_math():
            for s in range(0, len(y), batch_size):
                xb = torch.from_numpy(x[s : s + batch_size]).to(self.device)
                logits, _ = self.model.apply(self.variables, xb, train=False)
                yb = torch.from_numpy(y[s : s + batch_size]).to(self.device, torch.int64)
                correct += int(torch.sum(torch.argmax(logits, -1) == yb))
        return correct / len(y)
