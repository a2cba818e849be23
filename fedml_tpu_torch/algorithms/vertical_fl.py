"""Classical vertical (feature-partitioned) FL (port of
``fedml_tpu/algorithms/vertical_fl.py``): the guest holds the labels,
hosts hold disjoint feature columns of the same samples.

Per batch each party computes its logit contribution h_k =
dense(extractor(x_k)); the guest sums them, takes the loss, and returns
∂L/∂h_k to every party, which backpropagates through its own stack.
:class:`VFLAPI` runs the whole multi-party step as one function
(``splitfed/programs.py`` ``make_vfl_fused_step``: autograd through the
sum of contributions is the split backward); the message boundary, cut at
the logit sum, is :meth:`VFLAPI.guest_host_split_step` and the transport's
(``splitfed/vfl_transport.py``)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from fedml_tpu_torch.device import DeviceLike, resolve_device
from fedml_tpu_torch.models import ModelDef
from fedml_tpu_torch.models.vfl import VFLPartyModel, party_contribution
from fedml_tpu_torch.train import optim


def party_generator(seed: int, party: int) -> torch.Generator:
    """Party ``party``'s init stream: one per (seed, party), so every rank of
    a federation draws the same party weights as the simulator."""
    return torch.Generator().manual_seed(int(np.random.SeedSequence([seed, party]).generate_state(1)[0]))


class VFLParty:
    """One party's feature slice width and local stack; ``params`` is the
    flat party dict (``extractor.fc.*``, ``dense.fc.*``) on the CPU."""

    def __init__(self, feature_dim: int, hidden_dim: int, out_dim: int,
                 generator: torch.Generator, has_labels: bool = False):
        model = VFLPartyModel(feature_dim, hidden_dim, out_dim, has_labels)
        self.params = ModelDef(model, (feature_dim,), out_dim, name="vfl_party").init(generator)
        self.has_labels = has_labels


def _to(device, x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


class VFLAPI:
    """A federation of one guest (labels, party 0) and K hosts; every
    party's parameters in one list, so the fused step updates them all."""

    def __init__(self, feature_splits: Sequence[int], hidden_dim: int = 16, out_dim: int = 1,
                 lr: float = 0.05, seed: int = 0, device: DeviceLike = None):
        from fedml_tpu_torch.splitfed.programs import join, make_vfl_fused_step

        self.device = resolve_device(device)
        self.parties: List[VFLParty] = [
            VFLParty(d, hidden_dim, out_dim, party_generator(seed, i), has_labels=(i == 0))
            for i, d in enumerate(feature_splits)
        ]
        self.feature_splits = tuple(int(d) for d in feature_splits)
        self.hidden_dim, self.out_dim = int(hidden_dim), int(out_dim)
        self.opt = optim.sgd(lr, momentum=0.9)
        self.params = [{k: v.to(self.device) for k, v in p.params.items()} for p in self.parties]
        self.opt_state = self.opt.init(join(self.params, [str(i) for i in range(len(self.params))]))
        self._step = make_vfl_fused_step(lr=lr, momentum=0.9)

    def train_epoch(self, xs_parties: Sequence[np.ndarray], y: np.ndarray, batch_size: int = 32):
        n = len(y)
        losses, corrects = [], 0
        for s in range(0, n - batch_size + 1, batch_size):
            xs = [_to(self.device, x[s : s + batch_size]) for x in xs_parties]
            yb = _to(self.device, y[s : s + batch_size])
            self.params, self.opt_state, loss, correct = self._step(self.params, self.opt_state,
                                                                    xs, yb)
            losses.append(float(loss))
            corrects += int(correct)
        seen = (n // batch_size) * batch_size
        return {"loss": float(np.mean(losses)), "acc": corrects / max(seen, 1)}

    def guest_host_split_step(self, xs_parties, y):
        """The message-boundary form: the parties send their contributions
        forward, the guest returns ∂L/∂h_k; returns each party's parameter
        gradients (to check the fused step's)."""
        from fedml_tpu_torch.splitfed.programs import vfl_guest_grad

        xs = [_to(self.device, x) for x in xs_parties]
        leaves = [{k: v.detach().requires_grad_(True) for k, v in pp.items()} for pp in self.params]
        contribs = [party_contribution(pp, x) for pp, x in zip(leaves, xs)]
        _, _, g_contrib = vfl_guest_grad(contribs, _to(self.device, y))
        return [dict(zip(pp, torch.autograd.grad(c, list(pp.values()), g)))
                for pp, c, g in zip(leaves, contribs, g_contrib)]
