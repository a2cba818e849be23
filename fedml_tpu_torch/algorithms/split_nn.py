"""Split learning (port of ``fedml_tpu/algorithms/split_nn.py``): the model
is cut at a layer; clients own the bottom, the server owns the top;
activations flow up, their gradients flow back, and clients take turns
around a relay ring.

- :class:`SplitNNAPI`, the fused simulator: bottom and top are two
  parameter groups of one step (``splitfed/programs.py``), autograd through
  the composition being the activation-gradient exchange; the ring is a
  pass over the clients in order with the shared bottom weights.
- :func:`split_step_with_boundary`, the explicit two-party step cut where
  the wire is (the client uploads acts, the server returns ∂L/∂acts), used
  to check the fused path's arithmetic; the transports run its pieces
  (``splitfed/split_transport.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.device import DeviceLike, resolve_device
from fedml_tpu_torch.models import ModelDef
from fedml_tpu_torch.models.layers import Conv2d


class _Bottom(nn.Module):
    """The client's half, flax's auto-named layers: on flat features one
    dense layer (``Dense_0``) + relu; on NHWC images two 3×3 stride-2 SAME
    convs (``Conv_0``, ``Conv_1``) + relu, flattened in NHWC order."""

    def __init__(self, input_shape, width: int):
        super().__init__()
        self.flat = len(input_shape) == 1
        if self.flat:
            self.Dense_0 = nn.Linear(input_shape[0], width)
        else:
            self.Conv_0 = Conv2d(input_shape[-1], width, 3, stride=2)
            self.Conv_1 = Conv2d(width, width, 3, stride=2)

    def forward(self, x):
        if self.flat:
            return F.relu(self.Dense_0(x))
        h = F.relu(self.Conv_0(x.permute(0, 3, 1, 2)))
        h = F.relu(self.Conv_1(h))
        return h.permute(0, 2, 3, 1).flatten(1)


class _Top(nn.Module):
    """The server's half: dense 2·width + relu, then dense to the classes."""

    def __init__(self, feat_dim: int, num_classes: int, width: int):
        super().__init__()
        self.Dense_0 = nn.Linear(feat_dim, 2 * width)
        self.Dense_1 = nn.Linear(2 * width, num_classes)

    def forward(self, a):
        return self.Dense_1(F.relu(self.Dense_0(a)))


def default_split_models(input_shape, num_classes: int, width: int = 32):
    """The CLI's cut: a conv feature extractor on the client, a dense head
    on the server. The top's input width is what the bottom emits, read by
    running the bottom on a zero batch rather than from the convs' stride
    arithmetic (which would drift if either changed)."""
    input_shape = tuple(int(d) for d in input_shape)
    bottom = ModelDef(_Bottom(input_shape, width), input_shape, num_classes, name="split_bottom")
    with torch.no_grad():
        feat_dim = int(bottom.module(torch.zeros((1,) + input_shape)).shape[-1])
    top = ModelDef(_Top(feat_dim, num_classes, width), (feat_dim,), num_classes, name="split_top")
    return bottom, top


def init_split_vars(bottom: ModelDef, top: ModelDef, seed: int):
    """Both halves' initial variables from ``seed``: the simulator and the
    transport's server start from these."""
    gen = torch.Generator().manual_seed(int(seed))
    return bottom.init(gen), top.init(gen)


def _to(device, x, y=None):
    x = torch.tensor(np.asarray(x), dtype=torch.float32, device=device)
    return x if y is None else (x, torch.tensor(np.asarray(y), dtype=torch.long, device=device))


class SplitNNAPI:
    """Fused split-learning simulator over a client ring."""

    def __init__(self, bottom: ModelDef, top: ModelDef, lr: float = 0.1, momentum: float = 0.9,
                 wd: float = 5e-4, seed: int = 0, device: DeviceLike = None):
        from fedml_tpu_torch.splitfed.programs import (
            join,
            make_split_optimizer,
            make_splitnn_fused_step,
        )

        self.device = resolve_device(device)
        self.bottom, self.top = bottom, top
        b, t = init_split_vars(bottom, top, seed)
        self.bottom_vars = {k: v.to(self.device) for k, v in b.items()}
        self.top_vars = {k: v.to(self.device) for k, v in t.items()}
        # the reference client's SGD(0.1, momentum=0.9, wd=5e-4)
        self.opt = make_split_optimizer(lr, momentum, wd)
        self.opt_state = self.opt.init(join([self.bottom_vars, self.top_vars], ("bottom", "top")))
        self._step = make_splitnn_fused_step(bottom, top, lr=lr, momentum=momentum, wd=wd)

    def train_ring(self, client_data, batch_size: int = 32, epochs_per_client: int = 1):
        """Each client in ring order runs its epochs of full batches (no
        shuffle, a partial last batch dropped) with the shared bottom."""
        params = {"bottom": self.bottom_vars, "top": self.top_vars}
        stats, loss = [], None
        for x, y in client_data:
            n = len(y)
            for _ in range(epochs_per_client):
                for s in range(0, n - batch_size + 1, batch_size):
                    xb, yb = _to(self.device, x[s : s + batch_size], y[s : s + batch_size])
                    params, self.opt_state, loss, _ = self._step(params, self.opt_state, xb, yb)
            if loss is not None:
                stats.append({"loss": float(loss)})
        self.bottom_vars, self.top_vars = params["bottom"], params["top"]
        return stats

    def evaluate(self, x, y, batch_size: int = 128) -> float:
        from fedml_tpu_torch.splitfed.programs import make_splitnn_eval

        ev = make_splitnn_eval(self.bottom, self.top)
        correct = total = 0
        for s in range(0, len(y), batch_size):
            xb, yb = _to(self.device, x[s : s + batch_size], y[s : s + batch_size])
            correct += int(ev(self.bottom_vars, self.top_vars, xb, yb))
            total += len(xb)
        return correct / max(total, 1)


def split_step_with_boundary(bottom: ModelDef, top: ModelDef, bottom_vars: dict, top_vars: dict,
                             x, y) -> Tuple[torch.Tensor, dict, dict]:
    """One forward/backward with the explicit wire boundary: (loss,
    bottom_grads, top_grads), where only ``acts`` (client → server) and
    ``acts_grad`` (server → client) cross between the parties."""
    # client side
    b = {k: v.detach().requires_grad_(True) for k, v in bottom_vars.items()}
    acts, _ = bottom.apply(b, x, train=True)
    # server side: the loss and its gradients with respect to (top, acts)
    t = {k: v.detach().requires_grad_(True) for k, v in top_vars.items()}
    a = acts.detach().requires_grad_(True)
    logits, _ = top.apply(t, a, train=True)
    loss = F.cross_entropy(logits, y)
    *top_grads, acts_grad = torch.autograd.grad(loss, [*t.values(), a])
    # client backward with the returned activation gradients
    bottom_grads = torch.autograd.grad(acts, list(b.values()), acts_grad)
    return loss.detach(), dict(zip(b, bottom_grads)), dict(zip(t, top_grads))
