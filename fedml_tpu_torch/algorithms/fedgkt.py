"""FedGKT — Group Knowledge Transfer (port of
``fedml_tpu/algorithms/fedgkt.py``).

Clients train a small CNN and upload, not weights, but their stem
features, their logits and their labels; the server trains the large
network on those features with CE + T²·KL against the client logits, then
returns its own logits on each client's features, which that client's
next local round distills back (CE + T²·KL against the server logits). On
round 0 no server logits exist yet and the client trains on CE alone.

Each client keeps its own variables across rounds and starts each round
with a fresh SGD-momentum-0.9 state; the server's optimizer state carries
over. Batches tile a shard with ``range(0, n − B + 1, B)``: the tail that
does not fill a batch is dropped. The simulator keeps the uploads on the
device; the returned server-logit cache holds host arrays, the content
of the reference's server-to-client message.

The initial variables are hooks: ``client_init_fn(client_index)`` and
``server_init``. The reference draws them from ``fold_in(key, ci)`` of
JAX's threefry stream, which PyTorch cannot reproduce; the default draws
each client's from a CPU generator seeded from (seed, 0, client index),
and the server's from (seed, 1)."""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.device import DeviceLike, fp32_math, resolve_device
from fedml_tpu_torch.models import ModelDef, Variables, split_stats
from fedml_tpu_torch.models.gkt_resnet import GKTClientResNet, GKTServerResNet
from fedml_tpu_torch.train.optim import apply_updates, sgd


def kl_loss(student_logits, teacher_logits, temperature: float = 3.0):
    """T²·KL(teacher_T ‖ student_T), the batch mean; the teacher's
    probabilities get +1e-7, as the reference's."""
    T = temperature
    log_p = F.log_softmax(student_logits / T, dim=-1)
    q = F.softmax(teacher_logits / T, dim=-1) + 1e-7
    return T * T * torch.mean(torch.sum(q * (torch.log(q) - log_p), dim=-1))


def _seed(*words: int) -> int:
    return int(np.random.SeedSequence(list(words)).generate_state(1)[0])


def _sgd_step(model: ModelDef, opt, variables: Variables, opt_state, x, loss_of):
    """One training step of ``model`` on ``x``: the loss ``loss_of(outputs)``
    differentiated over the parameters, the optimizer's update, and the
    new running statistics."""
    params, stats = split_stats(variables)
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    out, new_vars = model.apply({**p, **stats}, x, train=True)
    loss = loss_of(out)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    with torch.no_grad():
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
    return {**params, **{k: new_vars[k] for k in stats}}, opt_state, loss.detach()


class FedGKTAPI:
    """Single-process simulator of the GKT exchange. ``device=None`` runs on
    the card and raises without one; pass ``device="cpu"`` for the CPU.
    After each round ``stage_s`` holds the seconds of its three stages
    (``clients``, ``server``, ``logits_back``), each closed by a device
    synchronisation, and ``losses`` the mean training loss of the clients'
    steps and of the server's."""

    def __init__(
        self,
        num_classes: int = 10,
        input_shape=(32, 32, 3),
        client_blocks: int = 1,
        server_layers=(2, 2),
        lr: float = 0.01,
        temperature: float = 3.0,
        seed: int = 0,
        device: DeviceLike = None,
        client_init_fn: Optional[Callable[[int], Variables]] = None,
        server_init: Optional[Variables] = None,
    ):
        self.device = resolve_device(device)
        self.T = temperature
        H, W, in_ch = tuple(input_shape)
        self.client_model = ModelDef(
            GKTClientResNet(num_classes, client_blocks, in_ch=in_ch), (H, W, in_ch), num_classes,
            has_batch_stats=True, name="gkt_client")
        self.server_model = ModelDef(
            GKTServerResNet(num_classes, server_layers), (H, W, 16), num_classes,
            has_batch_stats=True, name="gkt_server")
        self.client_init_fn = client_init_fn or (
            lambda ci: self.client_model.init(torch.Generator().manual_seed(_seed(seed, 0, ci))))
        if server_init is None:
            server_init = self.server_model.init(torch.Generator().manual_seed(_seed(seed, 1)))
        self.server_vars = {k: v.to(self.device) for k, v in server_init.items()}
        self.client_vars: Dict[int, Variables] = {}
        self.client_opt = sgd(lr, momentum=0.9)
        self.server_opt = sgd(lr, momentum=0.9)
        self.server_opt_state = self.server_opt.init(split_stats(self.server_vars)[0])
        self.stage_s: Dict[str, float] = {}
        self.losses: Dict[str, float] = {}

    def _clock(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _client_step(self, variables, opt_state, xb, yb, teacher):
        def loss_of(out):
            _, logits = out
            loss = F.cross_entropy(logits, yb)
            if teacher is not None:
                loss = loss + kl_loss(logits, teacher, self.T)
            return loss

        return _sgd_step(self.client_model, self.client_opt, variables, opt_state, xb, loss_of)

    def _server_step(self, feats, yb, client_logits):
        def loss_of(logits):
            return F.cross_entropy(logits, yb) + kl_loss(logits, client_logits, self.T)

        self.server_vars, self.server_opt_state, loss = _sgd_step(
            self.server_model, self.server_opt, self.server_vars, self.server_opt_state, feats,
            loss_of)
        return loss

    @torch.no_grad()
    def _extract(self, variables, x):
        return self.client_model.apply(variables, x, train=False)[0]

    @torch.no_grad()
    def _server_infer(self, feats):
        return self.server_model.apply(self.server_vars, feats, train=False)[0]

    def train_round(
        self,
        client_data: List[tuple],
        local_epochs: int = 1,
        server_epochs: int = 1,
        batch_size: int = 32,
        server_logits_cache: Optional[Dict[int, np.ndarray]] = None,
    ) -> Dict[int, np.ndarray]:
        """One GKT round over ``client_data``, a list of (x, y) host arrays
        a client. Returns the new per-client server-logit cache."""
        cache = server_logits_cache or {}
        B, dev = batch_size, self.device
        uploads = []  # (features, client logits, labels) a client, on the device
        losses = {"clients": [], "server": []}
        t0 = self._clock()
        with fp32_math():
            for ci, (x, y) in enumerate(client_data):
                if ci not in self.client_vars:
                    self.client_vars[ci] = {k: v.to(dev) for k, v in self.client_init_fn(ci).items()}
                variables = self.client_vars[ci]
                opt_state = self.client_opt.init(split_stats(variables)[0])
                xd = torch.as_tensor(np.asarray(x)).to(dev)
                yd = torch.as_tensor(np.asarray(y)).to(dev, torch.int64)
                teach = cache.get(ci)
                teach = None if teach is None else torch.as_tensor(np.asarray(teach)).to(dev)
                for _ in range(local_epochs):
                    for s in range(0, len(y) - B + 1, B):
                        variables, opt_state, loss = self._client_step(
                            variables, opt_state, xd[s : s + B], yd[s : s + B],
                            None if teach is None else teach[s : s + B])
                        losses["clients"].append(loss)
                self.client_vars[ci] = variables
                feats, logits = self._extract(variables, xd)
                uploads.append((feats, logits, yd))
            t1 = self._clock()
            for _ in range(server_epochs):
                for feats, logits, yd in uploads:
                    for s in range(0, len(yd) - B + 1, B):
                        losses["server"].append(
                            self._server_step(feats[s : s + B], yd[s : s + B], logits[s : s + B]))
            t2 = self._clock()
            new_cache = {ci: self._server_infer(feats).cpu().numpy()
                         for ci, (feats, _, _) in enumerate(uploads)}
        t3 = self._clock()
        self.stage_s = {"clients": t1 - t0, "server": t2 - t1, "logits_back": t3 - t2}
        self.losses = {k: float(torch.stack(v).mean()) if v else float("nan")
                       for k, v in losses.items()}
        return new_cache

    def evaluate(self, x, y, client_id: int = 0, batch_size: int = 128) -> float:
        """End-to-end accuracy: client ``client_id``'s stem features through
        the server network."""
        correct = 0
        variables = self.client_vars[client_id]
        x, y = np.asarray(x), np.asarray(y)
        with fp32_math():
            for s in range(0, len(y), batch_size):
                xb = torch.from_numpy(x[s : s + batch_size]).to(self.device)
                feats, _ = self._extract(variables, xb)
                logits = self._server_infer(feats)
                yb = torch.from_numpy(y[s : s + batch_size]).to(self.device, torch.int64)
                correct += int(torch.sum(torch.argmax(logits, -1) == yb))
        return correct / len(y)
