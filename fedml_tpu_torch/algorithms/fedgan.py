"""FedGAN — FedAvg over a generator + discriminator pair (port of
``fedml_tpu/algorithms/fedgan.py``).

The aggregate is the plain sample-weighted FedAvg over the combined G + D
variables; only the local training differs. Per batch: a discriminator
step (BCE, real → 1, fake → 0) on a fake drawn from G in training mode
and detached, whose BatchNorm statistics are discarded; then a generator
step (BCE, fake → 1) against the *updated* discriminator, whose
statistics G keeps. Both nets step with Adam (b1 = 0.5). A step of
padding only is skipped on the host, a complete no-op as the reference's
``keep``. The local steps visit the client's batches in order, without a
shuffle.

The latent draws are a hook. The reference draws a step's z from
``fold_in(client_rng, step)`` of JAX's threefry stream (the same z in
every epoch), which PyTorch cannot reproduce, so ``FedGANAPI`` takes
``z_fn(round, client_slot, step, shape) -> z``; the default,
:func:`seeded_z_fn`, draws from a generator on the device seeded from
(seed, round, slot, step). The local train gets the slot's source
``z_source(step, shape)`` where :func:`make_local_train`'s gets its
shuffle."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.device import fp32_math
from fedml_tpu_torch.models import STATS, ModelDef
from fedml_tpu_torch.models.gan import Discriminator, Generator, MNISTGan
from fedml_tpu_torch.train.optim import adam, apply_updates

# (round, client_slot, step, shape) -> a standard-normal float32 tensor
ZFn = Callable[[int, int, int, tuple], torch.Tensor]


def seeded_z_fn(seed: int, device) -> ZFn:
    """The port's default latent source (see the module docstring)."""

    def z_fn(round_idx, slot, step, shape):
        key = np.random.SeedSequence([seed, round_idx, slot, step]).generate_state(1)[0]
        gen = torch.Generator(device=device).manual_seed(int(key))
        return torch.randn(shape, generator=gen, device=device)

    return z_fn


def make_gan_model_def(z_dim: int = 100) -> ModelDef:
    """The G + D variables as one model (``netg.*``, ``netd.*``, and G's
    running statistics under ``batch_stats.netg.``); training goes through
    :func:`make_gan_local_train`, not one forward."""
    return ModelDef(MNISTGan(z_dim), (28, 28, 1), 1, has_batch_stats=True, name="mnistgan")


def _sub(variables, prefix: str):
    return {k[len(prefix):]: v for k, v in variables.items() if k.startswith(prefix)}


def _bce(logits, target: float):
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, target), reduction="none")


class GanLocalTrain:
    """The per-client GAN trainer: ``(variables, x, y, mask, z_source,
    mask_host=None, step_seed=0) -> (variables', metrics)`` with FedAvg's
    metric sums; y is ignored, ``loss_sum`` holds the weighted G loss and
    ``correct`` the weighted D loss."""

    def __init__(self, train_config, epochs: int, z_dim: int = 100):
        self.epochs = epochs
        self.z_dim = z_dim
        self.g = ModelDef(Generator(z_dim), (z_dim,), 784, has_batch_stats=True, name="netg")
        self.d = Discriminator()
        self.g_opt = adam(train_config.lr, b1=0.5)
        self.d_opt = adam(train_config.lr, b1=0.5)

    def _d(self, params, x):
        return torch.func.functional_call(self.d, params, (x,))

    def __call__(self, variables, x, y, mask, z_source, mask_host=None, step_seed: int = 0):
        del y, step_seed
        gp, dp = _sub(variables, "netg."), _sub(variables, "netd.")
        g_bs = {STATS + k: v for k, v in _sub(variables, STATS + "netg.").items()}
        S, B = mask.shape
        has_data = ((mask_host if mask_host is not None else mask).cpu().sum(dim=1) > 0).tolist()
        g_os, d_os = self.g_opt.init(gp), self.d_opt.init(dp)
        mets = torch.zeros(3, dtype=torch.float32, device=mask.device)
        for _ in range(self.epochs):
            for s in range(S):
                if not has_data[s]:
                    continue  # all-padding step: a complete no-op
                z = z_source(s, (B, self.z_dim))
                xb, mb = x[s], mask[s]
                m, msum = mb[:, None], torch.clamp(torch.sum(mb), min=1e-9)
                # D step: real -> 1, fake (detached, G's new statistics
                # discarded) -> 0
                with torch.no_grad():
                    fake, _ = self.g.apply({**gp, **g_bs}, z, train=True)
                dr = {k: v.detach().requires_grad_(True) for k, v in dp.items()}
                d_l = torch.sum((_bce(self._d(dr, xb), 1.0) + _bce(self._d(dr, fake), 0.0)) * m) / msum
                d_grads = dict(zip(dr, torch.autograd.grad(d_l, list(dr.values()))))
                with torch.no_grad():
                    updates, d_os = self.d_opt.update(d_grads, d_os, dp)
                    dp = apply_updates(dp, updates)
                # G step: fake -> 1 against the updated D; G keeps its stats
                gr = {k: v.detach().requires_grad_(True) for k, v in gp.items()}
                fake, new_vars = self.g.apply({**gr, **g_bs}, z, train=True)
                g_l = torch.sum(_bce(self._d(dp, fake), 1.0) * m) / msum
                g_grads = dict(zip(gr, torch.autograd.grad(g_l, list(gr.values()))))
                with torch.no_grad():
                    updates, g_os = self.g_opt.update(g_grads, g_os, gp)
                    gp = apply_updates(gp, updates)
                    g_bs = {k: new_vars[k] for k in g_bs}
                    n = torch.sum(mb)
                    mets = mets + torch.stack([g_l * n, d_l * n, n])
        out = {"netg." + k: v for k, v in gp.items()}
        out.update({"netd." + k: v for k, v in dp.items()})
        out.update({STATS + "netg." + k[len(STATS):]: v for k, v in g_bs.items()})
        metrics = {"loss_sum": mets[0], "correct": mets[1], "count": mets[2],
                   "steps": torch.zeros((), device=mask.device)}
        return out, metrics


def make_gan_local_train(train_config, epochs: int, z_dim: int = 100) -> GanLocalTrain:
    return GanLocalTrain(train_config, epochs, z_dim)


class FedGANAPI(FedAvgAPI):
    """FedAvg's round skeleton with the GAN local trainer; ``device=None``
    runs on the card. ``z_fn`` is the latent source (see the module
    docstring)."""

    def __init__(self, config, data, model: Optional[ModelDef] = None, z_dim: int = 100,
                 z_fn: Optional[ZFn] = None, **kw):
        model = model or make_gan_model_def(z_dim)
        self.local_train = kw["local_train_fn"] = make_gan_local_train(
            config.train, config.fed.epochs, z_dim)
        super().__init__(config, data, model, **kw)
        self.z_dim = z_dim
        self.z_fn = z_fn or seeded_z_fn(config.seed, self.device)

    def _place_batch(self, batch, round_idx: int):
        # the slot's latent source takes the place of its shuffle
        x, y, mask, num_samples, _, step_seeds = super()._place_batch(batch, round_idx)
        sources = [(lambda step, shape, j=j: self.z_fn(round_idx, j, step, shape))
                   for j in range(batch.num_clients)]
        return x, y, mask, num_samples, sources, step_seeds

    def train(self):
        final = {}
        for round_idx in range(self.config.fed.comm_round):
            _, metrics = self.train_round(round_idx)
            count = float(metrics["count"])
            row = {
                "round": round_idx,
                "Train/G_Loss": float(metrics["loss_sum"]) / max(count, 1e-9),
                "Train/D_Loss": float(metrics["correct"]) / max(count, 1e-9),
            }
            self.history.append(row)
            self.log_fn(row)
            final = row
        return final

    @torch.no_grad()
    def generate(self, n: int, seed: int = 0, z: Optional[torch.Tensor] = None):
        """``n`` images [n, 28, 28, 1] from the global generator in eval
        mode, from ``z`` or a standard normal seeded with ``seed``."""
        if z is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            z = torch.randn((n, self.z_dim), generator=gen, device=self.device)
        g = self.local_train.g
        variables = {**_sub(self.global_vars, "netg."),
                     **{STATS + k: v for k, v in _sub(self.global_vars, STATS + "netg.").items()}}
        with fp32_math():
            return g.apply(variables, z.to(self.device), train=False)[0]
