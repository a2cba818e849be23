"""Functional client optimizers with optax's exact update rules.

The reference builds its client optimizer from optax
(``fedml_tpu/train/client.py:30-43``): ``add_decayed_weights(wd)`` (L2 added
to the gradient, torch style) chained before ``sgd(lr, momentum)`` or
``amsgrad(lr)``. These are the same transformations written on dicts of
tensors, in optax's order of operations, so one step gives the same
numbers up to float32 rounding.

AMSGrad follows ``optax.amsgrad``: it keeps the running maximum of the
*bias-corrected* second moment. ``torch.optim.Adam(amsgrad=True)`` keeps
the maximum of the raw moment — a different optimizer — so it is not used."""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

Params = Dict[str, torch.Tensor]


class GradientTransformation(NamedTuple):
    """optax's (init, update) pair: ``init(params) -> state``;
    ``update(grads, state, params) -> (updates, state)``."""

    init: Callable
    update: Callable


def _zeros_like(params: Params) -> Params:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(g, state, params):
        return {k: g[k] + weight_decay * params[k] for k in g}, state

    return GradientTransformation(lambda params: (), update)


def trace(decay: float) -> GradientTransformation:
    """Heavy-ball momentum: ``t = g + decay·t``; the update is ``t``."""

    def update(g, state, params=None):
        new = {k: g[k] + decay * state[k] for k in g}
        return new, new

    return GradientTransformation(_zeros_like, update)


def scale(step_size: float) -> GradientTransformation:
    def update(g, state, params=None):
        return {k: step_size * v for k, v in g.items()}, state

    return GradientTransformation(lambda params: (), update)


class AmsgradState(NamedTuple):
    count: int
    mu: Params
    nu: Params
    nu_max: Params


def scale_by_amsgrad(
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0
) -> GradientTransformation:
    def init(params):
        return AmsgradState(0, _zeros_like(params), _zeros_like(params), _zeros_like(params))

    def update(g, state, params=None):
        mu = {k: (1 - b1) * g[k] + b1 * state.mu[k] for k in g}
        nu = {k: (1 - b2) * (g[k] ** 2) + b2 * state.nu[k] for k in g}
        count = state.count + 1
        # optax computes 1 - decay**count in float32, then divides by it
        # (a 0-dim tensor on the params' device: a true division there)
        device = next(iter(g.values())).device
        bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** count).to(device)
        bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** count).to(device)
        nu_max = {}
        updates = {}
        for k in g:
            mu_hat = mu[k] / bc1
            nu_hat = nu[k] / bc2
            nu_max[k] = torch.maximum(state.nu_max[k], nu_hat)
            updates[k] = mu_hat / (torch.sqrt(nu_max[k] + eps_root) + eps)
        return updates, AmsgradState(count, mu, nu, nu_max)

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(g, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            g, s = t.update(g, s, params)
            new_state.append(s)
        return g, tuple(new_state)

    return GradientTransformation(init, update)


def sgd(lr: float, momentum: Optional[float] = None) -> GradientTransformation:
    parts = [trace(momentum)] if momentum is not None else []
    return chain(*parts, scale(-lr))


def amsgrad(lr: float) -> GradientTransformation:
    return chain(scale_by_amsgrad(), scale(-lr))


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: params[k] + updates[k] for k in params}


def build_client_optimizer(tc) -> GradientTransformation:
    """TrainConfig → client optimizer: SGD(lr, momentum) | AMSGrad(lr),
    with L2 weight decay added to the gradient first when ``tc.wd``."""
    parts = []
    if tc.wd:
        parts.append(add_decayed_weights(tc.wd))
    if tc.client_optimizer == "sgd":
        parts.append(sgd(tc.lr, momentum=tc.momentum if tc.momentum else None))
    elif tc.client_optimizer == "adam":
        parts.append(amsgrad(tc.lr))
    else:
        raise ValueError(f"unknown client_optimizer {tc.client_optimizer!r}")
    return chain(*parts)

