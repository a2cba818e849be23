"""Functional optimizers with optax's exact update rules: the client's
(SGD, momentum, AMSGrad, L2) and FedOpt's server optimizers (Adam, Yogi,
Adagrad).

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

import functools
import math
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


class GradientTransformation(NamedTuple):
    """optax's (init, update) pair: ``init(params) -> state``;
    ``update(grads, state, params) -> (updates, state)``."""

    init: Callable
    update: Callable


# The states have optax's layout (the same NamedTuples, fields and nesting),
# so a checkpoint holds a server optimizer's state as the reference's
# (utils/checkpoint.py).


class EmptyState(NamedTuple):
    """The state of a stateless transformation."""


class TraceState(NamedTuple):
    trace: Params


class ScaleByRssState(NamedTuple):
    sum_of_squares: Params


def _zeros_like(params: Params) -> Params:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def _empty(params) -> EmptyState:
    return EmptyState()


def identity() -> GradientTransformation:
    return GradientTransformation(_empty, lambda g, state, params=None: (g, state))


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(g, state, params):
        return {k: g[k] + weight_decay * params[k] for k in g}, state

    return GradientTransformation(_empty, update)


def trace(decay: float) -> GradientTransformation:
    """Heavy-ball momentum: ``t = g + decay·t``; the update is ``t``."""

    def update(g, state, params=None):
        new = {k: g[k] + decay * state.trace[k] for k in g}
        return new, TraceState(new)

    return GradientTransformation(lambda params: TraceState(_zeros_like(params)), update)


def scale(step_size: float) -> GradientTransformation:
    def update(g, state, params=None):
        return {k: step_size * v for k, v in g.items()}, state

    return GradientTransformation(_empty, update)


def _full_like(params: Params, value: float) -> Params:
    return {k: torch.full_like(v, value) for k, v in params.items()}


def _bias_correction(decay: float, count, device) -> torch.Tensor:
    """optax's ``1 - decay**count`` in float32, bit for bit (see
    :func:`_one_minus_power`), as a 0-dim tensor on the params' device, so
    the moments are truly divided by it there (a CUDA division by a host
    scalar multiplies by its reciprocal).

    ``count`` is a host int on the loop schedule. The batched schedule
    carries one count a client (an integer tensor, 0-dim for each client
    inside ``torch.func.vmap``): those are gathered from
    :func:`_bias_table`."""
    if isinstance(count, torch.Tensor):
        table = _bias_table_on(decay, count.device)
        return table[torch.clamp(count, max=table.shape[0] - 1)]
    return torch.tensor(_one_minus_power(decay, np.int64(count)), dtype=torch.float32,
                        device=device)


def _one_minus_power(decay: float, n: np.ndarray) -> np.ndarray:
    """``1 - decay**n`` in float32 for every count in ``n`` at once: XLA
    raises a float to an integer power by repeated squaring, rounding each
    product to float32 (``torch.pow`` rounds differently from the third
    power on)."""
    power = np.ones(np.shape(n), np.float32)
    base = np.float32(decay)
    while np.any(n):
        power = np.where(n & 1, power * base, power).astype(np.float32)
        base = np.float32(base * base)
        n = n >> 1
    return np.float32(1.0) - power


@functools.lru_cache(maxsize=None)
def _bias_table(decay: float) -> np.ndarray:
    """:func:`_one_minus_power` for n = 0..N. N is the first count with
    decay**N < 1e-10: from there on, 1 minus the float32 power rounds to
    1.0, the table's last entry, which the lookup clamps to."""
    last = max(1, math.ceil(math.log(1e-10) / math.log(decay))) if 0.0 < decay < 1.0 else 1
    return _one_minus_power(decay, np.arange(last + 1, dtype=np.int64))


@functools.lru_cache(maxsize=None)
def _bias_table_on(decay: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_bias_table(decay)).to(device)


class AdamState(NamedTuple):
    count: int  # or a per-client integer tensor under the batched schedule
    mu: Params
    nu: Params


class AmsgradState(NamedTuple):
    count: int  # or a per-client integer tensor under the batched schedule
    mu: Params
    nu: Params
    nu_max: Params


def _moments(g: Params, state, b1: float, b2: float):
    """Adam's first and second moment updates."""
    mu = {k: (1 - b1) * g[k] + b1 * state.mu[k] for k in g}
    nu = {k: (1 - b2) * (g[k] ** 2) + b2 * state.nu[k] for k in g}
    return mu, nu


def scale_by_adam(
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0
) -> GradientTransformation:
    """``optax.scale_by_adam``: bias correction on both moments, ``eps``
    outside the square root."""

    def init(params):
        return AdamState(0, _zeros_like(params), _zeros_like(params))

    def update(g, state, params=None):
        mu, nu = _moments(g, state, b1, b2)
        count = state.count + 1
        device = next(iter(g.values())).device
        bc1, bc2 = _bias_correction(b1, count, device), _bias_correction(b2, count, device)
        updates = {k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2 + eps_root) + eps) for k in g}
        return updates, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def scale_by_yogi(
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3, eps_root: float = 0.0,
    initial_accumulator_value: float = 1e-6,
) -> GradientTransformation:
    """``optax.scale_by_yogi``: both moments start at
    ``initial_accumulator_value``; ``v ← v − (1−b2)·sign(v − g²)·g²``; bias
    correction as Adam's."""

    def init(params):
        return AdamState(0, _full_like(params, initial_accumulator_value),
                         _full_like(params, initial_accumulator_value))

    def update(g, state, params=None):
        mu = {k: (1 - b1) * g[k] + b1 * state.mu[k] for k in g}
        nu = {}
        for k in g:
            g2 = g[k] * g[k]
            nu[k] = state.nu[k] - (1 - b2) * torch.sign(state.nu[k] - g2) * g2
        count = state.count + 1
        device = next(iter(g.values())).device
        bc1, bc2 = _bias_correction(b1, count, device), _bias_correction(b2, count, device)
        updates = {k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2 + eps_root) + eps) for k in g}
        return updates, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1, eps: float = 1e-7) -> GradientTransformation:
    """``optax.scale_by_rss`` (Adagrad): ``t ← t + g²``; the update is
    ``g · rsqrt(t + eps)`` where t > 0, else 0."""

    def init(params):
        return ScaleByRssState(_full_like(params, initial_accumulator_value))

    def update(g, state, params=None):
        t = {k: g[k] * g[k] + state.sum_of_squares[k] for k in g}
        updates = {
            k: torch.where(t[k] > 0, torch.rsqrt(t[k] + eps), torch.zeros_like(t[k])) * g[k]
            for k in g
        }
        return updates, ScaleByRssState(t)

    return GradientTransformation(init, update)


def scale_by_amsgrad(
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0
) -> GradientTransformation:
    def init(params):
        return AmsgradState(0, _zeros_like(params), _zeros_like(params), _zeros_like(params))

    def update(g, state, params=None):
        mu, nu = _moments(g, state, b1, b2)
        count = state.count + 1
        device = next(iter(g.values())).device
        bc1, bc2 = _bias_correction(b1, count, device), _bias_correction(b2, count, device)
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
    return chain(trace(momentum) if momentum is not None else identity(), scale(-lr))


def amsgrad(lr: float) -> GradientTransformation:
    return chain(scale_by_amsgrad(), scale(-lr))


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps), scale(-lr))


def yogi(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3) -> GradientTransformation:
    return chain(scale_by_yogi(b1, b2, eps), scale(-lr))


def adagrad(lr: float, initial_accumulator_value: float = 0.1, eps: float = 1e-7) -> GradientTransformation:
    return chain(scale_by_rss(initial_accumulator_value, eps), scale(-lr))


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

