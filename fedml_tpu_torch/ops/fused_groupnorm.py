"""GroupNorm(+ReLU) and LayerNorm(+ReLU) with hand-written backwards
(port of ``fedml_tpu/ops/fused_groupnorm.py``: ``gn_act`` and ``ln_act``).

The reference's are ``jax.custom_vjp``s, not Pallas kernels: each forward
saves only (x, γ, β) and each backward recomputes the statistics. Both are
kept here as ``torch.autograd.Function``s in plain torch ops, with the
reference's arithmetic: float32 statistics, the variance as E[x²]−E[x]²,
``rsqrt(var + eps)``, the output rounded back to x's type.
``F.group_norm`` and ``F.layer_norm`` compute the variance another way and
are not used. Both Functions take the ``setup_context`` form with
``generate_vmap_rule``, so the batched client schedule runs them under
``torch.func.vmap``."""

from __future__ import annotations

import torch


# --------------------------------------------------------------------------
# GroupNorm


def _gn_shapes(x, group_size: int, channel_axis: int):
    C = x.shape[channel_axis]
    if C % group_size:
        raise ValueError(f"channels {C} not divisible by group_size {group_size}")
    return x.shape[0], C // group_size, group_size


def _gn_grouped(t, N, G, gs, channel_axis: int):
    """(N, spatial..., C) → (N, S, G, gs), or (N, C, spatial...) →
    (N, G, gs, S) for ``channel_axis`` 1; returns the view and the axes
    of one (sample, group)'s statistics."""
    if channel_axis % t.dim() == t.dim() - 1:
        return t.reshape(N, -1, G, gs), (1, 3)
    if channel_axis == 1:
        return t.reshape(N, G, gs, -1), (2, 3)
    raise ValueError(f"gn_act takes the channels last or at axis 1; got axis {channel_axis}")


def _gn_stats(x, group_size: int, eps: float, channel_axis: int):
    N, G, gs = _gn_shapes(x, group_size, channel_axis)
    xg, axes = _gn_grouped(x.float(), N, G, gs, channel_axis)
    mean = torch.mean(xg, dim=axes, keepdim=True)
    var = torch.mean(xg * xg, dim=axes, keepdim=True) - mean * mean
    return xg, axes, mean, torch.rsqrt(var + eps)


def _channel_shape(x, channel_axis: int):
    shape = [1] * x.dim()
    shape[channel_axis] = x.shape[channel_axis]
    return shape


def _gn_normalize(x, gamma, beta, group_size: int, eps: float, relu: bool, channel_axis: int):
    xg, _, mean, inv = _gn_stats(x, group_size, eps, channel_axis)
    shape = _channel_shape(x, channel_axis)
    xhat = ((xg - mean) * inv).reshape(x.shape)
    y = xhat * gamma.view(shape) + beta.view(shape)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


class _GnAct(torch.autograd.Function):
    generate_vmap_rule = True  # plain torch ops: torch.func.vmap batches them

    @staticmethod
    def forward(x, gamma, beta, group_size: int, eps: float, relu: bool, channel_axis: int):
        return _gn_normalize(x, gamma, beta, group_size, eps, relu, channel_axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, gamma, beta, group_size, eps, relu, channel_axis = inputs
        ctx.save_for_backward(x, gamma, beta)
        ctx.cfg = (group_size, eps, relu, channel_axis)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta = ctx.saved_tensors
        group_size, eps, relu, channel_axis = ctx.cfg
        N, G, gs = _gn_shapes(x, group_size, channel_axis)
        xg, axes, mean, inv = _gn_stats(x, group_size, eps, channel_axis)
        xhat = (xg - mean) * inv
        shape = _channel_shape(x, channel_axis)
        dy32 = dy.float()
        if relu:
            y_lin = xhat.reshape(x.shape) * gamma.view(shape) + beta.view(shape)
            dy32 = dy32 * (y_lin > 0.0)
        dyg, _ = _gn_grouped(dy32, N, G, gs, channel_axis)
        # per-channel affine gradients: sums over the batch and the space
        space = 1 if axes == (1, 3) else 3
        dgamma = torch.sum(dyg * xhat, dim=(0, space)).reshape(-1)
        dbeta = torch.sum(dyg, dim=(0, space)).reshape(-1)
        dxhat = dyg * gamma.view((1, 1, G, gs) if space == 1 else (1, G, gs, 1))
        n = xg.shape[space] * gs
        s1 = torch.sum(dxhat, dim=axes, keepdim=True)
        s2 = torch.sum(dxhat * xhat, dim=axes, keepdim=True)
        dx = (inv / n) * (n * dxhat - s1 - xhat * s2)
        # float32 dγ, dβ, as the reference's (train/client.py
        # make_mixed_forward)
        return dx.reshape(x.shape).to(x.dtype), dgamma, dbeta, None, None, None, None


def gn_act(x, gamma, beta, group_size: int, eps: float, relu: bool, channel_axis: int = -1):
    """GroupNorm(+ReLU) over groups of ``group_size`` channels: biased
    float32 moments per (sample, group) over the group's channels and every
    spatial position; y in x's type, float32 affine."""
    return _GnAct.apply(x, gamma, beta, group_size, eps, relu, channel_axis)


# --------------------------------------------------------------------------
# LayerNorm


def _ln_stats(x, eps: float):
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True) - mean * mean
    return x32, mean, torch.rsqrt(var + eps)


def _ln_normalize(x, gamma, beta, eps: float, relu: bool):
    x32, mean, inv = _ln_stats(x, eps)
    y = (x32 - mean) * inv * gamma + beta
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


class _LnAct(torch.autograd.Function):
    generate_vmap_rule = True  # plain torch ops: torch.func.vmap batches them

    @staticmethod
    def forward(x, gamma, beta, eps: float, relu: bool):
        return _ln_normalize(x, gamma, beta, eps, relu)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, gamma, beta, eps, relu = inputs
        ctx.save_for_backward(x, gamma, beta)
        ctx.cfg = (eps, relu)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta = ctx.saved_tensors
        eps, relu = ctx.cfg
        x32, mean, inv = _ln_stats(x, eps)
        xhat = (x32 - mean) * inv
        dy32 = dy.float()
        if relu:
            dy32 = dy32 * (xhat * gamma + beta > 0.0)
        lead = tuple(range(x.dim() - 1))
        dgamma = torch.sum(dy32 * xhat, dim=lead)
        dbeta = torch.sum(dy32, dim=lead)
        dxhat = dy32 * gamma
        D = x.shape[-1]
        s1 = torch.sum(dxhat, dim=-1, keepdim=True)
        s2 = torch.sum(dxhat * xhat, dim=-1, keepdim=True)
        dx = (inv / D) * (D * dxhat - s1 - xhat * s2)
        # float32 dγ, dβ, as the reference's; autograd would round them to a
        # bf16 γ's and β's type, so mixed precision passes float32 γ and β
        # holding bf16 values (train/client.py make_mixed_forward)
        return dx.to(x.dtype), dgamma, dbeta, None, None


def ln_act(x, gamma, beta, eps: float, relu: bool):
    """LayerNorm(+ReLU) over the last axis: y in x's type; float32 affine."""
    return _LnAct.apply(x, gamma, beta, eps, relu)
