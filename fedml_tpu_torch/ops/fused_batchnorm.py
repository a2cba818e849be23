"""Training BatchNorm(+ReLU) with a hand-written backward (port of
``fedml_tpu/ops/fused_batchnorm.py``).

The reference is a ``jax.custom_vjp``, not a Pallas kernel, so it is kept
here as a ``torch.autograd.Function`` in plain torch ops with the
reference's arithmetic:

- the statistics are biased float32 batch moments of the upcast input,
  the variance as E[x²]−E[x]² (flax's ``_compute_stats``);
- the forward saves only x (in its own type), γ, β and the two C-sized
  statistics, never a float32 copy of the activation;
- the backward recomputes x̂, rebuilds the folded ReLU's mask from
  x̂·γ+β > 0 and takes the full BN gradient, the terms through μ and σ²
  included;
- the ``mean`` and ``var`` outputs feed the running-stat EMA only: they
  get no gradient;
- differentiated twice (``create_graph=True``, FedNAS's unrolled
  architect), the backward recomputes μ and σ² from x with recorded ops, so
  the second derivative carries their dependence on x, as JAX's does when
  it differentiates the custom VJP's forward rule under grad-of-grad; with
  grad mode off it uses the saved statistics (the same arithmetic).

``channel_axis`` names the channel dimension: −1 is the reference's NHWC
layout, 1 the NCHW layout the port's convolutional models run in; every
other axis is reduced."""

from __future__ import annotations

import functools

import torch


def _axes(x, channel_axis: int):
    """(the reduced axes, the broadcast shape of a per-channel vector)."""
    return _axes_of(x.dim(), channel_axis % x.dim(), x.shape[channel_axis])


@functools.lru_cache(maxsize=None)
def _axes_of(ndim: int, ca: int, channels: int):
    shape = [1] * ndim
    shape[ca] = channels
    return tuple(d for d in range(ndim) if d != ca), tuple(shape)


def _stats_f32(x, channel_axis: int):
    """Biased per-channel moments in float32: mean and E[x²]−mean²."""
    reduce, _ = _axes(x, channel_axis)
    x32 = x.float()
    mean = torch.mean(x32, dim=reduce)
    var = torch.mean(x32 * x32, dim=reduce) - mean * mean
    return mean, var


def _normalize(x, mean, var, gamma, beta, eps: float, relu: bool, channel_axis: int):
    _, shape = _axes(x, channel_axis)
    inv = torch.rsqrt(var + eps)
    y = (x.float() - mean.view(shape)) * (inv * gamma).view(shape) + beta.view(shape)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


class _BnAct(torch.autograd.Function):
    generate_vmap_rule = True  # plain torch ops: torch.func.vmap batches them

    @staticmethod
    def forward(x, gamma, beta, eps: float, relu: bool, channel_axis: int):
        mean, var = _stats_f32(x, channel_axis)
        y = _normalize(x, mean, var, gamma, beta, eps, relu, channel_axis)
        return y, mean, var

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, gamma, beta, eps, relu, channel_axis = inputs
        _, mean, var = output
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.cfg = (eps, relu, channel_axis)
        ctx.mark_non_differentiable(mean, var)

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, beta, mean, var = ctx.saved_tensors
        eps, relu, channel_axis = ctx.cfg
        if torch.is_grad_enabled():
            # a graph is being built (create_graph=True): the saved
            # statistics are constants to autograd, recomputed ones are not
            mean, var = _stats_f32(x, channel_axis)
        reduce, shape = _axes(x, channel_axis)
        inv = torch.rsqrt(var + eps)
        xhat = (x.float() - mean.view(shape)) * inv.view(shape)
        dy32 = dy.float()
        if relu:
            dy32 = dy32 * (xhat * gamma.view(shape) + beta.view(shape) > 0.0)
        n = x.numel() // x.shape[channel_axis]
        dbeta = torch.sum(dy32, dim=reduce)
        dgamma = torch.sum(dy32 * xhat, dim=reduce)
        dx = (gamma * inv / n).view(shape) * (
            n * dy32 - dbeta.view(shape) - xhat * dgamma.view(shape)
        )
        # float32 dγ, dβ, as the reference's (see train/client.py
        # make_mixed_forward for γ and β under a bf16 compute type)
        return dx.to(x.dtype), dgamma, dbeta, None, None, None


def bn_act(x, gamma, beta, eps: float, relu: bool, channel_axis: int = -1):
    """Training-mode BatchNorm(+ReLU) with batch statistics →
    ``(y, mean, var)``: y in x's type, the statistics float32 and without
    gradient."""
    return _BnAct.apply(x, gamma, beta, eps, relu, channel_axis)


def bn_inference(x, ra_mean, ra_var, gamma, beta, eps: float, relu: bool, channel_axis: int = -1):
    """Eval-mode normalize with the running statistics (float32 math, the
    output in x's type)."""
    return _normalize(x, ra_mean, ra_var, gamma, beta, eps, relu, channel_axis)
