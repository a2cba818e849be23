"""LayerNorm(+ReLU) with a hand-written backward (port of the ``ln_act``
part of ``fedml_tpu/ops/fused_groupnorm.py``; ``gn_act`` waits for the
model-zoo slice, ROADMAP.md).

The reference is a ``jax.custom_vjp``, not a Pallas kernel: its forward
saves only (x, γ, β) and its backward recomputes the statistics. Both are
kept here as a ``torch.autograd.Function`` in plain torch ops, with the
reference's arithmetic: float32 statistics, the variance as E[x²]−E[x]²,
``rsqrt(var + eps)``, the output rounded back to x's type.
``F.layer_norm`` computes the variance another way and is not used."""

from __future__ import annotations

import torch


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
    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float, relu: bool):
        ctx.save_for_backward(x, gamma, beta)
        ctx.cfg = (eps, relu)
        return _ln_normalize(x, gamma, beta, eps, relu)

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
