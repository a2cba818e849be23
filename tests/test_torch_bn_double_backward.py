"""The second derivative of the port's fused norms against the reference's.

The reference's ``bn_act``, ``gn_act`` and ``ln_act`` are ``jax.custom_vjp``s:
under ``jax.grad(jax.grad(...))`` JAX differentiates their backward rules
and the forward rules that produced the residuals, so the batch statistics
carry their dependence on x. The port's are ``torch.autograd.Function``s
whose backwards are differentiated under ``create_graph=True``. Both
packages get the same float32 inputs (numpy, seeded) and the same
objective: the loss L = Σ(w·y + ½y²), then G = Σ(∂L/∂x)² + Σ(∂L/∂γ)², and
the gradient of G with respect to x, γ and β.

Tolerance: rtol 1e-5 and atol 1e-5 times the largest magnitude of the
reference's three gradients (dβ of a loss without the ReLU is zero up to
cancellation, so it is held to the scale of the others). Both sides
compute in float32 and sum in different orders; the second derivative of
a normalisation subtracts terms of the size of 1/σ³ from each other,
which makes its rounding several ulps of the largest entry (measured on
the CPU: at most 6.7e-7 of it for BN). Without
the recomputed statistics the port's BN misses by O(1) of that scale."""

import numpy as np
import pytest
import torch

from fedml_tpu_torch.ops.fused_batchnorm import _stats_f32, bn_act
from fedml_tpu_torch.ops.fused_groupnorm import gn_act, ln_act

from torch_parity import torch_threads

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _inputs(shape, channels, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.3, 1.5, size=shape).astype(np.float32)
    w = rng.normal(size=shape).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, size=channels).astype(np.float32)
    beta = rng.normal(0.0, 0.3, size=channels).astype(np.float32)
    return x, w, gamma, beta


def _jax_second(norm, x, w, gamma, beta):
    import jax
    import jax.numpy as jnp

    def loss(x, g, b):
        y = norm(x, g, b)
        return jnp.sum(w * y + 0.5 * y * y)

    def outer(x, g, b):
        gx, gg = jax.grad(loss, argnums=(0, 1))(x, g, b)
        return jnp.sum(gx * gx) + jnp.sum(gg * gg)

    return [np.asarray(a) for a in jax.jit(jax.grad(outer, argnums=(0, 1, 2)))(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))]


def _torch_second(norm, x, w, gamma, beta):
    xt, gt, bt = (torch.tensor(a, requires_grad=True) for a in (x, gamma, beta))
    y = norm(xt, gt, bt)
    loss = torch.sum(torch.from_numpy(w) * y + 0.5 * y * y)
    gx, gg = torch.autograd.grad(loss, (xt, gt), create_graph=True)
    outer = torch.sum(gx * gx) + torch.sum(gg * gg)
    return [a.detach().numpy() for a in torch.autograd.grad(outer, (xt, gt, bt))]


def _assert_close(got, want, what):
    scale = max(float(np.max(np.abs(r))) for r in want)
    for name, g, r in zip(("x", "gamma", "beta"), got, want):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=RTOL * scale, err_msg=f"{what} d{name}")


BN_CASES = [((6, 4), 4), ((3, 5, 4, 6), 6)]  # dense [B, C], NHWC [B, H, W, C]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape,channels", BN_CASES)
def test_bn_act_grad_of_grad_matches_reference(shape, channels, relu):
    from fedml_tpu.ops.fused_batchnorm import bn_act as jax_bn_act

    x, w, gamma, beta = _inputs(shape, channels, seed=len(shape) + relu)
    want = _jax_second(lambda x, g, b: jax_bn_act(x, g, b, 1e-5, relu)[0], x, w, gamma, beta)
    got = _torch_second(lambda x, g, b: bn_act(x, g, b, 1e-5, relu)[0], x, w, gamma, beta)
    _assert_close(got, want, f"bn_act{shape} relu={relu}")


@pytest.mark.parametrize("relu", [False, True])
def test_bn_act_nchw_grad_of_grad_matches_nhwc_reference(relu):
    """The port's models run NCHW (channel_axis=1): the same numbers as the
    reference's NHWC op on the transposed input."""
    from fedml_tpu.ops.fused_batchnorm import bn_act as jax_bn_act

    x, w, gamma, beta = _inputs((3, 5, 4, 6), 6, seed=7 + relu)
    want = _jax_second(lambda x, g, b: jax_bn_act(x, g, b, 1e-5, relu)[0], x, w, gamma, beta)
    to_nchw = lambda a: np.ascontiguousarray(a.transpose(0, 3, 1, 2))
    got = _torch_second(lambda x, g, b: bn_act(x, g, b, 1e-5, relu, channel_axis=1)[0],
                        to_nchw(x), to_nchw(w), gamma, beta)
    got[0] = got[0].transpose(0, 2, 3, 1)
    _assert_close(got, want, f"bn_act NCHW relu={relu}")


@pytest.mark.parametrize("relu", [False, True])
def test_bn_act_first_order_backward_is_the_saved_statistics_formula(relu):
    """With grad mode off the backward keeps its arithmetic: the full BN
    gradient from the statistics the forward saved, bit for bit."""
    x, w, gamma, beta = _inputs((4, 3, 5, 6), 6, seed=11)
    xt, gt, bt = (torch.tensor(a, requires_grad=True) for a in (x, gamma, beta))
    dy = torch.from_numpy(w)
    y, _, _ = bn_act(xt, gt, bt, 1e-5, relu)
    got = torch.autograd.grad(y, (xt, gt, bt), dy)
    with torch.no_grad():
        xd = xt.detach()
        mean, var = _stats_f32(xd, -1)
        inv = torch.rsqrt(var + 1e-5)
        xhat = (xd.float() - mean) * inv
        dy32 = dy * (xhat * gt + bt > 0.0) if relu else dy
        n = xd.numel() // xd.shape[-1]
        dbeta = torch.sum(dy32, dim=(0, 1, 2))
        dgamma = torch.sum(dy32 * xhat, dim=(0, 1, 2))
        dx = (gt * inv / n) * (n * dy32 - dbeta - xhat * dgamma)
    for g, r in zip(got, (dx, dgamma, dbeta)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("relu", [False, True])
def test_gn_act_grad_of_grad_matches_reference(relu):
    from fedml_tpu.ops.fused_groupnorm import gn_act as jax_gn_act

    x, w, gamma, beta = _inputs((2, 4, 3, 8), 8, seed=21 + relu)
    want = _jax_second(lambda x, g, b: jax_gn_act(x, g, b, 2, 1e-6, relu), x, w, gamma, beta)
    got = _torch_second(lambda x, g, b: gn_act(x, g, b, 2, 1e-6, relu), x, w, gamma, beta)
    _assert_close(got, want, f"gn_act relu={relu}")


@pytest.mark.parametrize("relu", [False, True])
def test_ln_act_grad_of_grad_matches_reference(relu):
    from fedml_tpu.ops.fused_groupnorm import ln_act as jax_ln_act

    x, w, gamma, beta = _inputs((5, 3, 8), 8, seed=31 + relu)
    want = _jax_second(lambda x, g, b: jax_ln_act(x, g, b, 1e-6, relu), x, w, gamma, beta)
    got = _torch_second(lambda x, g, b: ln_act(x, g, b, 1e-6, relu), x, w, gamma, beta)
    _assert_close(got, want, f"ln_act relu={relu}")
