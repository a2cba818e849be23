"""The port's ln_act (fedml_tpu_torch/ops/fused_groupnorm.py) against the
reference's custom-VJP ln_act: forward and backward, with and without the
fused ReLU, in float32 and bfloat16 inputs (the affine parameters in float32
as the LayerNorm module holds them, and in bfloat16 as mixed precision casts
them).

Tolerances: float32 1e-5 absolute (the statistics are float32 sums taken
in another order). bfloat16 outputs and dx: 2^-7 relative plus 1e-2
absolute — one bf16 ulp of O(1) values may round the other way; dγ and dβ
are float32 sums in both packages, so they keep 1e-4 (relative 1e-5 of
sums of ~100 terms)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from fedml_tpu.ops.fused_groupnorm import ln_act as jax_ln_act  # noqa: E402

from fedml_tpu_torch.models.norms import LayerNorm, fp32_layer_norm  # noqa: E402
from fedml_tpu_torch.ops.fused_groupnorm import ln_act  # noqa: E402

EPS = 1e-6


def _inputs(seed=0, shape=(4, 24, 48)):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    gamma = (1 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    beta = (0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    return x, gamma, beta, dy


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("x_dtype,param_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16"),
])
def test_ln_act_forward_and_backward_match_reference(x_dtype, param_dtype, relu):
    x, gamma, beta, dy = _inputs()
    jx, jp = getattr(jnp, x_dtype), getattr(jnp, param_dtype)
    tx, tp = getattr(torch, x_dtype), getattr(torch, param_dtype)

    def jax_loss(x, g, b):
        y = jax_ln_act(x, g, b, EPS, relu)
        return jnp.sum(y.astype(jnp.float32) * dy), y

    (_, jy), (jdx, jdg, jdb) = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x).astype(jx), jnp.asarray(gamma).astype(jp), jnp.asarray(beta).astype(jp)
    )
    t_x = torch.from_numpy(x).to(tx).requires_grad_(True)
    t_g = torch.from_numpy(gamma).to(tp).requires_grad_(True)
    t_b = torch.from_numpy(beta).to(tp).requires_grad_(True)
    ty = ln_act(t_x, t_g, t_b, EPS, relu)
    assert ty.dtype == tx
    (ty.float() * torch.from_numpy(dy)).sum().backward()

    def close(got, want, tight):
        got = got.detach().float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        if tight:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        else:
            np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=1e-2)

    tight = x_dtype == "float32"
    close(ty, jy, tight)
    close(t_x.grad, jdx, tight)
    # dγ, dβ: float32 sums in both; autograd rounds them to a bf16 γ's type
    # (the reference hands them on in float32)
    tight_params = param_dtype == "float32"
    close(t_g.grad, jdg, tight_params)
    close(t_b.grad, jdb, tight_params)


def test_layer_norm_module_uses_flax_epsilon_and_ones_zeros():
    ln = fp32_layer_norm(8)
    assert isinstance(ln, LayerNorm) and ln.epsilon == 1e-6 and not ln.relu
    assert torch.equal(ln.scale.data, torch.ones(8)) and torch.equal(ln.bias.data, torch.zeros(8))
    # rows of ±1e-3 have variance 1e-6, so the epsilon halves it: flax's
    # 1e-6 gives ±1/√2, torch's 1e-5 would give ±0.30
    x = torch.tensor([[1e-3, -1e-3] * 4, [-1e-3, 1e-3] * 4])
    torch.testing.assert_close(ln(x), x / 1e-3 / 2**0.5, rtol=1e-3, atol=1e-3)
