"""LayerNorm's parameter gradients under bfloat16 compute, port against
reference.

The reference casts the float32 master params to bf16 and its custom VJP
``_ln_bwd`` returns float32 dγ and dβ, which the transpose of the cast
hands to the masters unrounded. The port keeps γ and β float32 holding
bf16 values (``make_mixed_forward``), so ``ln_act``'s float32 dγ and dβ
reach the masters unrounded too.

Tolerance: rtol 1e-5 (plus 1e-6·max|ref|) — both packages sum the same
float32 terms in another order. Gradients rounded to bf16 would miss it by
~2⁻⁹ relative. In a whole model the port's and the reference's bf16
products may round one ulp apart upstream of a LayerNorm, so the 1-layer
LM check feeds the reference's VJP the x and dy that reach each of the
port's LayerNorms, and compares what each package makes of them."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from fedml_tpu.ops.fused_groupnorm import ln_act as jax_ln_act  # noqa: E402

from fedml_tpu_torch.config import TrainConfig  # noqa: E402
from fedml_tpu_torch.models import create_model  # noqa: E402
from fedml_tpu_torch.models.norms import LayerNorm  # noqa: E402
from fedml_tpu_torch.ops.fused_groupnorm import ln_act  # noqa: E402
from fedml_tpu_torch.train import losses  # noqa: E402
from fedml_tpu_torch.train.client import _RoundTo, cast_floats, make_mixed_forward  # noqa: E402

EPS = 1e-6
RTOL = 1e-5


def _ref_param_grads(x, gamma, beta, dy, relu):
    """The reference: jax.grad w.r.t. float32 γ, β of ln_act on their bf16
    casts, with cotangent dy (x and dy as numpy float32, x rounded to bf16)."""

    def loss(g, b):
        y = jax_ln_act(jnp.asarray(x).astype(jnp.bfloat16), g.astype(jnp.bfloat16),
                       b.astype(jnp.bfloat16), EPS, relu)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy))

    dg, db = jax.grad(loss, argnums=(0, 1))(jnp.asarray(gamma), jnp.asarray(beta))
    assert dg.dtype == db.dtype == jnp.float32
    return np.asarray(dg), np.asarray(db)


def _assert_grad_close(got, want, what):
    got = got.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6 * np.abs(want).max(), err_msg=what)


def _bf16_exact(t):
    return torch.equal(t, t.bfloat16().float())


@pytest.mark.parametrize("relu", [False, True])
def test_ln_act_param_grads_are_not_rounded_under_bf16(relu):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 16, 32)) * 3 + 1).astype(np.float32)
    gamma = (1 + 0.1 * rng.normal(size=32)).astype(np.float32)
    beta = (0.1 * rng.normal(size=32)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    want_dg, want_db = _ref_param_grads(x, gamma, beta, dy, relu)

    t_x = torch.from_numpy(x).bfloat16()
    t_g = torch.from_numpy(gamma).requires_grad_(True)
    t_b = torch.from_numpy(beta).requires_grad_(True)
    y = ln_act(t_x, _RoundTo.apply(t_g, torch.bfloat16), _RoundTo.apply(t_b, torch.bfloat16),
               EPS, relu)
    (y.float() * torch.from_numpy(dy)).sum().backward()
    _assert_grad_close(t_g.grad, want_dg, "dγ")
    _assert_grad_close(t_b.grad, want_db, "dβ")
    assert t_g.grad.dtype == t_b.grad.dtype == torch.float32
    assert not _bf16_exact(t_g.grad) and not _bf16_exact(t_b.grad)
    # the forward is the one a bf16 γ, β give
    old = ln_act(t_x, t_g.detach().bfloat16(), t_b.detach().bfloat16(), EPS, relu)
    assert y.dtype == old.dtype == torch.bfloat16 and torch.equal(y, old)


def _lm_step(model, params, x, y, mask, capture):
    """One forward and backward of make_mixed_forward at bf16 compute;
    ``capture`` collects (module name, x, dy) at every LayerNorm."""
    handles = []
    for name, mod in model.module.named_modules():
        if isinstance(mod, LayerNorm):
            def hook(m, inputs, out, name=name):
                entry = [name, inputs[0].detach(), None]
                capture.append(entry)
                out.register_hook(lambda g: entry.__setitem__(2, g.detach()))
            handles.append(mod.register_forward_hook(hook))
    fwd = make_mixed_forward(model, TrainConfig(compute_dtype="bfloat16"))
    logits = fwd(params, x)
    losses.masked_seq_ce(logits, y, mask).backward()
    for h in handles:
        h.remove()
    return logits


def test_mixed_forward_ln_grads_match_reference_on_one_layer_lm():
    S, V = 16, 32
    model = create_model("transformer", "shakespeare_synth", (S,), V, num_layers=1,
                         num_heads=2, embed_dim=32)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    for k, v in params.items():  # LayerNorm's ones and zeros would hide a rounding
        if k.endswith((".scale", ".bias")):
            v += torch.from_numpy((0.1 * rng.normal(size=v.shape)).astype(np.float32))
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    x = torch.from_numpy(rng.integers(1, V, size=(4, S)).astype(np.int64))
    y = torch.from_numpy(rng.integers(1, V, size=(4, S)).astype(np.int64))
    mask = torch.ones(4)

    capture = []
    logits = _lm_step(model, params, x, y, mask, capture)
    assert [c[0] for c in capture] == ["block0.ln1", "block0.ln2", "ln_f"]
    for name, ln_x, dy in capture:
        want_dg, want_db = _ref_param_grads(ln_x.float().numpy(), params[f"{name}.scale"].detach().numpy(),
                                            params[f"{name}.bias"].detach().numpy(),
                                            dy.float().numpy(), relu=False)
        dg, db = params[f"{name}.scale"].grad, params[f"{name}.bias"].grad
        assert dg.dtype == db.dtype == torch.float32
        _assert_grad_close(dg, want_dg, f"{name} dγ")
        _assert_grad_close(db, want_db, f"{name} dβ")
        assert not _bf16_exact(dg) and not _bf16_exact(db), name

    # the forward is that of every param cast to bf16
    with torch.no_grad():
        cast = cast_floats({k: v.detach() for k, v in params.items()}, torch.bfloat16)
        old = model.apply(cast, x, train=True)[0].float()
    assert torch.equal(logits.detach(), old)
