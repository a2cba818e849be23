"""The port's TransformerLM (fedml_tpu_torch/models/transformer.py) against
flax's: the weight bridge round trip, logits and one-step gradients from the
same (bridged) weights under the plain full attention and under flash, the
mixed-precision forward, each parameter's initializer, and the registry.

Tolerances: float32 logits 1e-5 and gradients 1e-5 relative to each leaf's
largest entry (the same float32 arithmetic summed in another order).
bfloat16 (mixed precision, every matmul in bf16): 2^-5 of the largest
magnitude — the two frameworks round a bf16 matmul's output, a bias add and
the GELU at different places, each a bf16 ulp (2^-8), and these compound
over two blocks."""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from fedml_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from fedml_tpu.models import create_model as jax_create_model  # noqa: E402
from fedml_tpu.ops.flash_attention import flash_attention_bthd as jax_flash  # noqa: E402
from fedml_tpu.train import losses as jax_losses  # noqa: E402
from fedml_tpu.train.client import make_mixed_forward as jax_mixed_forward  # noqa: E402

from fedml_tpu_torch.bridge import from_flax, to_flax  # noqa: E402
from fedml_tpu_torch.config import TrainConfig  # noqa: E402
from fedml_tpu_torch.models import create_model  # noqa: E402
from fedml_tpu_torch.ops.flash_attention import flash_attention_bthd  # noqa: E402
from fedml_tpu_torch.train import losses  # noqa: E402
from fedml_tpu_torch.train.client import make_mixed_forward  # noqa: E402

from torch_parity import flat_params  # noqa: E402

V, T, B = 48, 32, 3
KW = dict(num_layers=2, num_heads=2, embed_dim=32)


def _models(attn):
    jkw, tkw = dict(KW), dict(KW)
    if attn == "flash":
        jkw["attn_fn"] = functools.partial(jax_flash, block_q=16, block_k=16)
        tkw["attn_fn"] = functools.partial(flash_attention_bthd, block_q=16, block_k=16)
    jm = jax_create_model("transformer", "shakespeare_synth", (T,), V, **jkw)
    tm = create_model("transformer", "shakespeare_synth", (T,), V, **tkw)
    return jm, tm


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, V, size=(B, T)).astype(np.int32)
    y = rng.integers(0, V, size=(B, T)).astype(np.int32)
    y[:, :3] = 0  # pad tokens: ignored by the loss
    mask = np.array([1.0, 1.0, 0.0], np.float32)  # a padded example
    return x, y, mask


def _flat_torch(state):
    return flat_params(to_flax({k: v for k, v in state.items()}))


def _close_per_leaf(got: dict, want: dict, tol: float):
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k], np.float32), np.asarray(want[k], np.float32)
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(float(np.abs(w).max()), 1e-6),
                                   err_msg=k)


def test_bridge_round_trip_is_exact_and_names_follow_the_scopes():
    jm, tm = _models("full")
    params = jm.init(jax.random.PRNGKey(0))["params"]
    state = from_flax(params)
    assert set(state) == {n for n, _ in tm.module.named_parameters()}
    assert "block1.ln1.scale" in state and "tok_embed.embedding" in state and "pos_embed" in state
    # dense kernels transpose; embeddings and pos_embed do not
    np.testing.assert_array_equal(state["block0.qkv.weight"].numpy(),
                                  np.asarray(params["block0"]["qkv"]["kernel"]).T)
    np.testing.assert_array_equal(state["tok_embed.embedding"].numpy(),
                                  np.asarray(params["tok_embed"]["embedding"]))
    back, want = flat_params(to_flax(state)), flat_params(params)
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].dtype == want[k].dtype and back[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("attn", ["full", "flash"])
def test_logits_and_one_step_gradients_match_flax(attn):
    jm, tm = _models(attn)
    params = jm.init(jax.random.PRNGKey(1))["params"]
    x, y, mask = _batch()

    def jax_loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(x), train=True)[0]
        return jax_losses.masked_seq_ce(logits, jnp.asarray(y), jnp.asarray(mask)), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    state = {k: v.requires_grad_(True) for k, v in from_flax(params).items()}
    tlogits, _ = tm.apply(state, torch.from_numpy(x), train=True)
    tl = losses.masked_seq_ce(tlogits, torch.from_numpy(y), torch.from_numpy(mask))
    tl.backward()
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), rtol=0, atol=1e-5)
    assert abs(tl.item() - float(jl)) < 1e-5
    _close_per_leaf(_flat_torch({k: v.grad for k, v in state.items()}), flat_params(jgrads), 1e-5)


def test_mixed_precision_forward_and_gradients_match_flax():
    jm, tm = _models("flash")
    params = jm.init(jax.random.PRNGKey(2))["params"]
    x, y, mask = _batch(1)
    jfwd = jax_mixed_forward(jm, JaxTrainConfig(compute_dtype="bfloat16"))
    tfwd = make_mixed_forward(tm, TrainConfig(compute_dtype="bfloat16"))

    def jax_loss(p):
        logits, _ = jfwd(p, {}, jnp.asarray(x), None)
        return jax_losses.masked_seq_ce(logits, jnp.asarray(y), jnp.asarray(mask)), logits

    (_, jlogits), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    state = {k: v.requires_grad_(True) for k, v in from_flax(params).items()}
    tlogits = tfwd(state, torch.from_numpy(x))
    assert tlogits.dtype == torch.float32
    losses.masked_seq_ce(tlogits, torch.from_numpy(y), torch.from_numpy(mask)).backward()
    for k, v in state.items():  # gradients land in float32 on the master params
        assert v.grad.dtype == torch.float32, k
    _close_per_leaf({"logits": tlogits.detach().numpy()}, {"logits": np.asarray(jlogits)}, 2.0**-5)
    _close_per_leaf(_flat_torch({k: v.grad for k, v in state.items()}), flat_params(jgrads), 2.0**-5)


def test_init_follows_each_flax_initializer():
    """Moments per leaf of a wider model: each port leaf against the flax
    leaf (different random streams, so statistics, not values) and against
    the initializer's own std. 5% on the std is ~4σ of the estimate at the
    smallest leaf (≥ 8,192 draws)."""
    kw = dict(num_layers=1, num_heads=2, embed_dim=64)
    jm = jax_create_model("transformer", "shakespeare_synth", (128,), 256, **kw)
    tm = create_model("transformer", "shakespeare_synth", (128,), 256, **kw)
    want = flat_params(jm.init(jax.random.PRNGKey(0))["params"])
    got = _flat_torch(tm.init(torch.Generator().manual_seed(0)))
    assert got.keys() == want.keys()
    expected_std = {"embedding": 64**-0.5, "pos_embed": 0.02}
    for k in want:
        g, w = got[k], want[k]
        leaf = k.rsplit("/", 1)[-1]
        if leaf in ("scale", "bias"):
            np.testing.assert_array_equal(g, w, err_msg=k)  # ones / zeros
            continue
        std = expected_std.get(leaf, w.shape[0] ** -0.5)  # lecun: fan_in = kernel rows
        for a in (g, w):
            assert abs(a.std() / std - 1) < 0.05, (k, a.std(), std)
            assert abs(a.mean()) < 5 * std / np.sqrt(a.size), k
        # lecun_normal is truncated at 2σ of its underlying normal; the
        # embedding tables are not truncated
        limit = 2 / 0.87962566103423978
        assert (np.abs(g).max() / std <= limit + 1e-4) == (np.abs(w).max() / std <= limit + 1e-4), k


def test_registry_passes_options_and_refuses_moe():
    m = create_model("transformer", "shakespeare_synth", (24,), 40,
                     num_layers=3, num_heads=4, embed_dim=16)
    assert m.name == "transformer" and m.input_dtype == torch.int32 and m.num_classes == 40
    assert m.module.pos_embed.shape == (24, 16)  # max_len defaults to the window
    assert m.module.num_layers == 3 and m.module.block2.num_heads == 4
    m = create_model("transformer", "x", (24,), 40, max_len=64, attn_fn=flash_attention_bthd)
    assert m.module.pos_embed.shape[0] == 64 and m.module.block0.attn_fn is flash_attention_bthd
    with pytest.raises(ValueError, match="MoE"):
        create_model("transformer", "x", (24,), 40, moe_experts=4)
    with pytest.raises(TypeError):
        create_model("cnn", "femnist", (28, 28, 1), 62, num_layers=2)


def test_layer_norm_scale_starts_at_one():
    m = create_model("transformer", "x", (16,), 32, num_layers=1, num_heads=2, embed_dim=16)
    v = m.init(torch.Generator().manual_seed(0))
    assert torch.equal(v["block0.ln1.scale"], torch.ones(16))
    assert torch.equal(v["ln_f.bias"], torch.zeros(16))
    assert torch.equal(v["block0.mlp_up.bias"], torch.zeros(64))
