"""The port's batch and group norms against the reference's custom VJPs:
``bn_act`` and ``bn_inference`` (fedml_tpu_torch/ops/fused_batchnorm.py)
and ``gn_act`` (ops/fused_groupnorm.py) — forward, backward, the folded
ReLU, float32 and bfloat16 inputs, the reference's NHWC layout and the
NCHW the port's models run; the BatchNorm layer's running-stat EMA against
flax's; a partly padded batch; and BatchNorm's float32 dγ, dβ under bf16
compute.

Tolerances, as |got − want| ≤ tol · max(1, max|want|):
- float32 outputs and gradients, 1e-5: the same float32 arithmetic, the
  sums taken in another order;
- bfloat16 outputs and dx, 2^-7: one bf16 ulp of a value may round the
  other way when the float32 sums before it differ in their last bits;
- the float32 statistics and dγ, dβ at bfloat16 inputs, 1e-5: float32
  sums over the same bf16 values in both packages."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from fedml_tpu.ops.fused_batchnorm import bn_act as jax_bn_act  # noqa: E402
from fedml_tpu.ops.fused_batchnorm import bn_inference as jax_bn_inference  # noqa: E402
from fedml_tpu.ops.fused_groupnorm import gn_act as jax_gn_act  # noqa: E402

from fedml_tpu_torch.models import ModelDef  # noqa: E402
from fedml_tpu_torch.models.norms import BatchNorm, GroupNorm, fp32_batch_norm  # noqa: E402
from fedml_tpu_torch.ops.fused_batchnorm import bn_act, bn_inference  # noqa: E402
from fedml_tpu_torch.ops.fused_groupnorm import gn_act  # noqa: E402

F32_TOL, BF16_TOL, STAT_TOL = 1e-5, 2.0**-7, 1e-5
SHAPE = (6, 5, 5, 8)  # NHWC


def _inputs(seed=0, shape=SHAPE, pad_rows=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    if pad_rows:
        x[-pad_rows:] = 0.0  # the zero rows stack_clients pads a short client with
    gamma = (1 + 0.2 * rng.normal(size=shape[-1:])).astype(np.float32)
    beta = (0.2 * rng.normal(size=shape[-1:])).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    return x, gamma, beta, dy


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


def _to_layout(a: np.ndarray, nchw: bool) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2) if nchw else a))


def _from_layout(t: torch.Tensor, nchw: bool) -> torch.Tensor:
    return t.permute(0, 2, 3, 1) if nchw else t


@pytest.mark.parametrize("nchw", [False, True], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pad_rows", [0, 2], ids=["full", "padded"])
def test_bn_act_forward_backward_match_reference(dtype, relu, nchw, pad_rows):
    x, gamma, beta, dy = _inputs(pad_rows=pad_rows)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jax_loss(x, g, b):
        y, mean, var = jax_bn_act(x, g, b, 1e-5, relu)
        return jnp.sum(y.astype(jnp.float32) * dy), (y, mean, var)

    (_, (jy, jmean, jvar)), (jdx, jdg, jdb) = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True
    )(jnp.asarray(x).astype(jdt), jnp.asarray(gamma), jnp.asarray(beta))

    tx = _to_layout(x, nchw).to(tdt).requires_grad_(True)
    tg = torch.from_numpy(gamma).requires_grad_(True)
    tb = torch.from_numpy(beta).requires_grad_(True)
    y, mean, var = bn_act(tx, tg, tb, 1e-5, relu, channel_axis=1 if nchw else -1)
    assert y.dtype == tdt and mean.dtype == var.dtype == torch.float32
    assert not mean.requires_grad and not var.requires_grad
    (_from_layout(y, nchw).float() * torch.from_numpy(dy)).sum().backward()

    out_tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(_from_layout(y, nchw), jy.astype(jnp.float32), out_tol, "y")
    _close(mean, jmean, STAT_TOL, "mean")
    _close(var, jvar, STAT_TOL, "var")
    _close(_from_layout(tx.grad, nchw), jdx.astype(jnp.float32), out_tol, "dx")
    assert tg.grad.dtype == tb.grad.dtype == torch.float32
    _close(tg.grad, jdg, STAT_TOL, "dgamma")
    _close(tb.grad, jdb, STAT_TOL, "dbeta")


@pytest.mark.parametrize("nchw", [False, True], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_inference_matches_reference(dtype, nchw):
    x, gamma, beta, _ = _inputs(1)
    rng = np.random.default_rng(2)
    ra_mean = rng.normal(size=gamma.shape).astype(np.float32)
    ra_var = rng.uniform(0.5, 2.0, size=gamma.shape).astype(np.float32)
    want = jax_bn_inference(jnp.asarray(x).astype(getattr(jnp, dtype)), jnp.asarray(ra_mean),
                            jnp.asarray(ra_var), jnp.asarray(gamma), jnp.asarray(beta), 1e-5, True)
    got = bn_inference(_to_layout(x, nchw).to(getattr(torch, dtype)), torch.from_numpy(ra_mean),
                       torch.from_numpy(ra_var), torch.from_numpy(gamma), torch.from_numpy(beta),
                       1e-5, True, channel_axis=1 if nchw else -1)
    _close(_from_layout(got, nchw), want.astype(jnp.float32),
           F32_TOL if dtype == "float32" else BF16_TOL, "y")


@pytest.mark.parametrize("nchw", [False, True], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group_size", [2, 4])
def test_gn_act_forward_backward_match_reference(dtype, relu, nchw, group_size):
    x, gamma, beta, dy = _inputs(3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jax_loss(x, g, b):
        y = jax_gn_act(x, g, b, group_size, 1e-6, relu)
        return jnp.sum(y.astype(jnp.float32) * dy), y

    (_, jy), (jdx, jdg, jdb) = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x).astype(jdt), jnp.asarray(gamma), jnp.asarray(beta)
    )
    tx = _to_layout(x, nchw).to(tdt).requires_grad_(True)
    tg = torch.from_numpy(gamma).requires_grad_(True)
    tb = torch.from_numpy(beta).requires_grad_(True)
    y = gn_act(tx, tg, tb, group_size, 1e-6, relu, channel_axis=1 if nchw else -1)
    assert y.dtype == tdt
    (_from_layout(y, nchw).float() * torch.from_numpy(dy)).sum().backward()
    out_tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(_from_layout(y, nchw), jy.astype(jnp.float32), out_tol, "y")
    _close(_from_layout(tx.grad, nchw), jdx.astype(jnp.float32), out_tol, "dx")
    assert tg.grad.dtype == tb.grad.dtype == torch.float32
    _close(tg.grad, jdg, STAT_TOL, "dgamma")
    _close(tb.grad, jdb, STAT_TOL, "dbeta")


def test_gn_act_refuses_channels_not_divisible_by_the_group():
    with pytest.raises(ValueError, match="not divisible"):
        gn_act(torch.zeros(2, 6, 3, 3), torch.ones(6), torch.zeros(6), 4, 1e-6, False, channel_axis=1)


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.bn = fp32_batch_norm(8, relu=True)

    def forward(self, x, train: bool = False):
        return self.bn(x.permute(0, 3, 1, 2), train)


@pytest.mark.parametrize("steps", [1, 3])
def test_running_stats_follow_flax_not_batchnorm2d(steps):
    """The EMA of the reference's BatchNorm (flax's: ra = 0.9·ra + 0.1·batch,
    biased variance) through ModelDef.apply, which returns the statistics
    and leaves the module's buffers as they were."""
    from fedml_tpu.models.norms import BatchNorm as JaxBatchNorm

    jbn = JaxBatchNorm(use_running_average=False, relu=True)
    model = ModelDef(_Net(), SHAPE[1:], 8, has_batch_stats=True)
    tvars = model.init(torch.Generator().manual_seed(0))
    assert sorted(tvars) == ["batch_stats.bn.mean", "batch_stats.bn.var", "bn.bias", "bn.scale"]
    jvars = {"params": {"scale": jnp.ones(8), "bias": jnp.zeros(8)},
             "batch_stats": {"mean": jnp.zeros(8), "var": jnp.ones(8)}}
    for step in range(steps):
        x, *_ = _inputs(10 + step)
        _, mutated = jbn.apply(jvars, jnp.asarray(x), mutable=["batch_stats"])
        jvars = {"params": jvars["params"], "batch_stats": mutated["batch_stats"]}
        _, tvars = model.apply(tvars, torch.from_numpy(x), train=True)
    _close(tvars["batch_stats.bn.mean"], jvars["batch_stats"]["mean"], STAT_TOL, "mean")
    _close(tvars["batch_stats.bn.var"], jvars["batch_stats"]["var"], STAT_TOL, "var")
    assert torch.equal(model.module.bn.mean, torch.zeros(8))  # no buffer written
    # nn.BatchNorm2d's EMA (unbiased variance, momentum on the batch) differs
    x, *_ = _inputs(10)
    bn2d = torch.nn.BatchNorm2d(8, momentum=0.9)
    bn2d.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    if steps == 1:
        assert not torch.allclose(bn2d.running_var, tvars["batch_stats.bn.var"], rtol=1e-3)


def test_train_mode_norms_run_only_inside_apply():
    with pytest.raises(RuntimeError, match="ModelDef.apply"):
        BatchNorm(4)(torch.ones(2, 4, 3, 3), train=True)
    # GroupNorm has no statistics to return: it runs anywhere
    assert GroupNorm(4, 2)(torch.ones(2, 4, 3, 3), train=True).shape == (2, 4, 3, 3)


def test_ragged_client_pads_the_rows_the_reference_pads():
    """A short client's batch holds the zero rows both packages pad it
    with; bn_act's statistics (in both) include them."""
    from fedml_tpu.data.base import stack_clients as jax_stack
    from fedml_tpu.data.synthetic import synthetic_classification as jax_synth

    from fedml_tpu_torch.data.base import stack_clients
    from fedml_tpu_torch.data.synthetic import synthetic_classification

    kw = dict(num_clients=3, num_classes=10, feat_shape=(5, 5, 8), samples_per_client=11, seed=4)
    jd, td = jax_synth(**kw), synthetic_classification(**kw)
    assert len({len(y) for y in td.client_y}) > 1  # ragged
    jb, tb = jax_stack(jd, [0, 1, 2], 4, seed=7), stack_clients(td, [0, 1, 2], 4, seed=7)
    for part in ("x", "y", "mask"):
        assert np.asarray(getattr(tb, part)).tobytes() == np.asarray(getattr(jb, part)).tobytes()
    short = int(np.argmin([len(y) for y in td.client_y]))
    x = np.asarray(tb.x[short]).reshape((-1,) + kw["feat_shape"])
    assert (x[int(np.asarray(tb.mask[short]).sum()):] == 0).all()
    g, b = np.ones(8, np.float32), np.zeros(8, np.float32)
    _, jmean, jvar = jax_bn_act(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5, False)
    _, mean, var = bn_act(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), 1e-5, False)
    _close(mean, jmean, STAT_TOL, "mean")
    _close(var, jvar, STAT_TOL, "var")


@pytest.mark.parametrize("cpg", [0, 2], ids=["batchnorm", "groupnorm"])
def test_bf16_compute_keeps_float32_norm_parameter_gradients(cpg):
    """Under bf16 compute the BatchNorm and GroupNorm scale and bias reach
    bn_act/gn_act as float32 tensors holding bf16 values
    (train/client.py MixedForward), so their float32 dγ, dβ land on the
    master params unrounded, as the reference's custom VJPs hand them on:
    each layer's gradients equal the reference VJP's on the bf16 input and
    output gradient that layer saw (a whole model's bf16 gradients cannot
    be held tighter: the reference's own differ from its float32 ones by
    ~40% on some leaves of this model)."""
    from fedml_tpu_torch.config import TrainConfig
    from fedml_tpu_torch.models.resnet_gn import BasicBlock, ResNetGN
    from fedml_tpu_torch.train.client import make_mixed_forward
    from fedml_tpu_torch.train.losses import masked_softmax_ce

    shape, classes = (8, 8, 3), 5
    model = ModelDef(ResNetGN(BasicBlock, (1, 1, 1, 1), classes, cpg, small_input=True),
                     shape, classes, has_batch_stats=cpg == 0)
    rng = np.random.default_rng(5)
    tvars = model.init(torch.Generator().manual_seed(1))
    for k, v in tvars.items():  # ones and zeros would hide a rounding
        if k.endswith((".scale", ".bias")):
            v += torch.from_numpy((0.1 * rng.normal(size=v.shape)).astype(np.float32))
    params = {k: v.requires_grad_(True) for k, v in tvars.items() if not k.startswith("batch_stats")}
    stats = {k: v for k, v in tvars.items() if k.startswith("batch_stats")}
    capture, handles = [], []
    for name, mod in model.module.named_modules():
        if isinstance(mod, (BatchNorm, GroupNorm)):
            def hook(m, inputs, out, name=name):
                entry = [name, m, inputs[0].detach(), None]
                capture.append(entry)
                out.register_hook(lambda g: entry.__setitem__(3, g.detach()))
            handles.append(mod.register_forward_hook(hook))
    fwd = make_mixed_forward(model, TrainConfig(compute_dtype="bfloat16"))
    x = torch.from_numpy(rng.normal(size=(4,) + shape).astype(np.float32))
    logits, _ = fwd.train(params, stats, x)
    masked_softmax_ce(logits, torch.from_numpy(rng.integers(0, classes, 4)), torch.ones(4)).backward()
    for h in handles:
        h.remove()
    assert len(capture) == 12  # the stem, 2 a block, 3 shortcuts
    for name, mod, lx, dy in capture:
        assert lx.dtype == dy.dtype == torch.bfloat16, name
        nhwc = lambda t: jnp.asarray(t.permute(0, 2, 3, 1).float().numpy()).astype(jnp.bfloat16)
        g = jnp.asarray(params[f"{name}.scale"].detach().numpy()).astype(jnp.bfloat16)
        b = jnp.asarray(params[f"{name}.bias"].detach().numpy()).astype(jnp.bfloat16)
        if cpg == 0:
            op = lambda x, g, b: jax_bn_act(x, g, b, mod.epsilon, mod.relu)[0]
        else:
            op = lambda x, g, b: jax_gn_act(x, g, b, cpg, mod.epsilon, mod.relu)
        _, vjp = jax.vjp(op, nhwc(lx), g, b)
        _, want_dg, want_db = vjp(nhwc(dy))
        for leaf, want in (("scale", want_dg), ("bias", want_db)):
            got = params[f"{name}.{leaf}"].grad
            assert got.dtype == torch.float32 and want.dtype == jnp.float32, name
            assert not torch.equal(got, got.to(torch.bfloat16).float()), f"{name}.{leaf}: rounded"
            _close(got, want, STAT_TOL, f"{name}.{leaf}")
