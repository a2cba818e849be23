"""VGG and EfficientNet of the port (fedml_tpu_torch/models/vgg.py,
efficientnet.py) against the reference's flax models through the bridge:
eval logits, train-mode logits, one step's gradients and the new running
statistics from the same variables on the same inputs (as
tests/test_torch_zoo.py holds the CIFAR family), for narrow VGG tables
(the 4096-wide head kept) at 7×7 before the head, at 14×14 (the
average-pool branch) and, with five pools at 32×32, at 1×1 (the
global-mean branch of CIFAR's full tables), and EfficientNet at a
quarter of b0's width and half its depth at 32×32 (every block kind);
the reference's pool on every branch; the full-width variable
counts of the 8 VGG names and b0–b7 against the reference's
``jax.eval_shape`` (tests/reference_model_facts.json); the width and
depth rounding of b0–b7 and stochastic depth's rates and masks; and the
registry's flags. The full-width models are held by their variable
counts, the code they share by the narrow models' numbers: a full-width
model's float64 reference run costs 10–20 s on the CPU.

Dropout cannot be compared across the packages (the reference draws from
JAX's stream), so the train-mode cases run with every dropout rate at 0
on both sides: VGG's ``dropout`` field, EfficientNet's
``drop_connect_rate`` and its head's rate (patched into both packages'
coefficient tables for the test).

The reference runs in float64 here (``jax.enable_x64``; its
BatchNorm still takes float32 statistics): XLA's float32 CPU convolution
gradients of VGG-11 at 32×32 are off by up to 0.7% (conv3's kernel: 7.4e-3
against a largest element of 0.206, the reference's float32 against its
own float64), while the port's float32 agrees with its float64 to 3e-6.
Tolerances, |got − want| ≤ tol · max(1, max|want|) per leaf: eval logits
1e-5, train logits 1e-4, gradients and statistics 1e-3, as
tests/test_torch_zoo.py states them (training BatchNorm over few values
scales the convolutions' rounding differences)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from fedml_tpu.models import ModelDef as JaxModelDef  # noqa: E402
from fedml_tpu.models import create_model as jax_create_model  # noqa: E402
from fedml_tpu.models import efficientnet as jeff  # noqa: E402
from fedml_tpu.models import vgg as jvgg  # noqa: E402
from fedml_tpu.train.losses import masked_softmax_ce as jax_ce  # noqa: E402

from fedml_tpu_torch.bridge import from_flax, to_flax_variables  # noqa: E402
from fedml_tpu_torch.models import STATS, ModelDef, _apply_scope, create_model, split_stats  # noqa: E402
from fedml_tpu_torch.models import efficientnet as teff  # noqa: E402
from fedml_tpu_torch.models import vgg as tvgg  # noqa: E402
from fedml_tpu_torch.train.losses import masked_softmax_ce  # noqa: E402

from torch_parity import (  # noqa: E402
    REGISTRY_CASES, case_id, port_model, private_reference_programs, reference_model_facts,
    reference_record, torch_threads, variables_digest,
)

LOGIT_TOL, TRAIN_LOGIT_TOL, GRAD_TOL = 1e-5, 1e-4, 1e-3
NARROW = (8, "M", 16, 16, "M")
# case: (table, input side, batch norm); the side over 2^pools is the
# side before the head's pool: 7 (identity), 14 (average pool), 1 (the
# global mean broadcast to 7×7, CIFAR's branch on the full tables)
VGG_CASES = {
    "vgg_narrow_bn": (NARROW, 28, True),
    "vgg_narrow": (NARROW[:3], 28, False),
    "vgg_narrow_global_bn": ((8, "M", 16, "M", 16, "M", 16, "M", 16, "M"), 32, True),
}
# EfficientNet at a quarter of b0's width and half its depth: 10 blocks
# with both expansion ratios, both kernel sizes, every stride, squeeze-
# excitation and 4 residual blocks (b0's 16 blocks cost ~14 s cold)
NARROW_EFFICIENTNET = (0.25, 0.5, 0.0)


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    """The reference compiles into a program cache and an executable store
    of its own (torch_parity.private_reference_programs)."""
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _pair(case, monkeypatch):
    """(reference ModelDef, port ModelDef, input shape) of a case, every
    dropout rate 0."""
    if case in VGG_CASES:
        cfg, side, bn = VGG_CASES[case]
        shape = (side, side, 3)
        return (JaxModelDef(jvgg.VGG(cfg=cfg, num_classes=10, batch_norm=bn, dropout=0.0), shape,
                            10, has_batch_stats=bn, has_dropout=True),
                ModelDef(tvgg.VGG(cfg, 10, batch_norm=bn, dropout=0.0), shape, 10,
                         has_batch_stats=bn, has_dropout=True), shape)
    assert case == "efficientnet_narrow", case
    monkeypatch.setitem(jeff._COEFFS, "narrow", NARROW_EFFICIENTNET)
    monkeypatch.setitem(teff.COEFFS, "narrow", NARROW_EFFICIENTNET)
    shape = (32, 32, 3)
    return (JaxModelDef(jeff.EfficientNet(10, "narrow", 0.0), shape, 10, has_batch_stats=True,
                        has_dropout=True),
            ModelDef(teff.EfficientNet(10, "narrow", 0.0), shape, 10, has_batch_stats=True,
                     has_dropout=True), shape)


def _variables(model: ModelDef, seed: int = 0):
    """Seeded variables: weights normal with std 1/√fan_in (drawn in
    numpy: a trunc-normal init of VGG-11's 129M weights costs seconds),
    biases small, norm parameters and running statistics off their
    initial values."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, p in list(model.module.named_parameters()) + [
            (STATS + n, b) for n, b in model.module.named_buffers()]:
        shape = tuple(p.shape)
        if k.endswith(".var"):
            a = rng.uniform(0.5, 1.5, size=shape)
        elif k.endswith((".mean", ".bias")):
            a = 0.1 * rng.standard_normal(size=shape)
        elif k.endswith(".scale"):
            a = 1.0 + 0.1 * rng.standard_normal(size=shape)
        else:
            a = rng.standard_normal(size=shape, dtype=np.float32) / np.sqrt(np.prod(shape[1:]))
        out[k] = torch.from_numpy(np.asarray(a, np.float32))
    return out


def _close(got, want, tol, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


CASES = [*VGG_CASES, "efficientnet_narrow"]


def test_vgg_cases_reach_the_three_pool_branches():
    sides = {case: side // 2 ** cfg.count("M") for case, (cfg, side, _) in VGG_CASES.items()}
    assert sides == {"vgg_narrow_bn": 7, "vgg_narrow": 14, "vgg_narrow_global_bn": 1}


def test_narrow_efficientnet_covers_every_block_kind(monkeypatch):
    _, tmodel, _ = _pair("efficientnet_narrow", monkeypatch)
    blocks = [getattr(tmodel.module, n) for n in tmodel.module.block_names]
    assert len(blocks) == 10
    assert {(b.has_expand, b.depthwise.kernel_size[0]) for b in blocks} == \
        {(False, 3), (True, 3), (True, 5)}
    assert {b.depthwise.stride[0] for b in blocks} == {1, 2}
    assert sum(b.residual for b in blocks) == 4


@pytest.mark.parametrize("case", CASES)
def test_logits_gradients_and_statistics_match_reference(case, monkeypatch):
    jmodel, tmodel, shape = _pair(case, monkeypatch)
    tvars = _variables(tmodel)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6,) + shape).astype(np.float32)
    y = rng.integers(0, tmodel.num_classes, 6).astype(np.int32)
    m = np.array([1, 1, 1, 1, 0, 0], np.float32)  # a partly padded batch

    def run():
        with jax.enable_x64(True):
            jvars = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                           to_flax_variables(tvars))
            x64, m64 = x.astype(np.float64), m.astype(np.float64)

            @jax.jit
            def reference(variables):
                eval_logits, _ = jmodel.apply(variables, x64, train=False)
                extra = {k: v for k, v in variables.items() if k != "params"}

                def loss(p):
                    logits, new = jmodel.apply({"params": p, **extra}, x64, train=True,
                                               rng=jax.random.PRNGKey(0))
                    return jax_ce(logits, y, m64), (logits, new)

                grads, (train_logits, new) = jax.grad(loss, has_aux=True)(variables["params"])
                return eval_logits, train_logits, grads, new.get("batch_stats", {})

            out = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                         jax.device_get(reference(jvars)))
        return dict(eval=out[0], train=out[1],
                    grads={k: v.numpy() for k, v in from_flax(out[2]).items()},
                    stats={k: v.numpy() for k, v in from_flax(out[3]).items()})

    ref = reference_record("vgg_efficientnet_pair_x64", dict(case=case, vars=variables_digest(tvars)),
                           run)
    with torch_threads(2):
        t_eval, _ = tmodel.apply(tvars, torch.from_numpy(x), train=False)
        _close(t_eval, ref.eval, LOGIT_TOL, "eval logits")
        params, stats = split_stats(tvars)
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        t_train, new_vars = tmodel.apply({**p, **stats}, torch.from_numpy(x), train=True,
                                         rng=torch.Generator().manual_seed(0))
        _close(t_train, ref.train, TRAIN_LOGIT_TOL, "train logits")
        grads = torch.autograd.grad(masked_softmax_ce(t_train, torch.from_numpy(y).long(),
                                                      torch.from_numpy(m)), list(p.values()))
    assert sorted(ref.grads) == sorted(p)
    for k, g in zip(p, grads):
        _close(g, ref.grads[k], GRAD_TOL, k)
    new_params, new_stats = split_stats(new_vars)
    want_stats = {STATS + k: v for k, v in ref.stats.items()}
    assert sorted(new_stats) == sorted(want_stats) == sorted(stats)
    for k in want_stats:
        _close(new_stats[k], want_stats[k], GRAD_TOL, k)


@pytest.mark.parametrize("hw", [(7, 7), (14, 14), (28, 21), (5, 5), (1, 1), (10, 7)])
def test_adaptive_pool_matches_reference_on_every_branch(hw):
    x = np.random.default_rng(2).normal(size=(2,) + hw + (3,)).astype(np.float32)
    want = np.asarray(jvgg._adaptive_avg_pool(jnp.asarray(x), 7))
    got = tvgg.adaptive_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), 7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-7)


COUNT_CASES = [c for c in REGISTRY_CASES if c[0].startswith(("vgg", "efficientnet_"))]


@pytest.fixture(scope="module")
def facts():
    return reference_model_facts(COUNT_CASES)


@pytest.mark.parametrize("case", COUNT_CASES, ids=case_id)
def test_full_width_variable_counts_match_reference(case, facts):
    model = port_model(case)  # on the meta device: nothing allocated
    params, stats = split_stats({n: p for n, p in model.module.named_parameters()}
                                | {STATS + n: b for n, b in model.module.named_buffers()})
    count = sum(v.numel() for v in params.values()) + sum(v.numel() for v in stats.values())
    assert count == facts[case_id(case)]["count"]
    assert bool(stats) == case[0].endswith("_bn") or case[0].startswith("efficientnet")


def test_efficientnet_scaling_and_stochastic_depth_rates_match_reference():
    for w in (1.0, 1.1, 1.2, 1.4, 1.6, 1.8, 2.0):
        for f in (16, 24, 32, 40, 80, 112, 192, 320, 1280):
            assert teff.round_filters(f, w) == jeff._round_filters(f, w)
    for d in (1.0, 1.1, 1.2, 1.4, 1.8, 2.2, 2.6, 3.1):
        assert [teff.round_repeats(r, d) for r in range(1, 5)] == \
            [jeff._round_repeats(r, d) for r in range(1, 5)]
    assert teff.B0_STAGES == jeff._B0_STAGES and teff.COEFFS == jeff._COEFFS
    with torch.device("meta"):
        net = teff.EfficientNet(10, "b3", drop_connect_rate=0.3)
    _, depth, _ = jeff._COEFFS["b3"]
    total = sum(jeff._round_repeats(r, depth) for _, _, r, _, _ in jeff._B0_STAGES)
    assert [getattr(net, n).drop_rate for n in net.block_names] == \
        [0.3 * bi / total for bi in range(total)]


def test_drop_connect_masks_come_from_the_dropout_stream():
    """A residual block at drop rate 0.4 keeps each sample's branch with one
    uniform draw from the apply's generator, u < 0.6, and scales it by
    1/0.6; the skip path is untouched."""
    torch.manual_seed(0)
    block = teff.MBConv(8, 8, 6, 3, 1, drop_rate=0.4)
    x = torch.randn(8, 8, 6, 6)
    with _apply_scope(torch.Generator().manual_seed(0)):
        got = block(x, train=True)
    block.residual = False  # the branch alone
    with _apply_scope(None):
        branch = block(x, train=True)
    u = torch.rand((8, 1, 1, 1), generator=torch.Generator().manual_seed(0))
    assert torch.equal(got, branch * (u < 0.6).to(branch.dtype) / 0.6 + x)
    assert 0 < int((u < 0.6).sum()) < 8  # this draw keeps some samples and drops some


@pytest.mark.parametrize("name", ["vgg11", "vgg19_bn", "efficientnet"])
def test_registry_flags_match_reference(name):
    shape = (32, 32, 3)
    with torch.device("meta"):
        got = create_model(name, "cifar10", shape, 10)
    want = jax_create_model(name, "cifar10", shape, 10)
    assert (got.has_batch_stats, got.has_dropout, got.name) == \
        (want.has_batch_stats, want.has_dropout, want.name)
