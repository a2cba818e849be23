"""FedNAS in the port against the reference on the CPU: flax's SAME layers
that DARTS needs (a dilated depthwise conv, max and avg pools, at stride 1
and 2 on odd and even sizes), the DARTS network at ch 4, cells 2, steps 1
(a normal and a reduction cell: logits, gradients of α and the weights,
new statistics), ``derive_genotype`` with ties, and one first-order and
one second-order FedNASAPI round, both from the port's seeded init (handed
to the reference's network, whose own init costs seconds of compiles).

Tolerances: the layers atol 1e-5 (float32 sums in another order); the
network's logits atol 2e-5 and gradients rtol 1e-4 / atol 1e-5 of the
largest (the convolutions' summation order, amplified by BatchNorm's 1/σ
on 2×2 maps after the reduction); after a round, α atol 1e-6 and the
weights and statistics atol 1e-5 (measured: 4e-9 and 1.2e-7; without
BatchNorm's second-derivative repair the second-order round's α misses by
2.8e-5); the genotypes equal."""

import numpy as np
import pytest
import torch

from fedml_tpu_torch.algorithms.fednas import FedNASAPI
from fedml_tpu_torch.bridge import to_flax_variables
from fedml_tpu_torch.data.synthetic import synthetic_classification
from fedml_tpu_torch.models import ModelDef, split_stats
from fedml_tpu_torch.models.darts import DEFAULT_OPS, DARTSNetwork, derive_genotype, num_edges
from fedml_tpu_torch.models.layers import Conv2d, avg_pool_same, max_pool_same, to_nchw

from torch_parity import (
    flat_params, private_reference_programs, reference_record, torch_threads, variables_digest,
)

NET = dict(ch=4, cells=2, steps=1)
H, CLASSES = 8, 3
FED = dict(clients=3, samples=32, per_round=2, batch=8)


@pytest.fixture(autouse=True, scope="module")
def _isolated(tmp_path_factory):
    """The port on one thread; the reference with a program cache and an
    executable store of its own (torch_parity.private_reference_programs)."""
    with torch_threads(1), private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


# ------------------------------------------------------------- the layers


@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("stride", [1, 2])
def test_same_layers_match_flax(size, stride):
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(size * 10 + stride)
    x = rng.normal(size=(2, size, size, 5)).astype(np.float32)
    xt = to_nchw(torch.from_numpy(x))
    to_nhwc = lambda t: t.permute(0, 2, 3, 1).detach().numpy()
    for name, fl in (("max", nn.max_pool), ("avg", nn.avg_pool)):
        want = fl(jnp.asarray(x), (3, 3), strides=(stride, stride), padding="SAME")
        got = (max_pool_same if name == "max" else avg_pool_same)(xt, 3, stride)
        np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-5, err_msg=name)
    conv = nn.Conv(5, (3, 3), strides=(stride, stride), padding="SAME", kernel_dilation=(2, 2),
                   feature_group_count=5, use_bias=False)
    kernel = rng.normal(size=(3, 3, 1, 5)).astype(np.float32)
    want = conv.apply({"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(x))
    tconv = Conv2d(5, 5, 3, stride=stride, groups=5, bias=False, dilation=2)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
    np.testing.assert_allclose(to_nhwc(tconv(xt)), np.asarray(want), atol=1e-5, err_msg="conv")
    del jax


# ------------------------------------------------------------ the genotype


def test_derive_genotype_matches_the_reference_with_ties():
    from fedml_tpu.models.darts import derive_genotype as jax_derive

    E, O = num_edges(3), len(DEFAULT_OPS)
    rng = np.random.default_rng(0)
    cases = [
        np.zeros((E, O), np.float32),  # every edge and op tied
        rng.normal(size=(E, O)).astype(np.float32),
        np.round(rng.normal(size=(E, O)), 1).astype(np.float32),  # ties between ops
    ]
    tied_edges = rng.normal(size=(E, O)).astype(np.float32)
    tied_edges[1] = tied_edges[0]  # two inputs of node 0 with the same best op and weight
    tied_edges[3:5] = tied_edges[2]
    cases.append(tied_edges)
    strong_none = np.zeros((E, O), np.float32)
    strong_none[:, DEFAULT_OPS.index("none")] = 9.0
    cases.append(strong_none)
    for alpha in cases:
        want = jax_derive(alpha, steps=3)
        assert derive_genotype(alpha, steps=3) == want
        assert derive_genotype(torch.from_numpy(alpha), steps=3) == want
    assert all(op != "none" for op, _ in derive_genotype(strong_none, steps=3))


# ----------------------------------------------- the network and the rounds


def _data():
    return synthetic_classification(num_clients=FED["clients"], num_classes=CLASSES,
                                    feat_shape=(H, H, 3), samples_per_client=FED["samples"],
                                    partition_method="homo", ragged=False, seed=1)


def _init():
    model = ModelDef(DARTSNetwork(CLASSES, **NET), (H, H, 3), CLASSES, has_batch_stats=True)
    return model, model.init(torch.Generator().manual_seed(0))


def _batch():
    """One batch of the rounds' size (the reference's jitted steps take it
    without a compile of their own)."""
    rng = np.random.default_rng(5)
    return (rng.normal(size=(FED["batch"], H, H, 3)).astype(np.float32),
            rng.integers(0, CLASSES, FED["batch"]).astype(np.int32))


def _api_kw():
    return dict(num_classes=CLASSES, input_shape=(H, H, 3), batch_size=FED["batch"], **NET)


@pytest.fixture(scope="module")
def ref():
    """The reference network's train-mode logits, gradients and statistics
    on one batch, and one round of its FedNASAPI with each architect."""
    _, init = _init()
    flax_init = to_flax_variables(init)

    def run():
        import contextlib

        import jax
        import jax.numpy as jnp

        from fedml_tpu.algorithms.fednas import FedNASAPI as JaxNAS
        from fedml_tpu.algorithms.fednas import _split_arch
        from fedml_tpu.data.synthetic import synthetic_classification as jax_synth
        from fedml_tpu.models.darts import DARTSNetwork as JaxDARTS

        x, y = (jnp.asarray(a) for a in _batch())
        data = jax_synth(num_clients=FED["clients"], num_classes=CLASSES, feat_shape=(H, H, 3),
                         samples_per_client=FED["samples"], partition_method="homo",
                         ragged=False, seed=1)
        out = {"rounds": {}}
        with contextlib.ExitStack() as stack:
            stack.callback(setattr, JaxDARTS, "init", JaxDARTS.init)
            JaxDARTS.init = lambda self, *a, **kw: flax_init
            first = JaxNAS(data, arch_grad="first", **_api_kw())
            # the gradients of one batch, read from the optimizer states of
            # the API's own jitted steps from fresh states: SGD's first
            # momentum trace is g, Adam's first mu is (1 - 0.5)·g
            arch, weights = _split_arch(flax_init["params"])
            stepped, w_os, _ = first._train_step(flax_init, first.w_opt.init(weights), x, y)
            _, a_os, _ = first._arch_step(flax_init, first.arch_opt.init(arch), x, y)
            out["grads"] = jax.device_get({**w_os[0].trace,
                                           **jax.tree_util.tree_map(lambda m: 2 * m, a_os[0].mu)})
            out["stats"] = jax.device_get(stepped["batch_stats"])
            out["logits"] = jax.jit(lambda v, x: first.net.apply(
                v, x, train=True, mutable=["batch_stats"])[0])(flax_init, x)
            second = JaxNAS(data, arch_grad="second", **_api_kw())
            second._train_step = first._train_step  # the same program: one compile
            for arch_grad, api in (("first", first), ("second", second)):
                geno = api.train_round(0, client_num_per_round=FED["per_round"])
                out["rounds"][arch_grad] = dict(variables=jax.device_get(api.variables),
                                                genotype=[list(g) for g in geno])
        return out

    rec = reference_record("fednas", dict(NET, **FED, init=variables_digest(init)), run)
    rec.init = init
    return rec


def _assert_tree_close(got, want, atol, rtol=0.0, what="", atol_of=None):
    want, got = flat_params(want), flat_params(got)
    assert got.keys() == want.keys(), what
    for k in want:
        tol = atol_of(k) if atol_of else atol
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=tol, err_msg=f"{what} {k}")


def test_darts_network_matches_the_reference(ref):
    model, init = _init()
    assert init.keys() == ref.init.keys()
    assert init["alpha_normal"].shape == (num_edges(NET["steps"]), len(DEFAULT_OPS))
    x, y = (torch.from_numpy(a) for a in _batch())
    params, stats = split_stats(ref.init)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    logits, new_vars = model.apply({**p, **stats}, x, train=True)
    loss = torch.nn.functional.cross_entropy(logits, y.long())
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    np.testing.assert_allclose(logits.detach().numpy(), ref.logits, atol=2e-5)
    want_g = flat_params(ref.grads)
    scale = max(float(np.abs(g).max()) for g in want_g.values())
    _assert_tree_close(to_flax_variables(grads)["params"], ref.grads, 1e-5 * scale, 1e-4, "grads")
    _assert_tree_close(to_flax_variables({k: new_vars[k] for k in stats})["batch_stats"],
                       ref.stats, 2e-5, what="stats")


@pytest.mark.parametrize("arch_grad", ["first", "second"])
def test_fednas_round_matches_the_reference(ref, arch_grad):
    api = FedNASAPI(_data(), arch_grad=arch_grad, device="cpu",
                    init_vars={k: v.clone() for k, v in ref.init.items()}, **_api_kw())
    geno = api.train_round(0, client_num_per_round=FED["per_round"])
    want = ref.rounds[arch_grad]
    assert not torch.equal(api.variables["alpha_normal"], ref.init["alpha_normal"])
    _assert_tree_close(to_flax_variables(api.variables), want["variables"], 1e-5,
                       what=arch_grad, atol_of=lambda k: 1e-6 if "alpha_" in k else 1e-5)
    assert [list(g) for g in geno] == want["genotype"]
    assert api.genotype_history == [(0, geno)]
    assert 0.0 <= api.evaluate(_data().test_x, _data().test_y) <= 1.0
