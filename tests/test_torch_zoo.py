"""The CIFAR model family of the port (fedml_tpu_torch/models/: resnet.py,
resnet_gn.py, mobilenet.py, cnn.py's CNNDropOut) against the reference's
flax models through the bridge: eval logits, train-mode logits, one
step's gradients and the new running statistics, from the same variables
on the same inputs; ResNet-56 at full width from the repo's trained
fixture; the pretrained npz and ``.pth`` paths both ways; dropout's own
contract; and the registry's names and flags.

Each case's variables are the port's init with the norm parameters and
running statistics moved off their ones and zeros (so a swapped mean and
variance or a missed scale shows), handed to the reference through
``bridge.to_flax_variables``. Dropout cannot be compared across the
packages (the reference draws its masks from JAX's stream), so the
train-mode cases build the dropout models at rate 0 on both sides; the
dropout tests hold the port's masks to their own contract.

Tolerances, |got − want| ≤ tol · max(1, max|want|) per leaf, float32 on
both sides with the convolutions and sums taken in another order: eval
logits 1e-5; train-mode logits 1e-4 and gradients and new statistics 1e-3,
because training BatchNorm at the last stages normalises over as few as 6
values (batch 6 at 1×1), which scales the convolutions' rounding
differences by up to 1/σ of those values (measured worst: 4.3e-5 on
logits, 1.2e-4 on gradients, MobileNet and MobileNetV3-LARGE)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from fedml_tpu.models import ModelDef as JaxModelDef  # noqa: E402
from fedml_tpu.models import create_model as jax_create_model  # noqa: E402
from fedml_tpu.train.losses import masked_softmax_ce as jax_ce  # noqa: E402

from fedml_tpu_torch.bridge import from_flax, to_flax_variables  # noqa: E402
from fedml_tpu_torch.models import STATS, ModelDef, create_model, split_stats  # noqa: E402
from fedml_tpu_torch.train.losses import masked_softmax_ce  # noqa: E402

from torch_parity import torch_threads  # noqa: E402

LOGIT_TOL, TRAIN_LOGIT_TOL, GRAD_TOL = 1e-5, 1e-4, 1e-3
FIXTURE = "fedml_tpu/models/pretrained_weights/resnet56_cifar10_synth.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # full-width models on the CPU: under 6 test workers 8 threads a process
    # spin against each other
    with torch_threads(1):
        yield


def _pair(case):
    """(reference ModelDef, port ModelDef, input shape) of a case."""
    from fedml_tpu.models import cnn as jcnn, mobilenet as jmob, resnet as jres, resnet_gn as jgn

    from fedml_tpu_torch.models import cnn, mobilenet, resnet, resnet_gn

    if case == "resnet_depth1":
        shape = (16, 16, 3)
        return (JaxModelDef(jres.CifarResNet((1, 1, 1), 10), shape, 10, has_batch_stats=True),
                ModelDef(resnet.CifarResNet((1, 1, 1), 10), shape, 10, has_batch_stats=True), shape)
    if case.startswith("resnet18_gn"):  # cpg 2 (GroupNorm) and 0 (BatchNorm), one block a stage
        cpg = int(case.rsplit("_cpg", 1)[1])
        # 64 pixels: at 32 the ImageNet stem leaves layer4 1×1, where a
        # group of 2 channels normalises 2 values (ill-conditioned in both)
        shape = (64, 64, 3)
        return (JaxModelDef(jgn.ResNetGN(jgn.BasicBlock, (1, 1, 1, 1), 10, cpg), shape, 10,
                            has_batch_stats=cpg == 0),
                ModelDef(resnet_gn.ResNetGN(resnet_gn.BasicBlock, (1, 1, 1, 1), 10, cpg), shape, 10,
                         has_batch_stats=cpg == 0), shape)
    if case == "resnet50_gn_small_input":  # the bottleneck block, one a stage
        shape = (16, 16, 3)
        return (JaxModelDef(jgn.ResNetGN(jgn.BottleneckGN, (1, 1, 1, 1), 10, 4, True), shape, 10),
                ModelDef(resnet_gn.ResNetGN(resnet_gn.BottleneckGN, (1, 1, 1, 1), 10, 4, True),
                         shape, 10), shape)
    if case == "mobilenet":  # the whole plan at a quarter of the width
        shape = (32, 32, 3)
        return (JaxModelDef(jmob.MobileNet(10, 0.25), shape, 10, has_batch_stats=True),
                ModelDef(mobilenet.MobileNet(10, 0.25), shape, 10, has_batch_stats=True), shape)
    if case.startswith("mobilenet_v3"):  # the whole LARGE table, dropout off
        mode = case.rsplit("_", 1)[1].upper()
        shape = (32, 32, 3)
        return (JaxModelDef(jmob.MobileNetV3(10, mode, 0.0), shape, 10, has_batch_stats=True,
                            has_dropout=True),
                ModelDef(mobilenet.MobileNetV3(10, mode, 0.0), shape, 10, has_batch_stats=True,
                         has_dropout=True), shape)
    if case == "cnn_dropout":  # dropout off
        shape = (28, 28, 1)
        return (JaxModelDef(jcnn.CNNDropOut(62, 0.0, 0.0), shape, 62, has_dropout=True),
                ModelDef(cnn.CNNDropOut(62, shape, 0.0, 0.0), shape, 62, has_dropout=True), shape)
    raise KeyError(case)


def _variables(model: ModelDef, seed: int = 0):
    """The port's init, norm parameters and running statistics moved off
    their initial values."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.init(torch.Generator().manual_seed(seed)).items():
        a = v.numpy().copy()
        if k.endswith(".var"):
            a = rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)
        elif k.endswith((".mean", ".scale", ".bias")):
            a = a + (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        out[k] = torch.from_numpy(a)
    return out


def _close(got, want, tol, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


CASES = ["resnet_depth1", "resnet18_gn_cpg2", "resnet18_gn_cpg0", "resnet50_gn_small_input",
         "mobilenet", "mobilenet_v3_large", "cnn_dropout"]


@pytest.mark.parametrize("case", CASES)
def test_logits_gradients_and_statistics_match_reference(case):
    jmodel, tmodel, shape = _pair(case)
    tvars = _variables(tmodel)
    jvars = jax.tree_util.tree_map(jnp.asarray, to_flax_variables(tvars))
    assert sorted(from_flax(jax.device_get(jvars))) == sorted(tvars)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6,) + shape).astype(np.float32)
    y = rng.integers(0, tmodel.num_classes, 6).astype(np.int32)
    m = np.array([1, 1, 1, 1, 0, 0], np.float32)  # a partly padded batch

    @jax.jit
    def reference(variables):
        eval_logits, _ = jmodel.apply(variables, x, train=False)
        extra = {k: v for k, v in variables.items() if k != "params"}

        def loss(p):
            logits, new = jmodel.apply({"params": p, **extra}, x, train=True,
                                       rng=jax.random.PRNGKey(0))
            return jax_ce(logits, y, m), (logits, new)

        grads, (train_logits, new) = jax.grad(loss, has_aux=True)(variables["params"])
        return eval_logits, train_logits, grads, new.get("batch_stats", {})

    j_eval, j_train, j_grads, j_stats = jax.device_get(reference(jvars))
    t_eval, _ = tmodel.apply(tvars, torch.from_numpy(x), train=False)
    _close(t_eval, j_eval, LOGIT_TOL, "eval logits")

    params, stats = split_stats(tvars)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    t_train, new_vars = tmodel.apply({**p, **stats}, torch.from_numpy(x), train=True,
                                     rng=torch.Generator().manual_seed(0))
    _close(t_train, j_train, TRAIN_LOGIT_TOL, "train logits")
    grads = torch.autograd.grad(masked_softmax_ce(t_train, torch.from_numpy(y).long(),
                                                  torch.from_numpy(m)), list(p.values()))
    want_grads = from_flax(j_grads)
    assert sorted(want_grads) == sorted(p)
    for k, g in zip(p, grads):
        _close(g, want_grads[k], GRAD_TOL, k)
    want_stats = {STATS + k: v for k, v in from_flax(j_stats).items()}
    new_params, new_stats = split_stats(new_vars)
    assert sorted(new_stats) == sorted(want_stats) == sorted(stats)
    for k in want_stats:
        _close(new_stats[k], want_stats[k], GRAD_TOL, k)
        assert not torch.equal(new_stats[k], stats[k]), f"{k} not updated"
    assert all(new_params[k] is p[k] for k in p)  # parameters pass through apply


def _fixture_pair():
    from fedml_tpu.models.pretrained import load_pretrained as jax_load

    from fedml_tpu_torch.models.pretrained import load_pretrained

    jmodel = jax_create_model("resnet56", "cifar10", (32, 32, 3), 10)
    tmodel = create_model("resnet56", "cifar10", (32, 32, 3), 10)
    template = tmodel.init(torch.Generator().manual_seed(0))
    jvars = jax_load(FIXTURE, to_flax_variables(template))
    return jmodel, tmodel, jvars, load_pretrained(FIXTURE, template)


def test_full_width_resnet56_fixture_eval_logits_match_reference():
    jmodel, tmodel, jvars, tvars = _fixture_pair()
    params, stats = split_stats(tvars)
    assert sum(v.numel() for v in params.values()) == 591_322 == tmodel.num_params()
    assert sum(v.numel() for v in stats.values()) == 8_992
    assert (len(params), len(stats)) == (176, 116)
    for k, v in from_flax(jvars).items():  # the same file, read by both packages
        assert v.numpy().tobytes() == tvars[k].numpy().tobytes(), k
    x = np.random.default_rng(2).normal(size=(8, 32, 32, 3)).astype(np.float32)
    want, _ = jax.jit(lambda v: jmodel.apply(v, x, train=False))(jax.tree_util.tree_map(jnp.asarray, jvars))
    got, _ = tmodel.apply(tvars, torch.from_numpy(x), train=False)
    _close(got, np.asarray(want), LOGIT_TOL, "fixture logits")
    # the trained model classifies its own synthetic geometry: logits are
    # far from uniform
    assert float(np.abs(np.asarray(want)).max()) > 5.0


def test_pretrained_files_round_trip_between_the_packages(tmp_path):
    """npz (save_pretrained) and torch state dicts (.pth) written by either
    package load in the other byte for byte; ``pretrained=`` on the
    registry pours a file over the init."""
    from fedml_tpu.models import pretrained as JP

    from fedml_tpu_torch.models import pretrained as P

    _, tmodel, jvars, tvars = _fixture_pair()
    template = tmodel.init(torch.Generator().manual_seed(3))
    # .pth: the reference's export, saved as a torch checkpoint, into the port
    ref_sd = JP.export_torch_state_dict(jvars)
    port_sd = P.export_torch_state_dict(tvars)
    assert sorted(ref_sd) == sorted(port_sd)
    assert "layer1.0.downsample.1.running_var" in port_sd
    for k in ref_sd:
        assert np.asarray(ref_sd[k]).tobytes() == port_sd[k].tobytes(), k
    torch.save({"state_dict": {"module." + k: torch.from_numpy(np.asarray(v)) for k, v in ref_sd.items()}},
               tmp_path / "ref.pth")
    loaded = P.load_torch_checkpoint(str(tmp_path / "ref.pth"), template)
    via_registry = create_model("resnet56", "cifar10", (32, 32, 3), 10,
                                pretrained=str(tmp_path / "ref.pth")).init(torch.Generator())
    for k in tvars:
        assert loaded[k].numpy().tobytes() == tvars[k].numpy().tobytes(), k
        assert torch.equal(via_registry[k], tvars[k]), k
    with pytest.raises(KeyError, match="missing"):
        P.import_torch_state_dict({k: v for k, v in port_sd.items() if "fc" not in k}, template)
    # npz: the port's save_pretrained into the reference, and back
    P.save_pretrained(str(tmp_path / "port.npz"), tvars)
    back = JP.load_pretrained(str(tmp_path / "port.npz"), to_flax_variables(template))
    for k, v in from_flax(back).items():
        assert v.numpy().tobytes() == tvars[k].numpy().tobytes(), k
    with np.load(tmp_path / "port.npz") as a, np.load(FIXTURE) as b:
        assert sorted(a.files) == sorted(b.files)


# ------------------------------------------------------------------ dropout


def test_dropout_keeps_one_minus_rate_scaled_and_follows_its_generator():
    from fedml_tpu_torch.models.layers import Dropout

    class Net(torch.nn.Module):
        def __init__(self, rate):
            super().__init__()
            self.drop = Dropout(rate)

        def forward(self, x, train: bool = False):
            return self.drop(x, train)

    x = torch.ones(200_000)
    model = ModelDef(Net(0.3), (200_000,), 1, has_dropout=True)
    out, _ = model.apply({}, x, train=True, rng=torch.Generator().manual_seed(7))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005  # ~5σ of the keep rate
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.7))
    again, _ = model.apply({}, x, train=True, rng=torch.Generator().manual_seed(7))
    other, _ = model.apply({}, x, train=True, rng=torch.Generator().manual_seed(8))
    assert torch.equal(out, again) and not torch.equal(out, other)
    # without a generator: the reference's PRNGKey(0) fallback, a fixed mask
    fixed, _ = model.apply({}, x, train=True)
    assert torch.equal(fixed, model.apply({}, x, train=True)[0])
    assert torch.equal(model.apply({}, x, train=False)[0], x)  # eval: identity
    zero = ModelDef(Net(0.0), (4,), 1, has_dropout=True)
    assert torch.equal(zero.apply({}, x, train=True)[0], x)
    assert not ModelDef(Net(1.0), (4,), 1, has_dropout=True).apply({}, x, train=True)[0].any()
    with pytest.raises(RuntimeError, match="ModelDef.apply"):
        Net(0.5)(x, train=True)


def test_local_steps_draw_dropout_from_their_own_generators():
    """Two local trains from one init and one step seed are equal; another
    seed gives other masks, so other weights."""
    from fedml_tpu_torch.config import TrainConfig
    from fedml_tpu_torch.train.client import make_local_train

    model = create_model("cnn_dropout", "femnist", (28, 28, 1), 62)
    init = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 4, 28, 28, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 62, (2, 4)))
    mask = torch.ones(2, 4)
    train = make_local_train(model, TrainConfig(lr=0.1), 1)

    def perm(epoch, m):
        return torch.arange(m.shape[0])

    a, _ = train(init, x, y, mask, perm, step_seed=1)
    b, _ = train(init, x, y, mask, perm, step_seed=1)
    c, _ = train(init, x, y, mask, perm, step_seed=2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)


# ----------------------------------------------------------------- registry


ZOO = [("resnet56", (32, 32, 3), {}), ("resnet18_gn", (32, 32, 3), {}),
       ("resnet18_gn", (32, 32, 3), {"channels_per_group": 0}), ("mobilenet", (32, 32, 3), {}),
       ("mobilenet_v3", (32, 32, 3), {}), ("cnn_dropout", (28, 28, 1), {}),
       ("cnn", (28, 28, 1), {}), ("lr", (16,), {})]


def _flags(m):
    return m.name, m.has_batch_stats, m.has_dropout


@pytest.mark.parametrize("name,shape,kw", ZOO, ids=lambda v: str(v))
def test_registry_builds_the_reference_models_and_flags(name, shape, kw):
    jm = jax_create_model(name, "cifar10", shape, 10, **dict(kw))
    tm = create_model(name, "cifar10", shape, 10, **dict(kw))
    assert _flags(tm) == _flags(jm)
    shapes = {k: tuple(v.shape) for k, v in tm.init(torch.Generator().manual_seed(0)).items()}
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = from_flax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), want))
    assert shapes == {k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("name,kw", [
    ("resnet110", {}), ("resnet34_gn", {"small_input": True}), ("resnet50_gn", {}),
    ("resnet101_gn", {"channels_per_group": 0}), ("resnet152_gn", {}),
    ("mobilenet_v3", {"model_mode": "SMALL"}),
], ids=str)
def test_registry_flags_of_the_deeper_models(name, kw):
    assert _flags(create_model(name, "cifar10", (32, 32, 3), 10, **dict(kw))) == _flags(
        jax_create_model(name, "cifar10", (32, 32, 3), 10, **dict(kw)))


@pytest.mark.parametrize("name", ["vgg11", "vgg16_bn", "efficientnet"])
def test_unported_models_name_their_roadmap_item(name):
    """Ported since (tests/test_torch_vgg_efficientnet.py): what waits is
    their batched client schedule, which an explicit "vmap" refuses."""
    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.config import DataConfig, FedConfig, RunConfig
    from fedml_tpu_torch.data.synthetic import synthetic_classification

    with torch.device("meta"):
        model = create_model(name, "cifar10", (32, 32, 3), 10)
    data = synthetic_classification(num_clients=2, num_classes=10, feat_shape=(32, 32, 3),
                                    samples_per_client=2, seed=0)
    cfg = RunConfig(data=DataConfig(batch_size=2),
                    fed=FedConfig(client_num_in_total=2, client_num_per_round=2,
                                  client_parallelism="vmap"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        FedAvgAPI(cfg, data, model, device="cpu")


def test_unknown_model_is_a_key_error():
    with pytest.raises(KeyError, match="unknown model"):
        create_model("no_such_net", "cifar10", (32, 32, 3), 10)
