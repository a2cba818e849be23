"""Federated rounds of a BatchNorm model, the port against the reference:
a one-block-a-stage CIFAR ResNet (``CifarResNet(layers=(1, 1, 1))``, 8×8
RGB) on 4 ragged synthetic clients (11, 7, 6 and 7 samples, so every
client's last batch of 8 holds padding rows, which BatchNorm's batch
statistics include in both packages), 3 clients a round, batch 8, SGD lr
0.1. Both start from the same variables (the port's init through
``bridge.to_flax_variables``) and take the reference's shuffles:

- 2 FedAvg rounds: the parameters and the running statistics (the
  sample-weighted float32 average of the clients' new statistics);
- 1 FedAdam round: the server optimizer steps the parameters alone, the
  statistics keep the plain average;
- 1 robust-median round: K1's plain version on every parameter leaf, the
  sample-weighted mean on the statistics, as the reference's
  ``_byzantine_reduce`` does;
- a loopback federation of the same model bit-equal to the simulator on
  the actors' minibatches, with the running statistics on the wire;
- a checkpoint of a BatchNorm model written by either package read by the
  other byte for byte.

Tolerance: 1e-5 absolute on every leaf. The two packages' 2 float32
FedAvg rounds differ by 1.3e-6 here; a 1e-7 relative nudge of the init
moves the port's own by 7.2e-7 (this configuration is not chaotic, unlike 16×16
inputs, where a lone sample among padding rows makes BatchNorm amplify a
1e-7 nudge to 5e-2)."""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import fedml_tpu.config as jcfg  # noqa: E402
from torch_parity import flat_params, jax_round_perm_fn, private_reference_programs  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.bridge import from_flax, to_flax_variables  # noqa: E402
from fedml_tpu_torch.models import ModelDef, split_stats  # noqa: E402

ATOL = 1e-5
SHAPE, CLASSES, PER_ROUND = (8, 8, 3), 10, 3
DATA = dict(num_clients=4, num_classes=CLASSES, feat_shape=SHAPE, samples_per_client=12, seed=0)


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("ref_programs")):
        yield


def _config(cfg_mod, rounds, server=None):
    return cfg_mod.RunConfig(
        data=cfg_mod.DataConfig(batch_size=8),
        fed=cfg_mod.FedConfig(client_num_in_total=4, client_num_per_round=PER_ROUND,
                              comm_round=rounds, epochs=1),
        train=cfg_mod.TrainConfig(lr=0.1),
        server=cfg_mod.ServerConfig(**(server or {})),
        seed=0,
    )


def _port_model():
    from fedml_tpu_torch.models.resnet import CifarResNet

    return ModelDef(CifarResNet((1, 1, 1), CLASSES), SHAPE, CLASSES, name="resnet",
                    has_batch_stats=True)


def _init():
    return _port_model().init(torch.Generator().manual_seed(0))


def _ref_model():
    """The reference's model, its init the port's (the reference's own
    would cost a compile of every initializer)."""
    from fedml_tpu.models import ModelDef as JaxModelDef
    from fedml_tpu.models.resnet import CifarResNet

    model = JaxModelDef(CifarResNet((1, 1, 1), CLASSES), SHAPE, CLASSES, has_batch_stats=True)
    init = jax.tree_util.tree_map(jnp.asarray, to_flax_variables(_init()))
    model.init = lambda rng: init
    return model


def _run(kind, rounds):
    """The reference API and the port's after ``rounds`` rounds."""
    from fedml_tpu.algorithms import FedAvgAPI as JaxFedAvg
    from fedml_tpu.algorithms.fedavg_robust import RobustFedAvgAPI as JaxRobust
    from fedml_tpu.algorithms.fedopt import FedOptAPI as JaxFedOpt
    from fedml_tpu.data.synthetic import synthetic_classification as jax_synth
    from fedml_tpu.robustness import RobustConfig as JaxRobustConfig

    from fedml_tpu_torch.algorithms import FedAvgAPI, FedOptAPI, RobustFedAvgAPI
    from fedml_tpu_torch.data.synthetic import synthetic_classification
    from fedml_tpu_torch.robustness import RobustConfig

    server = dict(server_optimizer="adam", server_lr=0.05) if kind == "fedadam" else None
    jconf, tconf = _config(jcfg, rounds, server), _config(tcfg, rounds, server)
    jdata, tdata = jax_synth(**DATA), synthetic_classification(**DATA)
    kw = dict(device="cpu", perm_fn=jax_round_perm_fn(0, PER_ROUND))
    if kind == "fedadam":
        japi, tapi = JaxFedOpt(jconf, jdata, _ref_model()), FedOptAPI(tconf, tdata, _port_model(), **kw)
    elif kind == "median":
        japi = JaxRobust(jconf, jdata, _ref_model(), robust=JaxRobustConfig(defense_type="median"))
        tapi = RobustFedAvgAPI(tconf, tdata, _port_model(),
                               robust=RobustConfig(defense_type="median"), **kw)
    else:
        japi, tapi = JaxFedAvg(jconf, jdata, _ref_model()), FedAvgAPI(tconf, tdata, _port_model(), **kw)
    tapi.global_vars = _init()
    japi.train()
    tapi.train()
    return japi, tapi


@pytest.mark.parametrize("kind,rounds", [("fedavg", 2), ("fedadam", 1), ("median", 1)])
def test_rounds_match_reference_with_running_statistics(kind, rounds):
    japi, tapi = _run(kind, rounds)
    want = flat_params(jax.device_get(japi.global_vars))
    got = flat_params(to_flax_variables(tapi.global_vars))
    assert sorted(got) == sorted(want)
    assert any(k.startswith("batch_stats/") for k in want)
    init = flat_params(to_flax_variables(_init()))
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=ATOL, err_msg=k)
        assert not np.array_equal(got[k], init[k]), f"{k} did not move"
    for trow, jrow in zip(tapi.history, japi.history, strict=True):
        for key in ("Train/Loss", "Train/Acc", "Test/Loss", "Test/Acc"):
            if key in jrow:
                assert abs(trow[key] - jrow[key]) <= ATOL, (key, trow[key], jrow[key])
    if kind == "fedadam":
        # the server optimizer's state covers the parameters alone
        params, _ = split_stats(tapi.global_vars)
        assert sorted(tapi.server_opt_state[0].mu) == sorted(params)


def test_median_round_gives_the_statistics_the_weighted_mean():
    """The robust aggregate runs K1's median on each parameter leaf and the
    sample-weighted mean on each running statistic."""
    from fedml_tpu_torch.robustness.robust_aggregation import coordinate_median

    rng = np.random.default_rng(0)
    stacked = {k: torch.from_numpy(rng.normal(size=(PER_ROUND,) + tuple(v.shape)).astype(np.float32))
               for k, v in _init().items()}
    ns = torch.tensor([4.0, 1.0, 1.0])
    out = coordinate_median(stacked, ns)
    for k, v in stacked.items():
        if k.startswith("batch_stats."):
            want = torch.tensordot(ns / ns.sum(), v, dims=1)
        else:
            want = torch.median(v, dim=0).values  # C = 3: the middle value
        assert torch.allclose(out[k], want, rtol=0, atol=1e-6), k


def test_loopback_carries_running_statistics_and_equals_the_simulator():
    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.algorithms.fedavg_transport import (
        actor_order_perm_fn, run_loopback_federation, wire_model,
    )
    from fedml_tpu_torch.data.synthetic import synthetic_classification

    cfg, data = _config(tcfg, 2), synthetic_classification(**DATA)
    sim = FedAvgAPI(cfg, data, _port_model(), device="cpu", perm_fn=actor_order_perm_fn(cfg, data))
    sim.global_vars = _init()
    sim.train()
    fed = run_loopback_federation(cfg, data, _port_model(), device="cpu", init_vars=_init())
    assert sorted(fed.global_vars) == sorted(sim.global_vars)
    for k in sim.global_vars:
        assert torch.equal(fed.global_vars[k], sim.global_vars[k]), k
    # the wire model is the reference's whole variables tree
    wire = wire_model(fed.global_vars)
    assert sorted(wire) == ["batch_stats", "params"]
    ref_tree = _ref_model().init(None)
    assert jax.tree_util.tree_structure(wire) == jax.tree_util.tree_structure(
        jax.device_get(ref_tree))


def _npz(path):
    with np.load(str(path) + ".npz") as z:
        return {k: z[k] for k in z.files}


def test_batchnorm_checkpoints_round_trip_byte_for_byte(tmp_path):
    """A reference checkpoint of the trained ResNet-56 fixture with FedAdam
    state, read by the port, restored onto the port's templates and written
    again: the same file, key for key and byte for byte (and so the
    reference reads the port's)."""
    import optax
    from fedml_tpu.models.pretrained import load_pretrained as jax_load
    from fedml_tpu.utils import checkpoint as jck

    from fedml_tpu_torch.algorithms.fedopt import make_server_optimizer
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.utils import checkpoint as tck

    template = create_model("resnet56", "cifar10", (32, 32, 3), 10).init(torch.Generator())
    jvars = jax_load("fedml_tpu/models/pretrained_weights/resnet56_cifar10_synth.npz",
                     to_flax_variables(template))
    jopt = optax.adam(0.05, b1=0.9, b2=0.99, eps=jcfg.ServerConfig().tau)
    jstate = jopt.init(jvars["params"])
    grads = jax.tree_util.tree_map(lambda a: np.full_like(a, 1e-3), jvars["params"])
    _, jstate = jopt.update(grads, jstate, jvars["params"])
    jck.save_checkpoint(str(tmp_path / "ref"), jvars, round_idx=3, server_opt_state=jstate)

    tvars, round_idx, _, topt, _, _ = tck.load_checkpoint(str(tmp_path / "ref"))
    assert round_idx == 3 and any(k.startswith("batch_stats.") for k in tvars)
    variables = tck.restore_like(template, tvars)
    params, _ = split_stats(template)
    opt = make_server_optimizer(tcfg.ServerConfig(server_optimizer="adam", server_lr=0.05))
    state = tck.restore_like(opt.init(params), topt)
    tck.save_checkpoint(str(tmp_path / "port"), variables, round_idx=3, server_opt_state=state)
    ref, port = _npz(tmp_path / "ref"), _npz(tmp_path / "port")
    assert sorted(port) == sorted(ref)
    assert any(k.startswith("vars/batch_stats/") for k in port)
    for k in ref:
        assert port[k].dtype == ref[k].dtype and port[k].tobytes() == ref[k].tobytes(), k
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "ref.json").read_text())
    back, *_ = jck.load_checkpoint(str(tmp_path / "port"))
    for k, v in from_flax(back).items():
        assert v.numpy().tobytes() == variables[k].numpy().tobytes(), k
