"""The port's FedOpt against the reference on the CPU: each of the five
server optimizers against optax over 5 steps of random pseudo-gradients,
and FedOptAPI (FedAdam, server lr 0.05) against the reference's FedOptAPI
on the transport tests' logistic-regression fixture and on the small CNN
slice.

The reference's programs run with a private program cache and executable
store (torch_parity.private_reference_programs): the session store keys an
executable without its input sharding, and the FedOpt server step is keyed
by the server config alone, so a mesh-sharded step another test stored for
these shapes would otherwise be handed to these single-device calls."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import fedml_tpu.config as jcfg  # noqa: E402
from fedml_tpu.algorithms.fedopt import make_server_optimizer as jax_server_optimizer  # noqa: E402
from fedml_tpu.data.synthetic import synthetic_classification as jax_synthetic  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.algorithms import FedOptAPI  # noqa: E402
from fedml_tpu_torch.algorithms.fedopt import make_server_optimizer, make_server_step  # noqa: E402
from fedml_tpu_torch.bridge import from_flax, to_flax  # noqa: E402
from fedml_tpu_torch.data.synthetic import synthetic_classification  # noqa: E402

from torch_parity import (  # noqa: E402
    assert_slice_close, jax_lr_model, lr_config, lr_data, private_reference_programs,
    run_slice, torch_lr_model,
)

OPTIMIZERS = ("sgd", "sgdm", "adam", "yogi", "adagrad")
FEDADAM = dict(server_optimizer="adam", server_lr=0.05)


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_server_optimizer_matches_optax_over_five_steps(name):
    """Same params, same pseudo-gradients, each side stepping its own
    state. Tolerance: rtol 1e-6 (a few float32 ulps: torch's CPU sqrt is
    within one ulp, XLA's is exact) plus an absolute 1e-6·max|w| for
    entries the steps carried near zero, whose error is the step's."""
    rng = np.random.default_rng(OPTIMIZERS.index(name))
    shapes = {"a": (30, 40), "b": (70,)}
    sc = dict(server_optimizer=name, server_lr=0.05)
    jopt = jax_server_optimizer(jcfg.ServerConfig(**sc))
    topt = make_server_optimizer(tcfg.ServerConfig(**sc))
    w = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jw = {k: jax.numpy.asarray(v) for k, v in w.items()}
    tw = {k: torch.tensor(v) for k, v in w.items()}
    jstate, tstate = jopt.init(jw), topt.init(tw)
    scale = max(np.abs(v).max() for v in w.values())
    for _ in range(5):
        g = {k: 0.1 * rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        ju, jstate = jopt.update({k: jax.numpy.asarray(v) for k, v in g.items()}, jstate, jw)
        jw = optax.apply_updates(jw, ju)
        tu, tstate = topt.update({k: torch.tensor(v) for k, v in g.items()}, tstate, tw)
        tw = {k: tw[k] + tu[k] for k in tw}
        for k in shapes:
            np.testing.assert_allclose(tw[k].numpy(), np.asarray(jw[k]), rtol=1e-6,
                                       atol=1e-6 * scale, err_msg=f"{name}/{k}")


def test_server_step_moves_params_by_the_pseudo_gradient():
    """sgd at server lr 1 is plain FedAvg: old − 1·(old − avg) = avg."""
    opt = make_server_optimizer(tcfg.ServerConfig(server_optimizer="sgd", server_lr=1.0))
    old = {"w": torch.tensor([1.0, -2.0, 3.0])}
    avg = {"w": torch.tensor([0.5, 0.25, 3.0])}
    new, _ = make_server_step(opt)(old, avg, opt.init(old))
    torch.testing.assert_close(new["w"], avg["w"], rtol=0, atol=1e-7)


def test_fedopt_api_matches_reference_on_lr_fixture():
    """3 rounds of FedAdam from the reference's init, at full batch: atol
    1e-5, the reference's own transport-vs-simulator tolerance."""
    from fedml_tpu.algorithms.fedopt import FedOptAPI as JaxFedOpt

    train = dict(client_optimizer="sgd", lr=0.1)
    japi = JaxFedOpt(lr_config(jcfg, train, FEDADAM), lr_data(jax_synthetic), jax_lr_model())
    tapi = FedOptAPI(lr_config(tcfg, train, FEDADAM), lr_data(synthetic_classification),
                     torch_lr_model(), device="cpu")
    tapi.global_vars = from_flax(jax.device_get(japi.global_vars)["params"])
    japi.train()
    tapi.train()
    want = jax.device_get(japi.global_vars)["params"]
    got = to_flax(tapi.global_vars)
    for leaf in want["linear"]:
        np.testing.assert_allclose(got["linear"][leaf], np.asarray(want["linear"][leaf]),
                                   rtol=1e-5, atol=1e-5, err_msg=leaf)
    for trow, jrow in zip(tapi.history, japi.history):
        for key in ("Train/Loss", "Test/Acc"):
            if key in jrow:
                assert abs(trow[key] - jrow[key]) <= 1e-5, (key, trow, jrow)


def test_fedopt_api_matches_reference_on_cnn_slice():
    """2 rounds of FedAdam on the small CNN slice (12 clients, 4 a round,
    batch 20) with the reference's shuffles; the slice's tolerances."""
    japi, tapi = run_slice(server=FEDADAM, rounds=2)
    assert_slice_close(japi, tapi, rounds=2)
