"""One client's local train, port against reference on the CPU, from the same
params with the same shuffles: plain SGD, SGD with momentum and weight decay,
AMSGrad, the FedProx term, and a ragged shard whose trailing steps are all
padding. A client whose every step is padding leaves params and optimizer
state untouched and reports zero metrics."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import fedml_tpu.config as jcfg  # noqa: E402
from fedml_tpu.models import create_model as jax_create_model  # noqa: E402
from fedml_tpu.train.client import make_local_train as jax_make_local_train  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.bridge import from_flax, to_flax  # noqa: E402
from fedml_tpu_torch.models import create_model  # noqa: E402
from fedml_tpu_torch.train.client import make_local_train  # noqa: E402

from torch_parity import jax_epoch_perm  # noqa: E402

# the CNN at a reduced input (12x12: a 3*3*64 flatten) keeps the layers'
# widths and the step count small
SHAPE, CLASSES, BS = (12, 12, 1), 62, 10

CASES = {
    "sgd": (dict(lr=0.1), 1, 40),
    "sgd_momentum_wd": (dict(lr=0.05, momentum=0.9, wd=5e-4), 2, 40),
    # AMSGrad scales every coordinate's step to about lr, however small its
    # gradient: where a gradient cancels to ~1e-8 (its eps), float noise in
    # it becomes noise of order lr in the step, so this case runs at an lr
    # that keeps that noise under atol (at lr 1e-3 it reaches ~9e-6)
    "amsgrad": (dict(lr=1e-4, client_optimizer="adam"), 2, 40),
    "prox": (dict(lr=0.1, prox_mu=0.1), 2, 40),
    # 23 samples at batch 10: 3 steps of data, bucketed to 4
    "ragged_momentum_prox": (dict(lr=0.05, momentum=0.9, prox_mu=0.1), 2, 23),
}


def _client(n, steps, seed=0):
    rng = np.random.default_rng(seed)
    cap = steps * BS
    x = np.zeros((cap,) + SHAPE, np.float32)
    y = np.zeros((cap,), np.int32)
    m = np.zeros((cap,), np.float32)
    x[:n] = rng.normal(size=(n,) + SHAPE)
    y[:n] = rng.integers(0, CLASSES, size=n)
    m[:n] = 1.0
    return x.reshape((steps, BS) + SHAPE), y.reshape(steps, BS), m.reshape(steps, BS)


def _jax_params():
    jmodel = jax_create_model("cnn", "femnist", SHAPE, CLASSES)
    params = jmodel.init(jax.random.PRNGKey(3))["params"]
    return jmodel, {layer: {k: np.array(v) for k, v in leaves.items()} for layer, leaves in params.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_local_train_matches_reference(case):
    train_kw, epochs, n = CASES[case]
    steps = 4
    x, y, m = _client(n, steps)
    jmodel, params = _jax_params()
    rng = jax.random.PRNGKey(11)

    jtrain = jax_make_local_train(jmodel, jcfg.TrainConfig(**train_kw), epochs)
    jvars, jmets = jax.jit(jtrain)(
        {"params": params}, jax.numpy.asarray(x), jax.numpy.asarray(y), jax.numpy.asarray(m), rng
    )

    tmodel = create_model("cnn", "femnist", SHAPE, CLASSES)
    ttrain = make_local_train(tmodel, tcfg.TrainConfig(**train_kw), epochs)
    tvars, tmets = ttrain(
        from_flax(params), torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m),
        lambda epoch, m_flat: jax_epoch_perm(rng, epoch, m_flat),
    )

    got, want = to_flax(tvars), jvars["params"]
    for layer in want:
        for leaf in want[layer]:
            np.testing.assert_allclose(
                got[layer][leaf], np.asarray(want[layer][leaf]),
                rtol=1e-5, atol=1e-6, err_msg=f"{case} {layer}/{leaf}",
            )
    for k in ("loss_sum", "correct", "count", "steps"):
        np.testing.assert_allclose(float(tmets[k]), float(jmets[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(tmets["steps"]) == epochs * -(-n // BS)


def _copy(leaf):
    return leaf.clone() if torch.is_tensor(leaf) else leaf


@pytest.mark.parametrize(
    "train_kw", [dict(lr=0.1, momentum=0.9, prox_mu=0.1), dict(lr=1e-3, client_optimizer="adam")]
)
def test_all_padding_client_is_a_no_op(train_kw):
    tmodel = create_model("cnn", "femnist", SHAPE, CLASSES)
    ttrain = make_local_train(tmodel, tcfg.TrainConfig(**train_kw), 2)

    def perm(epoch, m_flat):
        return torch.arange(m_flat.shape[0])

    # a real client first, so momentum / moments / step count are nonzero
    x, y, m = _client(30, 3)
    init = tmodel.init(torch.Generator().manual_seed(0))
    params, state, _ = ttrain.run_epochs(
        init, ttrain.opt.init(init), torch.from_numpy(x), torch.from_numpy(y),
        torch.from_numpy(m), perm,
    )
    assert any(t.any() for t in jax.tree_util.tree_leaves(state) if torch.is_tensor(t))
    snapshot = [_copy(t) for t in jax.tree_util.tree_leaves((params, state))]

    x, y, m = _client(0, 2)
    new_params, new_state, mets = ttrain.run_epochs(
        params, state, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m), perm
    )
    after = jax.tree_util.tree_leaves((new_params, new_state))
    assert len(after) == len(snapshot)
    for a, b in zip(after, snapshot):
        assert torch.equal(a, b) if torch.is_tensor(b) else a == b
    assert torch.equal(mets, torch.zeros(4))
