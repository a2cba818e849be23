"""Checkpoints are interchangeable between the packages: one file format
(``vars/`` as flax paths, ``opt/`` in optax's state layout, ``sched/``,
``__meta__``), read and written by both.

- A checkpoint the reference writes (CNN vars, each server optimizer's
  state, a weighted scheduler's memo and loss map) loads in the port, and
  the port writes it back with the same keys, the same metadata and the
  same arrays, bit for bit.
- A checkpoint the port writes restores onto the reference's own
  templates (flax params, ``optax.adam`` state, ``ClientScheduler``) with
  the port's values.
- The write is atomic and leaves no temporary file; only rank 0 writes
  where torch.distributed is initialized."""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import fedml_tpu.config as jcfg  # noqa: E402
from fedml_tpu.algorithms.fedopt import make_server_optimizer as jax_server_optimizer  # noqa: E402
from fedml_tpu.models import create_model as jax_create_model  # noqa: E402
from fedml_tpu.scheduler import ClientScheduler as JaxScheduler  # noqa: E402
from fedml_tpu.utils import checkpoint as jck  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.algorithms.fedopt import make_server_optimizer  # noqa: E402
from fedml_tpu_torch.bridge import from_flax, to_flax  # noqa: E402
from fedml_tpu_torch.models import create_model  # noqa: E402
from fedml_tpu_torch.scheduler import ClientScheduler  # noqa: E402
from fedml_tpu_torch.utils import checkpoint as tck  # noqa: E402

OPTIMIZERS = ("sgd", "sgdm", "adam", "yogi", "adagrad")
SHAPE, CLASSES = (28, 28, 1), 62
SCHED = dict(num_clients=20, k=5, policy="weighted", seed=3,
             sample_counts=np.arange(1, 21) * 7)


def _npz(path):
    with np.load(str(path) + ".npz") as z:
        return {k: z[k] for k in z.files}


def _jax_init():
    model = jax_create_model("cnn", "femnist", SHAPE, CLASSES)
    return jax.device_get(model.init(jax.random.PRNGKey(0)))


def _steps(opt, state, params, rng, n=2):
    """``n`` optimizer steps on random pseudo-gradients (updates dropped)."""
    for _ in range(n):
        g = jax.tree_util.tree_map(
            lambda p: jax.numpy.asarray(rng.normal(size=p.shape).astype(np.float32)), params)
        _, state = opt.update(g, state, params)
    return state


def _run_scheduler(sched):
    for r in range(4):
        for cid in sched.select(r):
            sched.report_loss(int(cid), 1.0 / (r + 1) + int(cid) * 1e-3)
    return sched


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_reference_checkpoint_round_trips_through_the_port(tmp_path, name):
    rng = np.random.default_rng(OPTIMIZERS.index(name))
    jvars = _jax_init()
    sc = dict(server_optimizer=name, server_lr=0.05)
    jopt = jax_server_optimizer(jcfg.ServerConfig(**sc))
    jstate = _steps(jopt, jopt.init(jvars["params"]), jvars["params"], rng)
    jsched = _run_scheduler(JaxScheduler(**SCHED))
    jck.save_checkpoint(str(tmp_path / "ref"), jvars, round_idx=4, server_opt_state=jstate,
                        sched_state=jsched.state_dict())

    tvars, round_idx, rng_slot, topt, algo, tsched_state = tck.load_checkpoint(str(tmp_path / "ref"))
    assert (round_idx, rng_slot, algo) == (4, None, None)
    template = create_model("cnn", "femnist", SHAPE, CLASSES).init(torch.Generator().manual_seed(1))
    variables = tck.restore_like(template, tvars)
    state = tck.restore_like(make_server_optimizer(tcfg.ServerConfig(**sc)).init(template), topt)
    sched = ClientScheduler(**SCHED)
    sched.load_state_dict(tsched_state)
    assert sched.selections() == jsched.selections()
    tck.save_checkpoint(str(tmp_path / "port"), variables, round_idx=round_idx,
                        server_opt_state=state, sched_state=sched.state_dict())

    ref, port = _npz(tmp_path / "ref"), _npz(tmp_path / "port")
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k].dtype == ref[k].dtype and port[k].shape == ref[k].shape, k
        assert port[k].tobytes() == ref[k].tobytes(), k
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "ref.json").read_text())


def test_port_checkpoint_restores_onto_the_reference_templates(tmp_path):
    """The port's CNN vars, FedAdam state after two steps and a weighted
    scheduler, restored by the reference onto its own templates."""
    rng = np.random.default_rng(5)
    variables = create_model("cnn", "femnist", SHAPE, CLASSES).init(torch.Generator().manual_seed(2))
    opt = make_server_optimizer(tcfg.ServerConfig(server_optimizer="adam", server_lr=0.05))
    state = opt.init(variables)
    for _ in range(2):
        g = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
             for k, v in variables.items()}
        _, state = opt.update(g, state, variables)
    sched = _run_scheduler(ClientScheduler(**SCHED))
    tck.save_checkpoint(str(tmp_path / "ck"), variables, round_idx=4, server_opt_state=state,
                        sched_state=sched.state_dict())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck.json", "ck.npz"]  # no .tmp left

    jvars, round_idx, _, jopt_state, _, jsched_state = jck.load_checkpoint(str(tmp_path / "ck"))
    assert round_idx == 4
    jtemplate = _jax_init()
    restored = jck.restore_like(jtemplate, jvars)
    want = to_flax(variables)
    for layer in want:
        for leaf in want[layer]:
            np.testing.assert_array_equal(np.asarray(restored["params"][layer][leaf]),
                                          want[layer][leaf])
    jopt = optax.adam(0.05, b1=0.9, b2=0.99, eps=jcfg.ServerConfig().tau)
    adam = jck.restore_like(jopt.init(jtemplate["params"]), jopt_state)[0]
    assert int(adam.count) == state[0].count == 2
    for got, mine in ((adam.mu, state[0].mu), (adam.nu, state[0].nu)):
        mine = to_flax(mine)
        for layer in mine:
            for leaf in mine[layer]:
                np.testing.assert_array_equal(np.asarray(got[layer][leaf]), mine[layer][leaf])
    jsched = JaxScheduler(**SCHED)
    jsched.load_state_dict(jsched_state)
    assert jsched.selections() == sched.selections()
    assert dict(jsched._ctx.losses.items()) == dict(sched._ctx.losses.items())


def test_restore_like_refuses_another_model(tmp_path):
    lr = create_model("lr", "synthetic", (5,), 3).init(torch.Generator().manual_seed(0))
    tck.save_checkpoint(str(tmp_path / "ck"), lr, round_idx=1)
    loaded = tck.load_checkpoint(str(tmp_path / "ck"))[0]
    cnn = create_model("cnn", "femnist", SHAPE, CLASSES).init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="do not match"):
        tck.restore_like(cnn, loaded)


def test_only_rank_zero_writes_under_torch_distributed(tmp_path, monkeypatch):
    variables = create_model("lr", "synthetic", (5,), 3).init(torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    tck.save_checkpoint(str(tmp_path / "ck"), variables, round_idx=1)
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
    tck.save_checkpoint(str(tmp_path / "ck"), variables, round_idx=1)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck.json", "ck.npz"]
