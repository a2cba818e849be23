"""The port's RNNs against the reference's flax modules on the CPU, at
narrow widths (vocabulary 30–50, hidden 16, windows of 5): the registry's
choice of variant, the parameter tree (the reference's eight LSTM leaves a
layer, through the bridge's kernel transpose alone), the initializers, the
logits and one SGD step's gradients of every variant, two FedAvg rounds of
the StackOverflow RNN against the reference's, and ``--model rnn`` through
the command line.

Tolerances: logits atol 1e-5 (observed ~1e-7: ``torch.lstm`` adds x·W_ih,
the zero input bias and h·W_hh + b in another order than flax's two dense
sums); gradients rtol 1e-4, atol 1e-6 (the same sums, back through five
steps); two full-batch FedAvg rounds rtol 1e-4, atol 1e-6 (one SGD step a
client a round at lr 0.1 carries those differences on)."""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from fedml_tpu.models import create_model as jax_create_model  # noqa: E402
from fedml_tpu.train.client import make_task_loss as jax_task_loss  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch import cli as tcli  # noqa: E402
from fedml_tpu_torch.algorithms import FedAvgAPI  # noqa: E402
from fedml_tpu_torch.bridge import flax_leaves, from_flax, to_flax  # noqa: E402
from fedml_tpu_torch.data import mmap_store as mm  # noqa: E402
from fedml_tpu_torch.models import create_model  # noqa: E402
from fedml_tpu_torch.models.rnn import RNNOriginalFedAvg, RNNStackOverFlow  # noqa: E402
from fedml_tpu_torch.train.client import make_task_loss  # noqa: E402

from torch_parity import (  # noqa: E402
    flat_params, jax_round_perm_fn, population_config, private_reference_programs,
    reference_record, torch_threads,
)

VARIANTS = {
    "stackoverflow_nwp": dict(vocab_size=40, embedding_size=6, latent_size=16),
    "shakespeare": dict(vocab_size=30, embedding_dim=5, hidden_size=16),
    "fed_shakespeare": dict(vocab_size=30, embedding_dim=5, hidden_size=16),
}
TASKS = {"stackoverflow_nwp": "nwp", "shakespeare": "classification", "fed_shakespeare": "nwp"}
SEQ = 5


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    # the port on one thread: under 6 test workers 8 threads a process spin
    # against each other
    with torch_threads(1), private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _pair(ds):
    kw = VARIANTS[ds]
    return (jax_create_model("rnn", ds, (SEQ,), 0, **kw), create_model("rnn", ds, (SEQ,), 0, **kw))


def _inputs(ds, seed=0, batch=6):
    rng = np.random.default_rng(seed)
    vocab = VARIANTS[ds]["vocab_size"]
    x = rng.integers(0, vocab, (batch, SEQ)).astype(np.int32)
    if TASKS[ds] == "nwp":
        y = np.roll(x, -1, axis=1)
        y[:, -1] = 0  # a pad token the loss skips
    else:
        y = rng.integers(0, vocab, batch).astype(np.int32)
    mask = np.ones(batch, np.float32)
    mask[-1] = 0.0
    return x, y, mask


@pytest.mark.parametrize("ds", sorted(VARIANTS))
def test_registry_and_parameter_tree_are_the_references(ds):
    jm, tm = _pair(ds)
    assert isinstance(tm.module, RNNStackOverFlow if ds == "stackoverflow_nwp" else RNNOriginalFedAvg)
    assert (tm.name, tm.num_classes, tm.input_dtype) == (
        jm.name, jm.num_classes, torch.int32)
    ref = jax.device_get(jm.init(jax.random.PRNGKey(0)))["params"]
    port = tm.init(torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_structure(to_flax(port)) == jax.tree_util.tree_structure(ref)
    assert [a.shape for a in flax_leaves(to_flax(port))] == [a.shape for a in flax_leaves(ref)]
    layers = 1 if ds == "stackoverflow_nwp" else 2
    cells = [k for k in port if k.startswith("OptimizedLSTMCell_")]
    assert len(cells) == 12 * layers  # 4 input kernels, 4 hidden kernels + 4 biases a layer
    back = from_flax(ref)
    assert all(np.array_equal(flat_params(to_flax(back))[k], v)
               for k, v in flat_params(ref).items())


def test_initializers_are_flaxs():
    _, tm = _pair("stackoverflow_nwp")
    v = tm.init(torch.Generator().manual_seed(1))
    for g in "ifgo":
        w = v[f"OptimizedLSTMCell_0.h{g}.weight"]
        assert torch.allclose(w @ w.T, torch.eye(16), atol=1e-5)  # orthogonal
        assert torch.count_nonzero(v[f"OptimizedLSTMCell_0.h{g}.bias"]) == 0
        assert f"OptimizedLSTMCell_0.i{g}.bias" not in v
        w_in = v[f"OptimizedLSTMCell_0.i{g}.weight"]  # lecun normal over fan_in 6
        assert w_in.abs().max() <= 2 * (1 / 6) ** 0.5 / 0.87962566103423978 + 1e-6
    assert v["word_embeddings.embedding"].shape == (44, 6)


@pytest.mark.parametrize("ds", sorted(VARIANTS))
def test_logits_match_flax(ds):
    jm, tm = _pair(ds)
    variables = jm.init(jax.random.PRNGKey(3))
    port = from_flax(jax.device_get(variables["params"]))
    x, _, _ = _inputs(ds)
    want, _ = jm.apply(variables, jnp.asarray(x), train=False)
    got, _ = tm.apply(port, torch.from_numpy(x), train=False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("ds", sorted(VARIANTS))
def test_one_step_gradients_match_flax(ds):
    jm, tm = _pair(ds)
    variables = jm.init(jax.random.PRNGKey(4))
    x, y, mask = _inputs(ds, seed=1)
    jloss = jax_task_loss(TASKS[ds])

    def ref_loss(params):
        out, _ = jm.apply({"params": params}, jnp.asarray(x), train=True)
        return jloss(out, jnp.asarray(y), jnp.asarray(mask))[0]

    want_loss, want = jax.value_and_grad(ref_loss)(variables["params"])
    port = {k: v.requires_grad_(True) for k, v in from_flax(jax.device_get(variables["params"])).items()}
    out, _ = tm.apply(port, torch.from_numpy(x), train=True)
    loss = make_task_loss(TASKS[ds])(out, torch.from_numpy(y), torch.from_numpy(mask))[0]
    grads = torch.autograd.grad(loss, list(port.values()))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    got = flat_params(to_flax(dict(zip(port, grads))))
    want = flat_params(jax.device_get(want))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


SO = dict(num_clients=40, mean_samples=10, vocab=40, seq_len=SEQ, seed=2)
FED = dict(per_round=3, rounds=2)


def test_fedavg_rounds_match_the_references(tmp_path):
    """Two full-batch FedAvg rounds of the narrow StackOverflow RNN over a
    40-client store, 3 clients a round, lr 0.1, from the reference's init
    with its shuffles."""
    import fedml_tpu.config as jcfg
    from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvg
    from fedml_tpu.data import mmap_store as jax_mm

    kw = VARIANTS["stackoverflow_nwp"]

    def run():
        data = jax_mm.synth_stackoverflow_mmap(str(tmp_path / "ref"), **SO)
        cfg = population_config(jcfg, 40, batch_size=-1, **FED)
        api = JaxFedAvg(cfg, data, jax_create_model("rnn", "stackoverflow_nwp", (SEQ,), 0, **kw),
                        task="nwp")
        init = jax.device_get(api.global_vars)
        api.train()
        return dict(init=init, params=jax.device_get(api.global_vars),
                    losses=[row["Train/Loss"] for row in api.history])

    ref = reference_record("fedavg_rnn_stackoverflow", dict(so=SO, fed=FED, model=kw), run)
    data = mm.synth_stackoverflow_mmap(str(tmp_path / "port"), **SO)
    model = create_model("rnn", "stackoverflow_nwp", (SEQ,), 0, **kw)
    init = from_flax(ref.init)
    model.init = lambda generator: {k: v.clone() for k, v in init.items()}
    api = FedAvgAPI(population_config(tcfg, 40, batch_size=-1, **FED), data, model, task="nwp",
                    device="cpu", perm_fn=jax_round_perm_fn(0, FED["per_round"]))
    api.train()
    np.testing.assert_allclose([row["Train/Loss"] for row in api.history], ref.losses, rtol=1e-5)
    got = flat_params(to_flax(api.global_vars))
    for k, v in flat_params(ref.params.get("params", ref.params)).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_cli_trains_the_rnn(tmp_path, capsys):
    """``--model rnn`` on shakespeare_synth: the registry picks the
    last-position RNNOriginalFedAvg (90 symbols, 2×LSTM(256), full width)
    as the reference's does, and the command trains a round."""
    api = tcli.main(["--model", "rnn", "--dataset", "shakespeare_synth", "--client_num_in_total",
                     "4", "--client_num_per_round", "2", "--comm_round", "1", "--batch_size", "16",
                     "--log_dir", str(tmp_path)], device="cpu")
    assert isinstance(api.model.module, RNNOriginalFedAvg) and not api.model.module.seq_output
    assert api.model.num_classes == 90
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(final["Train/Loss"]) and np.isfinite(final["Test/Loss"])
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert any("Train/Loss" in r for r in rows)
