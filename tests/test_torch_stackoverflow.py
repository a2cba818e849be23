"""The port's StackOverflow loaders and the ``tag`` task against the
reference's on the CPU, on TFF-layout files the tests write: both loaders
byte-identical to the reference's (small vocabularies and the registry's
10,000 words / 500 tags), the vocabulary files, ``max_clients``, the tag
loss and metrics, two FedAvg rounds of tag prediction against the
reference's, the command line on both datasets, and ``h5py`` imported
only when a loader runs.

Tolerances: the tag loss and counts rtol 1e-6 (the same sigmoid BCE in
float32, summed in another order); the FedAvg rounds rtol 1e-5, atol 1e-6
(full batch, one SGD step a client a round)."""

import json
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("h5py")
import jax.numpy as jnp  # noqa: E402

import fedml_tpu.config as jcfg  # noqa: E402
from fedml_tpu.data import registry as jregistry  # noqa: E402
from fedml_tpu.data import stackoverflow as jso  # noqa: E402
from fedml_tpu.train.client import make_task_loss as jax_task_loss  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch import cli as tcli  # noqa: E402
from fedml_tpu_torch.data import registry as tregistry  # noqa: E402
from fedml_tpu_torch.data import stackoverflow as tso  # noqa: E402
from fedml_tpu_torch.train.client import make_task_loss  # noqa: E402

from torch_parity import (  # noqa: E402
    assert_same_dataset, flat_params, population_config, private_reference_programs,
    reference_record, write_stackoverflow,
)


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


@pytest.fixture(scope="module")
def so_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("stackoverflow")
    write_stackoverflow(path)
    return path


@pytest.mark.parametrize("kind,kw", [
    ("lr", dict(vocab_size=50, tag_size=10)),
    ("lr", dict(vocab_size=10000, tag_size=500, max_clients=3)),
    ("nwp", dict(vocab_size=50, max_seq_len=6)),
    ("nwp", dict(vocab_size=10000, max_clients=None)),
])
def test_loaders_are_the_references_byte_for_byte(so_dir, kind, kw):
    got = getattr(tso, f"load_stackoverflow_{kind}")(str(so_dir), **kw)
    want = getattr(jso, f"load_stackoverflow_{kind}")(str(so_dir), **kw)
    assert_same_dataset(got, want)
    assert got.num_clients == (kw.get("max_clients") or 5)
    if kind == "lr":
        assert got.client_x[0].shape[1] == kw["vocab_size"]
        assert got.client_y[0].shape[1] == kw["tag_size"] == got.num_classes
    else:
        assert got.client_x[0].shape[1] == kw.get("max_seq_len", 20)
        assert (got.client_x[0][:, 0] == kw["vocab_size"] + 1).all()  # bos


def test_vocabularies_are_the_references(so_dir):
    assert tso.load_word_vocab(str(so_dir), 300) == jso.load_word_vocab(str(so_dir), 300)
    assert tso.load_tag_vocab(str(so_dir), 7) == jso.load_tag_vocab(str(so_dir), 7)
    with pytest.raises(FileNotFoundError, match="stackoverflow file not found"):
        tso.load_word_vocab(str(so_dir / "missing"))


@pytest.mark.parametrize("name,task", [("stackoverflow_lr", "tag"), ("stackoverflow_nwp", "nwp")])
def test_registry_loads_what_the_references_loads(so_dir, name, task):
    kw = dict(dataset=name, data_dir=str(so_dir))
    got = tregistry.load(tcfg.RunConfig(data=tcfg.DataConfig(**kw),
                                        fed=tcfg.FedConfig(client_num_in_total=4)))
    want = jregistry.load(jcfg.RunConfig(data=jcfg.DataConfig(**kw),
                                         fed=jcfg.FedConfig(client_num_in_total=4)))
    assert_same_dataset(got, want)
    assert tregistry.task_for_dataset(name) == jregistry.task_for_dataset(name) == task


def test_h5py_is_imported_only_by_a_running_loader(so_dir, monkeypatch):
    assert "h5py" not in vars(tso)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tso.load_stackoverflow_nwp(str(so_dir), vocab_size=50)


def test_tag_task_matches_the_references():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(7, 12)).astype(np.float32) * 3
    labels = (rng.random((7, 12)) < 0.2).astype(np.float32)
    mask = np.r_[np.ones(5), np.zeros(2)].astype(np.float32)
    got = make_task_loss("tag")(torch.from_numpy(logits), torch.from_numpy(labels),
                                torch.from_numpy(mask))
    want = jax_task_loss("tag")(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want], rtol=1e-6)
    assert float(got[2]) == 5 * 12
    with pytest.raises(NotImplementedError, match="no_such_task"):
        make_task_loss("no_such_task")


FED = dict(per_round=3, rounds=2)


def test_tag_prediction_rounds_match_the_references(so_dir):
    """Two full-batch FedAvg rounds of logistic regression on
    stackoverflow_lr (50 words, 10 tags, 5 clients, 3 a round), from the
    reference's init."""
    from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvg
    from fedml_tpu.models import create_model as jax_create_model

    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.bridge import from_flax, to_flax
    from fedml_tpu_torch.models import create_model

    kw = dict(vocab_size=50, tag_size=10)

    def run():
        data = jso.load_stackoverflow_lr(str(so_dir), **kw)
        api = JaxFedAvg(population_config(jcfg, 5, batch_size=-1, **FED), data,
                        jax_create_model("lr", "stackoverflow_lr", (50,), 10), task="tag")
        init = jax.device_get(api.global_vars)
        api.train()
        return dict(init=init, params=jax.device_get(api.global_vars),
                    rows=[{k: v for k, v in r.items() if k != "round_time_s"}
                          for r in api.history])

    ref = reference_record("fedavg_stackoverflow_lr", dict(files=sorted(
        p.name for p in so_dir.iterdir()), kw=kw, fed=FED), run)
    model = create_model("lr", "stackoverflow_lr", (50,), 10)
    init = from_flax(ref.init)
    model.init = lambda generator: {k: v.clone() for k, v in init.items()}
    api = FedAvgAPI(population_config(tcfg, 5, batch_size=-1, **FED),
                    tso.load_stackoverflow_lr(str(so_dir), **kw), model, task="tag", device="cpu")
    api.train()
    for got, want in zip(api.history, ref.rows, strict=True):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    got = flat_params(to_flax(api.global_vars))
    for k, v in flat_params(ref.params.get("params", ref.params)).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("dataset,model", [("stackoverflow_nwp", "rnn"), ("stackoverflow_lr", "lr")])
def test_cli_trains_on_stackoverflow(so_dir, dataset, model, tmp_path, capsys):
    """The command line on the registry's files: the StackOverflow RNN at
    full width (10,004 symbols, LSTM 670) on next words, and logistic
    regression over 10,000 words on 500 tags."""
    api = tcli.main(["--dataset", dataset, "--model", model, "--data_dir", str(so_dir),
                     "--client_num_in_total", "3", "--client_num_per_round", "2",
                     "--comm_round", "1", "--batch_size", "4", "--log_dir", str(tmp_path)],
                    device="cpu")
    assert api.task == ("nwp" if model == "rnn" else "tag")
    assert api.model.num_classes == (10004 if model == "rnn" else 500)
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(final["Train/Loss"]) and np.isfinite(final["Test/Loss"])
