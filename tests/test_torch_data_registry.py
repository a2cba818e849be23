"""The port's dataset registry and file loaders against the reference's on
the CPU: every ported name loads a byte-identical dataset, every name of
``TASKS`` maps to the same task, the LEAF and TFF-h5 loaders read the
fixtures of tests/golden/ and small files written here the same way, and
the names once refused (``imagenet``, ``landmarks``) raise the reference's
FileNotFoundError without their files."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

import fedml_tpu.config as jcfg
from fedml_tpu.data import leaf as jleaf
from fedml_tpu.data import registry as jregistry
from fedml_tpu.data import tff_h5 as jtff

import fedml_tpu_torch.config as tcfg
from fedml_tpu_torch.data import leaf as tleaf
from fedml_tpu_torch.data import registry as tregistry
from fedml_tpu_torch.data import tff_h5 as ttff

GOLDEN = Path(__file__).resolve().parent / "golden"
PORTED = [
    ("synthetic", 6, "hetero"),
    ("synthetic", 6, "homo"),
    ("synthetic_1_1", 8, "hetero"),
    ("synthetic_0.5_0.5", 8, "hetero"),
    ("femnist_synth", 5, "hetero"),
    ("shakespeare_synth", 4, "hetero"),
    ("shakespeare_synth_lm", 4, "hetero"),
    ("seg_synth", 3, "hetero"),
]
# the names the registry once refused; ported since (their loaders are held
# to the reference in tests/test_torch_imagenet_landmarks.py)
NOT_PORTED = ["imagenet", "landmarks"]


def _config(cfg_mod, name, clients, partition="hetero", data_dir="./data", seed=3):
    return cfg_mod.RunConfig(
        data=cfg_mod.DataConfig(dataset=name, data_dir=str(data_dir), partition_method=partition),
        fed=cfg_mod.FedConfig(client_num_in_total=clients),
        seed=seed,
    )


def _assert_same(got, want):
    assert (got.name, got.num_classes, got.num_clients) == (want.name, want.num_classes,
                                                             want.num_clients)
    parts = ("client_x", "client_y", "client_test_x", "client_test_y")
    for part in parts:
        g, w = getattr(got, part), getattr(want, part)
        assert (g is None) == (w is None), part
        for a, b in zip(g or [], w or [], strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), part
    for a, b in ((got.test_x, want.test_x), (got.test_y, want.test_y)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name,clients,partition", PORTED)
def test_registry_load_is_byte_identical(name, clients, partition):
    _assert_same(tregistry.load(_config(tcfg, name, clients, partition)),
                 jregistry.load(_config(jcfg, name, clients, partition)))


def test_every_task_maps_as_the_reference():
    names = list(jregistry.TASKS) + ["synthetic_1_1", "SYNTHETIC_0.5_0.5", "no_such_set"]
    assert tregistry.TASKS == jregistry.TASKS
    for name in names:
        assert tregistry.task_for_dataset(name) == jregistry.task_for_dataset(name), name


@pytest.mark.parametrize("name", NOT_PORTED)
def test_unported_names_raise(name, tmp_path):
    """Without their files, both packages raise the same FileNotFoundError."""
    errors = []
    for registry, cfg_mod in ((tregistry, tcfg), (jregistry, jcfg)):
        with pytest.raises(FileNotFoundError) as e:
            registry.load(_config(cfg_mod, name, 4, data_dir=tmp_path / "missing"))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_unknown_name_raises_key_error():
    with pytest.raises(KeyError, match="unknown dataset"):
        tregistry.load(_config(tcfg, "no_such_set", 4))


@pytest.mark.parametrize("name", ["mnist", "femnist_leaf"])
def test_leaf_loaders_read_the_golden_fixture(name):
    d = GOLDEN / "leaf_femnist"
    if name == "mnist":
        got = tregistry.load(_config(tcfg, "mnist", 5, data_dir=d))
        want = jregistry.load(_config(jcfg, "mnist", 5, data_dir=d))
    else:
        got, want = tleaf.load_femnist_leaf(str(d)), jleaf.load_femnist_leaf(str(d))
    assert got.num_clients >= 1 and got.client_x[0].shape[1:] == (28, 28, 1)
    _assert_same(got, want)


def _write_leaf(root: Path, split: str, users: dict) -> None:
    (root / split).mkdir(parents=True)
    blob = {"users": list(users), "num_samples": [len(u["y"]) for u in users.values()],
            "user_data": users}
    (root / split / "part_0.json").write_text(json.dumps(blob))


def test_leaf_shakespeare_matches_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    chars = "abcdefgh ,.!?XYZé"

    def user(n):
        xs = ["".join(rng.choice(list(chars), size=80)) for _ in range(n)]
        return {"x": xs, "y": [str(rng.choice(list(chars))) for _ in range(n)]}

    _write_leaf(tmp_path, "train", {"u1": user(5), "u0": user(3), "u2": user(4)})
    _write_leaf(tmp_path, "test", {"u1": user(2), "u2": user(1)})  # u0 has no test shard
    got = tregistry.load(_config(tcfg, "shakespeare", 2, data_dir=tmp_path))
    want = jregistry.load(_config(jcfg, "shakespeare", 2, data_dir=tmp_path))
    assert got.num_clients == 2 and got.client_test_x[0].shape == (0, 80)
    _assert_same(got, want)


def test_leaf_loader_names_the_missing_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match="leaf data dir not found"):
        tleaf.load_mnist(str(tmp_path / "absent"))


def test_tff_femnist_reads_the_golden_fixture():
    pytest.importorskip("h5py")
    got = tregistry.load(_config(tcfg, "femnist", 0, data_dir=GOLDEN))
    want = jregistry.load(_config(jcfg, "femnist", 0, data_dir=GOLDEN))
    assert got.num_clients >= 1
    _assert_same(got, want)


def _write_h5(path: Path, clients: dict) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        ex = f.create_group("examples")
        for cid, fields in clients.items():
            g = ex.create_group(cid)
            for k, v in fields.items():
                g.create_dataset(k, data=v)


def test_tff_cifar100_and_shakespeare_match_the_reference(tmp_path):
    pytest.importorskip("h5py")
    rng = np.random.default_rng(1)

    def cifar(n):
        return {"image": rng.integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8),
                "label": rng.integers(0, 100, size=n)}

    def snippets(n):
        return {"snippets": np.array([("to be, or not " * int(k)).encode()
                                      for k in rng.integers(1, 12, size=n)])}

    _write_h5(tmp_path / "fed_cifar100_train.h5", {"c1": cifar(4), "c0": cifar(3), "c2": cifar(2)})
    _write_h5(tmp_path / "fed_cifar100_test.h5", {"c0": cifar(2), "c9": cifar(3)})
    _write_h5(tmp_path / "shakespeare_train.h5", {"b": snippets(3), "a": snippets(2)})
    _write_h5(tmp_path / "shakespeare_test.h5", {"a": snippets(2), "z": snippets(1)})
    for name, clients in (("fed_cifar100", 2), ("fed_shakespeare", 0)):
        got = tregistry.load(_config(tcfg, name, clients, data_dir=tmp_path))
        want = jregistry.load(_config(jcfg, name, clients, data_dir=tmp_path))
        _assert_same(got, want)
    assert got.client_x[0].shape[1] == 80 and got.num_classes == 90


def test_tff_loaders_without_h5py_raise_import_error(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py now raises
    for loader in (ttff.load_femnist, ttff.load_fed_cifar100, ttff.load_fed_shakespeare):
        with pytest.raises(ImportError, match="needs the h5py package"):
            loader(str(tmp_path))
    assert jtff.FEMNIST_TRAIN == ttff.FEMNIST_TRAIN
