"""Augmentation and the CIFAR-family loaders of the port against the
reference.

Augmentation (fedml_tpu_torch/train/augment.py): the reference draws its
per-sample offsets from JAX keys, which torch cannot reproduce, so the
test draws the offsets the reference draws from its keys (the same
``fold_in``/``randint``/``bernoulli`` calls as its ``_crop_one``,
``_flip_one`` and ``_cutout_one``) and hands them to the port's
``apply_augment``: the batches must be equal exactly (the transforms only
move, keep or zero values). The port's own draws are held to their ranges
and to their generator.

Loaders (fedml_tpu_torch/data/cifar.py, data/registry.py): tiny CIFAR-10
and CIFAR-100 pickle trees and a CINIC-10 ImageFolder tree written to
``tmp_path``; the port's datasets must be byte-identical to the
reference's under the homo and the Dirichlet split."""

import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from fedml_tpu_torch.train.augment import (  # noqa: E402
    apply_augment, draw_offsets, make_augment, resolve_augment,
)

from torch_parity import torch_threads  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # ResNet-56 rounds on the CPU: under 6 test workers 8 threads a process
    # spin against each other
    with torch_threads(1):
        yield


def _reference_offsets(rng, n, H, W, pad, flip, cutout):
    """The offsets the reference's make_augment draws from ``rng``."""
    out = {k: [] for k in ("oy", "ox", "flip", "cy", "cx")}
    for key in jax.random.split(rng, n):
        kc = jax.random.fold_in(key, 0)
        out["oy"].append(int(jax.random.randint(kc, (), 0, 2 * pad + 1)))
        out["ox"].append(int(jax.random.randint(jax.random.fold_in(kc, 1), (), 0, 2 * pad + 1)))
        out["flip"].append(int(jax.random.bernoulli(jax.random.fold_in(key, 1))))
        kk = jax.random.fold_in(key, 2)
        out["cy"].append(int(jax.random.randint(kk, (), 0, H)))
        out["cx"].append(int(jax.random.randint(jax.random.fold_in(kk, 1), (), 0, W)))
    keep = ({"oy", "ox"} if pad else set()) | ({"flip"} if flip else set()) | (
        {"cy", "cx"} if cutout else set())
    return {k: torch.tensor(v) for k, v in out.items() if k in keep}


@pytest.mark.parametrize("pad,flip,cutout,fill", [
    (4, True, 16, None),  # the cifar policy
    (4, True, 0, None),  # crop_flip
    (2, False, 8, 0.5),  # crop with a fill, Cutout on its own
    (0, True, 16, None),  # flip and Cutout only
])
def test_given_the_reference_offsets_the_batch_is_the_reference_batch(pad, flip, cutout, fill):
    from fedml_tpu.train.augment import make_augment as jax_make_augment

    x = np.random.default_rng(0).normal(size=(12, 10, 12, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    want = jax_make_augment(crop_padding=pad, flip=flip, cutout_size=cutout, crop_fill=fill)(
        rng, jnp.asarray(x))
    offsets = _reference_offsets(rng, 12, 10, 12, pad, flip, cutout)
    got = apply_augment(torch.from_numpy(x), offsets, crop_padding=pad, cutout_size=cutout,
                        crop_fill=fill)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), x)


def test_draws_cover_their_ranges_and_follow_the_generator():
    a = draw_offsets(torch.Generator().manual_seed(1), 4000, 32, 30)
    assert sorted(a) == ["cx", "cy", "flip", "ox", "oy"]
    for k, hi in (("oy", 9), ("ox", 9), ("flip", 2), ("cy", 32), ("cx", 30)):
        assert a[k].min() == 0 and a[k].max() == hi - 1, k
    assert abs(a["flip"].float().mean().item() - 0.5) < 0.04
    b = draw_offsets(torch.Generator().manual_seed(1), 4000, 32, 30)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert sorted(draw_offsets(torch.Generator(), 3, 8, 8, cutout_size=0)) == ["flip", "ox", "oy"]


def test_policies():
    assert resolve_augment("none") is None and resolve_augment("") is None
    x = torch.randn(5, 32, 32, 3)
    for name in ("cifar", "crop_flip"):
        out = resolve_augment(name)(torch.Generator().manual_seed(0), x)
        assert out.shape == x.shape
    with pytest.raises(ValueError, match="unknown augment policy"):
        resolve_augment("autoaugment")
    with pytest.raises(ValueError, match="image batches"):
        make_augment()(torch.Generator(), torch.randn(4, 16))


def test_local_train_augments_each_step_from_its_seed():
    """``TrainConfig.augment`` runs in the local step: the same step seed
    gives the same weights, another seed or no augmentation other ones."""
    from fedml_tpu_torch.config import TrainConfig
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.train.client import make_local_train

    model = create_model("cnn", "cifar10", (12, 12, 3), 10)
    init = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 4, 12, 12, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (2, 4)))
    mask = torch.ones(2, 4)

    def perm(epoch, m):
        return torch.arange(m.shape[0])

    runs = {}
    for policy, seed in (("cifar", 1), ("cifar", 1), ("cifar", 2), ("none", 1)):
        train = make_local_train(model, TrainConfig(lr=0.1, augment=policy), 1)
        runs.setdefault((policy, seed), []).append(train(init, x, y, mask, perm, step_seed=seed)[0])
    (a, b), (c,), (plain,) = runs[("cifar", 1)], runs[("cifar", 2)], runs[("none", 1)]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    assert any(not torch.equal(a[k], plain[k]) for k in a)


# ------------------------------------------------------------------ loaders


def _write_pickle(path, data, labels, key):
    with open(path, "wb") as f:
        pickle.dump({b"data": data, key: labels}, f)


def _cifar_tree(root, rng):
    d10 = root / "cifar-10-batches-py"
    d10.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        n = 6
        _write_pickle(d10 / name, rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                      list(rng.integers(0, 10, n)), b"labels")
    d100 = root / "cifar-100-python"
    d100.mkdir()
    for name, n in (("train", 40), ("test", 8)):
        _write_pickle(d100 / name, rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                      list(rng.integers(0, 100, n)), b"fine_labels")


def _cinic_tree(root, rng):
    from PIL import Image

    for split, per_class in (("train", 5), ("test", 2)):
        for c in ("airplane", "bird", "cat"):
            d = root / "cinic" / split / c
            d.mkdir(parents=True)
            for i in range(per_class):
                Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(d / f"{i}.png")


def _assert_same(got, want):
    assert (got.name, got.num_classes, got.num_clients) == (want.name, want.num_classes, want.num_clients)
    for g, w in zip(got.client_x + got.client_y + [got.test_x, got.test_y],
                    want.client_x + want.client_y + [want.test_x, want.test_y], strict=True):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("partition", ["homo", "hetero"])
@pytest.mark.parametrize("name", ["cifar10", "cifar100", "cinic10"])
def test_cifar_family_loads_byte_identical_to_the_reference(tmp_path, name, partition):
    import fedml_tpu.config as jcfg
    from fedml_tpu.data import registry as jax_registry

    import fedml_tpu_torch.config as tcfg
    from fedml_tpu_torch.data import registry

    rng = np.random.default_rng(0)
    if name == "cinic10":
        pytest.importorskip("PIL")
        _cinic_tree(tmp_path, rng)
        data_dir = tmp_path / "cinic"
    else:
        _cifar_tree(tmp_path, rng)
        data_dir = tmp_path

    def config(cfg_mod):
        return cfg_mod.RunConfig(
            data=cfg_mod.DataConfig(dataset=name, data_dir=str(data_dir), partition_method=partition,
                                    partition_alpha=0.5),
            fed=cfg_mod.FedConfig(client_num_in_total=3),
            seed=2,
        )

    got, want = registry.load(config(tcfg)), jax_registry.load(config(jcfg))
    _assert_same(got, want)
    assert got.client_x[0].shape[1:] == (32, 32, 3) and got.client_x[0].dtype == np.float32
    assert registry.task_for_dataset(name) == "classification"


def test_missing_cifar_directory_is_a_file_not_found_error(tmp_path):
    from fedml_tpu_torch.data.cifar import load_cifar_family

    for name in ("cifar10", "cifar100", "cinic10"):
        with pytest.raises(FileNotFoundError, match="not found"):
            load_cifar_family(name, str(tmp_path), num_clients=2)


def test_cli_trains_and_resumes_resnet56_with_cifar_augmentation(tmp_path):
    """``python -m fedml_tpu_torch --model resnet56 --dataset synthetic
    --augment cifar``: 2 rounds straight against 1 round and ``--resume``
    from its checkpoint (which carries the running statistics) to 2 —
    bit-equal, the augmentation offsets and shuffles keyed by round."""
    import json

    from fedml_tpu_torch import cli

    base = ["--model", "resnet56", "--dataset", "synthetic", "--client_num_in_total", "2",
            "--client_num_per_round", "2", "--batch_size", "32", "--augment", "cifar",
            "--lr", "0.05"]

    def run(name, rounds, resume=False):
        argv = base + ["--comm_round", str(rounds), "--log_dir", str(tmp_path / name),
                       "--checkpoint_path", str(tmp_path / (name if not resume else "half"))]
        return cli.main(argv + (["--resume"] if resume else []), device="cpu")

    straight = run("straight", 2)
    run("half", 1)
    resumed = run("resumed", 2, resume=True)
    assert any(k.startswith("batch_stats.") for k in straight.global_vars)
    for k, v in straight.global_vars.items():
        assert torch.equal(resumed.global_vars[k], v), k
    rows = [json.loads(line) for line in (tmp_path / "straight" / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(r["Train/Loss"]) for r in rows if "Train/Loss" in r)
