"""The ImageNet and Landmarks loaders of the port
(fedml_tpu_torch/data/imagenet.py, landmarks.py) against the reference's
on fixture trees the tests write: ``.npy`` fixtures and PNG files (PIL
decodes and resizes them), with and without a ``val/`` split; the arrays
bit for bit; the streaming mmap store's files byte for byte, and its
refusal to reuse a store built for other parameters; Landmarks' per-user
shards, its class index over train ∪ test and its error texts; and both
names through the data registry."""

import csv
import os

import numpy as np
import pytest

pytest.importorskip("jax")
Image = pytest.importorskip("PIL.Image")

from fedml_tpu.data import imagenet as jimagenet  # noqa: E402
from fedml_tpu.data import landmarks as jlandmarks  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.data import imagenet, landmarks  # noqa: E402
from fedml_tpu_torch.data import registry as data_registry  # noqa: E402

from torch_parity import assert_same_dataset  # noqa: E402

SIZE = 8  # the fixtures' image size


def _image(path, rng, fmt, size=SIZE):
    if fmt == "npy":
        np.save(path + ".npy", rng.normal(size=(size, size, 3)).astype(np.float32))
    else:  # a PNG of another size, which the loaders resize
        Image.fromarray(rng.integers(0, 256, size=(size + 3, size + 1, 3), dtype=np.uint8)).save(
            path + ".png")


def _imagenet_tree(root, fmt, val, classes=4, per_class=5):
    """An ImageFolder tree: ``per_class`` images a class in train/, 2 in
    val/."""
    rng = np.random.default_rng(0)
    for split in ("train", "val") if val else ("train",):
        for c in range(classes):
            d = os.path.join(root, split, f"n{c:04d}")
            os.makedirs(d)
            for i in range(per_class if split == "train" else 2):
                _image(os.path.join(d, f"img{i}"), rng, fmt)
    return str(root)


@pytest.mark.parametrize("fmt", ["npy", "png"])
@pytest.mark.parametrize("val", [True, False])
@pytest.mark.parametrize("partition", ["homo", "hetero"])
def test_imagenet_matches_reference(tmp_path, fmt, val, partition):
    root = _imagenet_tree(tmp_path / "tree", fmt, val)
    kw = dict(num_clients=3, image_size=SIZE, partition_method=partition, partition_alpha=0.5,
              seed=4)
    assert_same_dataset(imagenet.load_imagenet(root, **kw), jimagenet.load_imagenet(root, **kw))
    # max_per_class and max_clients (the registry's argument) shape it the same way
    kw.update(max_per_class=3, max_clients=2)
    assert_same_dataset(imagenet.load_imagenet(root, **kw), jimagenet.load_imagenet(root, **kw))


def _store_files(path):
    return {f: open(os.path.join(path, f), "rb").read() for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("val", [True, False])
def test_streaming_store_is_byte_equal_and_refuses_other_parameters(tmp_path, val):
    root = _imagenet_tree(tmp_path / "tree", "npy", val, classes=5, per_class=6)
    kw = dict(num_clients=3, image_size=SIZE, partition_method="hetero", seed=2, chunk_rows=4,
              test_cap=6)
    got = imagenet.load_imagenet_streaming(root, str(tmp_path / "port"), **kw)
    want = jimagenet.load_imagenet_streaming(root, str(tmp_path / "ref"), **kw)
    assert _store_files(tmp_path / "port") == _store_files(tmp_path / "ref")
    assert_same_dataset(got, want)
    # the same parameters reuse the store; others are refused with the same text
    assert_same_dataset(imagenet.load_imagenet_streaming(root, str(tmp_path / "port"), **kw), want)
    kw["seed"] = 3
    errors = []
    for mod, store in ((imagenet, "port"), (jimagenet, "ref")):
        with pytest.raises(ValueError) as e:
            mod.load_imagenet_streaming(root, str(tmp_path / store), **kw)
        errors.append(str(e.value).replace(str(tmp_path / store), "<store>"))
    assert errors[0] == errors[1] and "different parameters" in errors[0]


def _landmarks_tree(root, fmt, users=("u3", "u10", "u2"), per_user=3, test=4, user_col=True,
                    names=("train.csv", "test.csv")):
    """gld-style CSVs (user_id, image_id, class) and images/<id>.<ext>; the
    test rows hold a class no train row has. Returns (root, the number of
    classes of train ∪ test)."""
    rng = np.random.default_rng(1)
    os.makedirs(os.path.join(root, "images"))
    train, n = [], 0
    for u in users:
        for _ in range(per_user):
            train.append({"user_id": u, "image_id": f"im{n}", "class": str(rng.integers(0, 4))})
            n += 1
    tests = [{"image_id": f"im{n + i}", "class": str(7 if i == 0 else rng.integers(0, 4))}
             for i in range(test)]
    for row in train + tests:
        _image(os.path.join(root, "images", row["image_id"]), rng, fmt)
    for name, rows in zip(names, (train, tests)):
        fields = list(rows[0]) if (user_col or rows is tests) else ["image_id", "class"]
        with open(os.path.join(root, name), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
            w.writeheader()
            w.writerows(rows)
    return str(root), len({r["class"] for r in train + tests})


@pytest.mark.parametrize("fmt", ["npy", "png"])
@pytest.mark.parametrize("user_col", [True, False])
def test_landmarks_matches_reference(tmp_path, fmt, user_col):
    root, classes = _landmarks_tree(tmp_path, fmt, user_col=user_col)
    kw = dict(train_map_file="train.csv", test_map_file="test.csv", image_size=SIZE)
    got, want = landmarks.load_landmarks(root, **kw), jlandmarks.load_landmarks(root, **kw)
    assert_same_dataset(got, want)
    # one shard a user (users sorted as strings), the classes of both files
    assert got.num_clients == (3 if user_col else 1)
    assert got.num_classes == classes
    assert_same_dataset(landmarks.load_landmarks(root, max_clients=2, **kw),
                        jlandmarks.load_landmarks(root, max_clients=2, **kw))


def test_landmarks_errors_match_reference(tmp_path):
    root, _ = _landmarks_tree(tmp_path, "npy")
    kw = dict(train_map_file="train.csv", test_map_file="test.csv", image_size=SIZE)
    bad = os.path.join(root, "bad.csv")
    with open(bad, "w") as f:
        f.write("user_id,image\nu1,im0\n")
    texts = []
    for mod in (landmarks, jlandmarks):
        with pytest.raises(ValueError) as e:
            mod.load_landmarks(root, train_map_file="bad.csv", test_map_file="test.csv")
        texts.append(str(e.value))
    os.remove(os.path.join(root, "images", "im0.npy"))
    for mod in (landmarks, jlandmarks):
        with pytest.raises(FileNotFoundError) as e:
            mod.load_landmarks(root, **kw)
        texts.append(str(e.value))
    assert texts[0] == texts[1] and texts[2] == texts[3]


@pytest.mark.parametrize("name", ["imagenet", "landmarks"])
def test_registry_loads_imagenet_and_landmarks(tmp_path, name):
    """Through both registries (2 clients; the loaders' defaults: 224×224
    images, gld's mapping file names)."""
    import fedml_tpu.config as jcfg
    from fedml_tpu.data import registry as jregistry

    if name == "imagenet":
        root = _imagenet_tree(tmp_path / name, "png", val=False, classes=3, per_class=4)
    else:
        root, _ = _landmarks_tree(tmp_path / name, "png",
                                  names=("mini_gld_train_split.csv", "mini_gld_test.csv"))

    def config(mod):
        return mod.RunConfig(data=mod.DataConfig(dataset=name, data_dir=root),
                             fed=mod.FedConfig(client_num_in_total=2))

    got = data_registry.load(config(tcfg))
    assert_same_dataset(got, jregistry.load(config(jcfg)))
    assert got.num_clients == 2 and got.client_x[0].shape[1:] == (224, 224, 3)
    assert data_registry.task_for_dataset(name) == "classification"
