"""Centralised image datasets with an LDA or homo split — CIFAR-10,
CIFAR-100, CINIC-10 (port of ``fedml_tpu/data/cifar.py``).

Each ships as one global train set: the python pickle batches of CIFAR
(``cifar-10-batches-py/``, ``cifar-100-python/``) or CINIC-10's ImageFolder
tree (``train/<class>/*.png``, ``test/…``; read with Pillow, imported when
a file is opened). Pixels are normalised with the reference's constants;
the federated split is the Dirichlet (``hetero``) or uniform (``homo``)
partition of partition/noniid.py. Augmentation is not applied here: it
runs in the training step (train/augment.py, ``TrainConfig.augment``), so
the stored samples stay canonical."""

from __future__ import annotations

import os
import pickle

import numpy as np

from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.partition.noniid import homo_partition, lda_partition

CIFAR10_MEAN = (0.49139968, 0.48215827, 0.44653124)
CIFAR10_STD = (0.24703233, 0.24348505, 0.26158768)
CIFAR100_MEAN = (0.5071, 0.4865, 0.4409)
CIFAR100_STD = (0.2673, 0.2564, 0.2762)
CINIC10_MEAN = (0.47889522, 0.47227842, 0.43047404)
CINIC10_STD = (0.24205776, 0.23828046, 0.25874835)


def _normalize(x_u8: np.ndarray, mean, std) -> np.ndarray:
    x = x_u8.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _read_pickle_batch(path: str, label_key: bytes):
    with open(path, "rb") as f:
        batch = pickle.load(f, encoding="bytes")
    x = batch[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y = np.asarray(batch[label_key], np.int32)
    return x, y


def _load_cifar10_raw(data_dir: str):
    d = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(d):
        raise FileNotFoundError(f"CIFAR-10 not found at {d} (python pickle batches)")
    xs, ys = zip(*(_read_pickle_batch(os.path.join(d, f"data_batch_{i}"), b"labels")
                   for i in range(1, 6)))
    tx, ty = _read_pickle_batch(os.path.join(d, "test_batch"), b"labels")
    return np.concatenate(xs), np.concatenate(ys), tx, ty


def _load_cifar100_raw(data_dir: str):
    d = os.path.join(data_dir, "cifar-100-python")
    if not os.path.isdir(d):
        raise FileNotFoundError(f"CIFAR-100 not found at {d}")
    x, y = _read_pickle_batch(os.path.join(d, "train"), b"fine_labels")
    tx, ty = _read_pickle_batch(os.path.join(d, "test"), b"fine_labels")
    return x, y, tx, ty


def _load_cinic10_raw(data_dir: str):
    """CINIC-10 ImageFolder (train/ and test/, one directory per class)."""
    if not os.path.isdir(os.path.join(data_dir, "train")):
        raise FileNotFoundError(
            f"CINIC-10 not found at {data_dir} (ImageFolder layout train/<class>/*.png)"
        )
    from PIL import Image

    def read(split):
        xs, ys = [], []
        classes = sorted(os.listdir(os.path.join(data_dir, split)))
        for yi, c in enumerate(classes):
            cdir = os.path.join(data_dir, split, c)
            for fn in sorted(os.listdir(cdir)):
                with Image.open(os.path.join(cdir, fn)) as im:
                    xs.append(np.asarray(im.convert("RGB"), np.uint8))
                ys.append(yi)
        return np.stack(xs), np.asarray(ys, np.int32)

    x, y = read("train")
    tx, ty = read("test")
    return x, y, tx, ty


_DATASETS = {
    "cifar10": (_load_cifar10_raw, CIFAR10_MEAN, CIFAR10_STD, 10),
    "cifar100": (_load_cifar100_raw, CIFAR100_MEAN, CIFAR100_STD, 100),
    "cinic10": (_load_cinic10_raw, CINIC10_MEAN, CINIC10_STD, 10),
}


def load_cifar_family(
    name: str,
    data_dir: str,
    num_clients: int,
    partition_method: str = "hetero",
    partition_alpha: float = 0.5,
    seed: int = 0,
) -> FederatedDataset:
    """Global train set → LDA (``hetero``) or uniform (``homo``) client
    shards, the test set whole."""
    loader, mean, std, num_classes = _DATASETS[name]
    x, y, tx, ty = loader(data_dir)
    x = _normalize(x, mean, std)
    tx = _normalize(tx, mean, std)
    if partition_method == "homo":
        idx_map = homo_partition(len(y), num_clients, np.random.default_rng(seed))
    else:
        idx_map = lda_partition(y, num_clients, partition_alpha, seed=seed)
    return FederatedDataset(
        name=name,
        client_x=[x[idx_map[i]] for i in range(num_clients)],
        client_y=[y[idx_map[i]] for i in range(num_clients)],
        test_x=tx,
        test_y=ty,
        num_classes=num_classes,
    )
