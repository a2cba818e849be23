"""Leaf-format (JSON user shards) dataset loaders — MNIST, FEMNIST,
Shakespeare (port of ``fedml_tpu/data/leaf.py``; after
fedml_api/data_preprocessing/MNIST/data_loader.py:14-110,
shakespeare/data_loader.py:19-60; format: .json files with keys ``users``,
``user_data`` {uid: {"x": [...], "y": [...]}}, ``num_samples``).

Raw data is not vendored (the reference downloads it in CI,
CI-install.sh:39-80); loaders raise FileNotFoundError with the expected
layout when the directory is missing."""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from fedml_tpu_torch.data import text as T
from fedml_tpu_torch.data.base import FederatedDataset, concat_nonempty


def _read_leaf_dir(path: str) -> Tuple[List[str], Dict]:
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"leaf data dir not found: {path} (expected *.json files with "
            "'users'/'user_data' keys, as produced by the leaf benchmark "
            "download scripts — ref data/MNIST/download_and_unzip.sh)"
        )
    users: List[str] = []
    user_data: Dict = {}
    for f in sorted(os.listdir(path)):
        if not f.endswith(".json"):
            continue
        with open(os.path.join(path, f)) as fd:
            cdata = json.load(fd)
        users.extend(cdata["users"])
        user_data.update(cdata["user_data"])
    return sorted(set(users)), user_data


def load_leaf(
    data_dir: str,
    transform_x: Callable[[list], np.ndarray],
    transform_y: Callable[[list], np.ndarray],
    num_classes: int,
    name: str,
    max_clients: Optional[int] = None,
) -> FederatedDataset:
    """Generic leaf reader: train/ and test/ subdirs, same user sets
    (ref MNIST read_data, data_loader.py:19-57)."""
    train_users, train_data = _read_leaf_dir(os.path.join(data_dir, "train"))
    _, test_data = _read_leaf_dir(os.path.join(data_dir, "test"))
    if max_clients:
        train_users = train_users[:max_clients]
    client_x, client_y, ctest_x, ctest_y = [], [], [], []
    for u in train_users:
        client_x.append(transform_x(train_data[u]["x"]))
        client_y.append(transform_y(train_data[u]["y"]))
        td = test_data.get(u, {"x": [], "y": []})
        ctest_x.append(transform_x(td["x"]))
        ctest_y.append(transform_y(td["y"]))
    test_x = concat_nonempty(ctest_x, client_x[0])
    test_y = concat_nonempty(ctest_y, client_y[0])
    return FederatedDataset(
        name=name,
        client_x=client_x,
        client_y=client_y,
        test_x=test_x,
        test_y=test_y,
        num_classes=num_classes,
        client_test_x=ctest_x,
        client_test_y=ctest_y,
    )


def _mnist_x(rows: list) -> np.ndarray:
    a = np.asarray(rows, np.float32)
    return a.reshape((-1, 28, 28, 1)) if a.size else a.reshape((0, 28, 28, 1))


def _int_y(rows: list) -> np.ndarray:
    return np.asarray(rows, np.int32)


def load_mnist(data_dir: str, max_clients: Optional[int] = None) -> FederatedDataset:
    """Leaf MNIST: 1000 users, flat-784 floats (ref MNIST/data_loader.py).
    Reshaped to 28×28×1 NHWC, the reference's layout; the LR model flattens
    again."""
    return load_leaf(data_dir, _mnist_x, _int_y, 10, "mnist", max_clients)


def load_femnist_leaf(data_dir: str, max_clients: Optional[int] = None) -> FederatedDataset:
    return load_leaf(data_dir, _mnist_x, _int_y, 62, "femnist", max_clients)


def _shakespeare_x(rows: list) -> np.ndarray:
    if not rows:
        return np.zeros((0, T.SEQUENCE_LENGTH), np.int32)
    return np.asarray([T.chars_to_ids(s) for s in rows], np.int32)


def _shakespeare_y(rows: list) -> np.ndarray:
    return np.asarray([T.char_to_id(c) for c in rows], np.int32)


def load_shakespeare(data_dir: str, max_clients: Optional[int] = None) -> FederatedDataset:
    """Leaf Shakespeare: x = 80-char window, y = next char → next-char
    classification over the 90-symbol vocab (ref shakespeare/data_loader.py +
    language_utils.py word_to_indices/letter_to_index)."""
    return load_leaf(
        data_dir, _shakespeare_x, _shakespeare_y, T.VOCAB_SIZE, "shakespeare", max_clients
    )
