"""Google Landmarks, gld23k and gld160k (port of
``fedml_tpu/data/landmarks.py``).

CSV mapping files with rows (user_id, image_id, class): the train file's
rows make one client a ``user_id`` (a naturally federated split; a file
without that column is one client), the test file's rows the central test
set, and the class index runs over the classes of both files, sorted.
Images load from ``data_dir/images/<image_id>.<ext>``: with PIL (imported
only for an image file), resized and normalised with mean and std 0.5, or
as a ``.npy`` fixture, read as it is."""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from fedml_tpu_torch.data.base import FederatedDataset

MEAN, STD = 0.5, 0.5
_EXTS = (".jpg", ".jpeg", ".png", ".npy")


def _read_mapping(path: str) -> List[dict]:
    with open(path) as f:
        rows = list(csv.DictReader(f))
    if rows and not {"image_id", "class"} <= set(rows[0]):
        raise ValueError(
            f"{path}: mapping CSV needs image_id and class columns "
            f"(got {sorted(rows[0])})"
        )
    return rows


def _find_image(images_dir: str, image_id: str) -> str:
    for ext in _EXTS:
        p = os.path.join(images_dir, image_id + ext)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no image file for id {image_id} in {images_dir}")


def _load(images_dir: str, image_id: str, image_size: int) -> np.ndarray:
    path = _find_image(images_dir, image_id)
    if path.endswith(".npy"):
        return np.asarray(np.load(path), np.float32)
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((image_size, image_size))
        return (np.asarray(im, np.float32) / 255.0 - MEAN) / STD


def load_landmarks(
    data_dir: str,
    train_map_file: str = "mini_gld_train_split.csv",
    test_map_file: str = "mini_gld_test.csv",
    image_size: int = 224,
    max_clients: Optional[int] = None,
) -> FederatedDataset:
    images_dir = os.path.join(data_dir, "images")
    train_rows = _read_mapping(os.path.join(data_dir, train_map_file))
    test_rows = _read_mapping(os.path.join(data_dir, test_map_file))

    per_user: Dict[str, List[dict]] = defaultdict(list)
    for r in train_rows:
        per_user[r.get("user_id", "0")].append(r)
    users = sorted(per_user)[: max_clients or None]

    classes = sorted(
        {r["class"] for r in train_rows} | {r["class"] for r in test_rows}
    )
    cls_idx = {c: i for i, c in enumerate(classes)}

    client_x, client_y = [], []
    for u in users:
        rows = per_user[u]
        client_x.append(
            np.stack([_load(images_dir, r["image_id"], image_size) for r in rows])
        )
        client_y.append(
            np.asarray([cls_idx[r["class"]] for r in rows], np.int32)
        )
    test_x = np.stack(
        [_load(images_dir, r["image_id"], image_size) for r in test_rows]
    )
    test_y = np.asarray([cls_idx[r["class"]] for r in test_rows], np.int32)
    return FederatedDataset(
        name="landmarks",
        client_x=client_x,
        client_y=client_y,
        test_x=test_x,
        test_y=test_y,
        num_classes=len(classes),
    )
