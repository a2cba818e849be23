"""TFF-exported h5 dataset loaders — FederatedEMNIST, fed_cifar100,
fed_shakespeare (port of ``fedml_tpu/data/tff_h5.py``; after
fedml_api/data_preprocessing/{FederatedEMNIST, fed_cifar100,
fed_shakespeare}/data_loader.py; layout: h5 group 'examples' keyed by client
id with per-client datasets).

``h5py`` is imported when a loader opens its file, never when this module is
imported; where it is not installed the loaders raise ImportError. There is
no other reader."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from fedml_tpu_torch.data import text as T
from fedml_tpu_torch.data.base import FederatedDataset, concat_nonempty

_EXAMPLE = "examples"

FEMNIST_TRAIN = "fed_emnist_train.h5"
FEMNIST_TEST = "fed_emnist_test.h5"
CIFAR100_TRAIN = "fed_cifar100_train.h5"
CIFAR100_TEST = "fed_cifar100_test.h5"
SHAKES_TRAIN = "shakespeare_train.h5"
SHAKES_TEST = "shakespeare_test.h5"


def _open(path: str):
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs the h5py package, which is not installed; "
            "the TFF h5 loaders have no other reader"
        ) from e

    if not os.path.exists(path):
        raise FileNotFoundError(
            f"TFF h5 file not found: {path} (ref data/*/download*.sh fetch "
            "these from fedml.ai / TFF mirrors)"
        )
    return h5py.File(path, "r")


def load_femnist(data_dir: str, max_clients: Optional[int] = None) -> FederatedDataset:
    """'pixels' [N,28,28] float, 'label' int per client
    (ref FederatedEMNIST/data_loader.py:18-60)."""
    with _open(os.path.join(data_dir, FEMNIST_TRAIN)) as tr, _open(
        os.path.join(data_dir, FEMNIST_TEST)
    ) as te:
        ids = sorted(tr[_EXAMPLE].keys())
        if max_clients:
            ids = ids[:max_clients]
        client_x, client_y, ctx, cty = [], [], [], []
        for cid in ids:
            g = tr[_EXAMPLE][cid]
            client_x.append(
                np.asarray(g["pixels"], np.float32).reshape(-1, 28, 28, 1)
            )
            client_y.append(np.asarray(g["label"], np.int32))
            if cid in te[_EXAMPLE]:
                gt = te[_EXAMPLE][cid]
                ctx.append(np.asarray(gt["pixels"], np.float32).reshape(-1, 28, 28, 1))
                cty.append(np.asarray(gt["label"], np.int32))
            else:
                ctx.append(np.zeros((0, 28, 28, 1), np.float32))
                cty.append(np.zeros((0,), np.int32))
    return FederatedDataset(
        name="femnist",
        client_x=client_x,
        client_y=client_y,
        test_x=concat_nonempty(ctx, client_x[0]),
        test_y=concat_nonempty(cty, client_y[0]),
        num_classes=62,
        client_test_x=ctx,
        client_test_y=cty,
    )


def load_fed_cifar100(
    data_dir: str, max_clients: Optional[int] = None, crop: int = 24
) -> FederatedDataset:
    """'image' [N,32,32,3] uint8, 'label' int per client; per-image
    standardization + center crop to 24×24 (the reference applies random
    crop/flip at train time, fed_cifar100/data_loader.py:57-80 — here the
    deterministic part is host-side; random aug belongs in the train-time pipeline,
    train/augment.py)."""
    off = (32 - crop) // 2

    def prep(img_u8):
        x = np.asarray(img_u8, np.float32) / 255.0
        m = x.mean(axis=(1, 2, 3), keepdims=True)
        s = x.std(axis=(1, 2, 3), keepdims=True) + 1e-6
        x = (x - m) / s
        return x[:, off : off + crop, off : off + crop, :]

    with _open(os.path.join(data_dir, CIFAR100_TRAIN)) as tr, _open(
        os.path.join(data_dir, CIFAR100_TEST)
    ) as te:
        ids = sorted(tr[_EXAMPLE].keys())
        if max_clients:
            ids = ids[:max_clients]
        client_x = [prep(tr[_EXAMPLE][c]["image"]) for c in ids]
        client_y = [np.asarray(tr[_EXAMPLE][c]["label"], np.int32) for c in ids]
        test_ids = sorted(te[_EXAMPLE].keys())
        tx = np.concatenate([prep(te[_EXAMPLE][c]["image"]) for c in test_ids])
        ty = np.concatenate(
            [np.asarray(te[_EXAMPLE][c]["label"], np.int32) for c in test_ids]
        )
    return FederatedDataset(
        name="fed_cifar100",
        client_x=client_x,
        client_y=client_y,
        test_x=tx,
        test_y=ty,
        num_classes=100,
    )


def load_fed_shakespeare(data_dir: str, max_clients: Optional[int] = None) -> FederatedDataset:
    """'snippets' string arrays per client → 80-token next-char sequences
    (ref fed_shakespeare/data_loader.py + utils.py preprocess/split)."""

    def prep(snippets) -> tuple:
        sents = [
            s.decode("utf-8") if isinstance(s, bytes) else str(s) for s in snippets
        ]
        seqs = T.preprocess_snippets(sents)
        return T.split_xy(seqs)

    with _open(os.path.join(data_dir, SHAKES_TRAIN)) as tr, _open(
        os.path.join(data_dir, SHAKES_TEST)
    ) as te:
        ids = sorted(tr[_EXAMPLE].keys())
        if max_clients:
            ids = ids[:max_clients]
        client_x, client_y = [], []
        for cid in ids:
            x, y = prep(tr[_EXAMPLE][cid]["snippets"])
            client_x.append(x)
            client_y.append(y)
        txs, tys = [], []
        for cid in sorted(te[_EXAMPLE].keys()):
            x, y = prep(te[_EXAMPLE][cid]["snippets"])
            if len(x):
                txs.append(x)
                tys.append(y)
    return FederatedDataset(
        name="fed_shakespeare",
        client_x=client_x,
        client_y=client_y,
        test_x=concat_nonempty(txs, client_x[0]),
        test_y=concat_nonempty(tys, client_y[0]),
        num_classes=T.VOCAB_SIZE,
    )
