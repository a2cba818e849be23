"""FEMNIST-shaped synthetic benchmark data (port of
``fedml_tpu/data/femnist_synth.py``): 28×28×1 images, 62 classes, power-law
ragged client shards around the real dataset's ~226 samples/client mean;
and its hard, label-skewed variant :func:`femnist_synthetic_lda`.

Pure numpy, drawn in the reference's order from the same generator, so the
arrays are byte-identical to the reference's for a given seed (pinned by
tests/test_torch_fedavg.py, tests/test_torch_partition.py)."""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.partition.noniid import lda_partition


def femnist_synthetic(
    num_clients: int = 3400,
    mean_samples: int = 226,
    seed: int = 0,
    num_classes: int = 62,
) -> FederatedDataset:
    rng = np.random.default_rng(seed)
    sizes = np.clip(
        rng.lognormal(np.log(mean_samples), 0.4, num_clients).astype(int),
        16,
        1024,
    )
    means = rng.normal(0.0, 1.0, size=(num_classes, 16))
    proj = rng.normal(0.0, 0.3, size=(16, 28 * 28)).astype(np.float32)

    def gen(n):
        y = rng.integers(0, num_classes, size=n).astype(np.int32)
        lat = means[y] + rng.normal(0.0, 0.6, size=(n, 16))
        x = (lat @ proj + rng.normal(0, 0.3, size=(n, 28 * 28))).astype(
            np.float32
        )
        return x.reshape(n, 28, 28, 1), y

    client_x, client_y = [], []
    for i in range(num_clients):
        x, y = gen(int(sizes[i]))
        client_x.append(x)
        client_y.append(y)
    tx, ty = gen(2048)
    return FederatedDataset(
        name="femnist_synth",
        client_x=client_x,
        client_y=client_y,
        test_x=tx,
        test_y=ty,
        num_classes=num_classes,
    )


def femnist_synthetic_lda(
    num_clients: int = 128,
    alpha: float = 0.5,
    mean_samples: int = 120,
    seed: int = 0,
    num_classes: int = 62,
    class_sep: float = 0.55,
    latent_noise: float = 1.0,
    pixel_noise: float = 0.45,
    label_noise: float = 0.08,
) -> FederatedDataset:
    """The hard FEMNIST-geometry regime: the same shapes, but clients are
    LDA(alpha) label-skewed, classes overlap (``class_sep`` shrinks the
    latent mean spread, the latent and pixel noise grow) and
    ``label_noise`` caps the reachable accuracy, so a round budget can
    tell algorithms apart. The test set comes from a generator of its own
    (``seed + 1``)."""
    rng = np.random.default_rng(seed)
    n_total = num_clients * mean_samples
    means = rng.normal(0.0, class_sep, size=(num_classes, 16))
    proj = rng.normal(0.0, 0.3, size=(16, 28 * 28)).astype(np.float32)

    def gen(n, r):
        y = r.integers(0, num_classes, size=n).astype(np.int32)
        lat = means[y] + r.normal(0.0, latent_noise, size=(n, 16))
        x = (lat @ proj + r.normal(0, pixel_noise, size=(n, 28 * 28))).astype(
            np.float32
        )
        flip = r.random(n) < label_noise
        y = np.where(flip, r.integers(0, num_classes, size=n), y).astype(
            np.int32
        )
        return x.reshape(n, 28, 28, 1), y

    x, y = gen(n_total, rng)
    idx_map = lda_partition(y, num_clients, alpha, seed=seed)
    client_x = [x[idx] for idx in idx_map.values()]
    client_y = [y[idx] for idx in idx_map.values()]
    tx, ty = gen(4096, np.random.default_rng(seed + 1))
    return FederatedDataset(
        name=f"femnist_lda{alpha}",
        client_x=client_x,
        client_y=client_y,
        test_x=tx,
        test_y=ty,
        num_classes=num_classes,
    )
