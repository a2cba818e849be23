"""FEMNIST-shaped synthetic benchmark data (port of
``fedml_tpu/data/femnist_synth.py``): 28×28×1 images, 62 classes, power-law
ragged client shards around the real dataset's ~226 samples/client mean.

Pure numpy, drawn in the reference's order from the same generator, so the
arrays are byte-identical to the reference's for a given seed (pinned by
tests/test_torch_fedavg.py)."""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.data.base import FederatedDataset


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
