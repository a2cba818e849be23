"""Synthetic federated datasets (port of ``fedml_tpu/data/synthetic.py``:
``synthetic_classification``, ``synthetic_segmentation``,
``synthetic_shakespeare`` and the FedProx family ``synthetic_fedprox``).

A copy of the reference's numpy generators, drawing in the reference's
order: the same seed gives byte-identical arrays
(tests/test_torch_partition.py, tests/test_torch_fed_transformer.py)."""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.partition.noniid import homo_partition, lda_partition


def synthetic_classification(
    num_clients: int = 10,
    num_classes: int = 10,
    feat_shape=(28, 28, 1),
    samples_per_client: int = 64,
    partition_method: str = "homo",
    partition_alpha: float = 0.5,
    seed: int = 0,
    ragged: bool = True,
) -> FederatedDataset:
    """Gaussian-blob classification data, split across clients:
    ``partition_method="homo"`` shuffles and splits evenly, any other value
    is the Dirichlet(``partition_alpha``) label-skew partition. With
    ``ragged`` each IID shard is trimmed to a client-specific 50-100% of its
    size (drawn from ``rng`` after the partition); the Dirichlet shards are
    ragged already and are not trimmed."""
    rng = np.random.default_rng(seed)
    n_total = num_clients * samples_per_client
    dim = int(np.prod(feat_shape))
    means = rng.normal(0.0, 1.0, size=(num_classes, dim))
    y = rng.integers(0, num_classes, size=n_total).astype(np.int32)
    x = (means[y] + rng.normal(0.0, 1.0, size=(n_total, dim))).astype(np.float32)
    x = x.reshape((n_total,) + tuple(feat_shape))
    if partition_method == "homo":
        idx_map = homo_partition(n_total, num_clients, rng)
    else:
        idx_map = lda_partition(y, num_clients, partition_alpha, seed=seed)
    client_x, client_y = [], []
    for i in range(num_clients):
        idxs = idx_map[i]
        if ragged and partition_method == "homo":
            idxs = idxs[: max(2, int(len(idxs) * rng.uniform(0.5, 1.0)))]
        client_x.append(x[idxs])
        client_y.append(y[idxs])
    n_test = max(num_classes * 8, 64)
    yt = rng.integers(0, num_classes, size=n_test).astype(np.int32)
    xt = (means[yt] + rng.normal(0.0, 1.0, size=(n_test, dim))).astype(np.float32)
    xt = xt.reshape((n_test,) + tuple(feat_shape))
    return FederatedDataset(
        name="synthetic", client_x=client_x, client_y=client_y, test_x=xt, test_y=yt,
        num_classes=num_classes,
    )


def synthetic_segmentation(
    num_clients: int = 4,
    num_classes: int = 4,
    image_size: int = 16,
    samples_per_client: int = 16,
    seed: int = 0,
) -> FederatedDataset:
    """Per-pixel labelled images for the segmentation task: x [n, H, H, 3]
    unit normals, y [n, H, H] uniform classes, and 1.5·c added to channel
    0 of every pixel of class c so a model can learn the map. The test set
    holds max(16, samples_per_client) images."""
    rng = np.random.default_rng(seed)
    H = image_size

    def gen(n):
        x = rng.normal(size=(n, H, H, 3)).astype(np.float32)
        y = rng.integers(0, num_classes, size=(n, H, H)).astype(np.int32)
        for c in range(num_classes):
            x[..., 0] += 1.5 * c * (y == c)
        return x, y

    client_x, client_y = [], []
    for _ in range(num_clients):
        x, y = gen(samples_per_client)
        client_x.append(x)
        client_y.append(y)
    tx, ty = gen(max(16, samples_per_client))
    return FederatedDataset(
        name="seg_synth",
        client_x=client_x,
        client_y=client_y,
        test_x=tx,
        test_y=ty,
        num_classes=num_classes,
    )


def synthetic_shakespeare(
    num_clients: int = 64,
    samples_per_client: int = 60,
    seq_len: int = 80,
    vocab_size: int = 90,
    seed: int = 0,
    seq_targets: bool = False,
) -> FederatedDataset:
    """Shakespeare-geometry next-char data (80-char windows over a 90-char
    vocab by default) from a synthetic Markov character process: char c
    goes to (c*7+3) mod V with probability 0.85, else to a uniform char.
    Each client's chain starts from a client-specific state; shard sizes
    are ragged (uniform 50-100% of ``samples_per_client``, at least 4).
    ``seq_targets`` gives causal-LM labels (every position's next char, task
    "nwp") instead of the window's single next char."""
    rng = np.random.default_rng(seed)
    succ = (np.arange(vocab_size) * 7 + 3) % vocab_size

    def chain(n_chars: int, state: int) -> np.ndarray:
        jump = rng.random(n_chars) < 0.85
        noise = rng.integers(0, vocab_size, n_chars)
        out = np.empty(n_chars, np.int32)
        for t in range(n_chars):
            state = succ[state] if jump[t] else noise[t]
            out[t] = state
        return out

    def windows(n: int, state: int):
        text = chain(n + seq_len, state)
        x = np.stack([text[i : i + seq_len] for i in range(n)]).astype(np.int32)
        if seq_targets:
            y = np.stack([text[i + 1 : i + 1 + seq_len] for i in range(n)]).astype(np.int32)
        else:
            y = text[seq_len : seq_len + n].astype(np.int32)
        return x, y

    client_x, client_y = [], []
    for _ in range(num_clients):
        n = max(4, int(samples_per_client * rng.uniform(0.5, 1.0)))
        x, y = windows(n, int(rng.integers(0, vocab_size)))
        client_x.append(x)
        client_y.append(y)
    xt, yt = windows(256, 1)
    return FederatedDataset(
        name="shakespeare_synth_lm" if seq_targets else "shakespeare_synth",
        client_x=client_x,
        client_y=client_y,
        test_x=xt,
        test_y=yt,
        num_classes=vocab_size,
    )


def synthetic_fedprox(
    alpha: float = 1.0,
    beta: float = 1.0,
    num_clients: int = 30,
    num_classes: int = 10,
    dim: int = 60,
    seed: int = 0,
    min_samples: int = 10,
    max_samples: int = 200,
) -> FederatedDataset:
    """FedProx-style synthetic(α, β): per-client logistic models drawn
    around client-specific means. α controls model heterogeneity, β data
    heterogeneity; client sizes are power-law, and each client's last 16
    samples go to the central test set."""
    rng = np.random.default_rng(seed)
    sizes = np.clip(
        (rng.lognormal(4, 2, num_clients)).astype(int), min_samples, max_samples
    )
    B = rng.normal(0, beta, num_clients)
    diag = np.array([(j + 1) ** -1.2 for j in range(dim)])
    client_x, client_y = [], []
    test_x, test_y = [], []
    for i in range(num_clients):
        u = rng.normal(B[i], 1.0, dim)
        W = rng.normal(0, alpha, (dim, num_classes)) + rng.normal(0, 1) * alpha
        b = rng.normal(0, alpha, num_classes)
        n = int(sizes[i]) + 16
        xx = rng.multivariate_normal(u, np.diag(diag), n).astype(np.float32)
        logits = xx @ W + b
        yy = np.argmax(logits, axis=1).astype(np.int32)
        client_x.append(xx[:-16])
        client_y.append(yy[:-16])
        test_x.append(xx[-16:])
        test_y.append(yy[-16:])
    return FederatedDataset(
        name=f"synthetic_{alpha}_{beta}",
        client_x=client_x,
        client_y=client_y,
        test_x=np.concatenate(test_x),
        test_y=np.concatenate(test_y),
        num_classes=num_classes,
    )
