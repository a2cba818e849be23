"""Synthetic federated datasets (port of ``fedml_tpu/data/synthetic.py``:
``synthetic_classification`` with the IID partition, and
``synthetic_shakespeare``).

A copy of the reference's numpy generator: the same seed gives
byte-identical arrays (tests/test_torch_fed_transformer.py)."""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.data.base import FederatedDataset


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
    """Gaussian-blob classification data, split IID across clients
    (``partition_method="homo"``: shuffle, split evenly). With ``ragged``
    each shard is trimmed to a client-specific 50-100% of its size."""
    if partition_method != "homo":
        raise NotImplementedError(
            f"partition_method {partition_method!r} is not ported yet (ROADMAP.md); the port has 'homo'"
        )
    rng = np.random.default_rng(seed)
    n_total = num_clients * samples_per_client
    dim = int(np.prod(feat_shape))
    means = rng.normal(0.0, 1.0, size=(num_classes, dim))
    y = rng.integers(0, num_classes, size=n_total).astype(np.int32)
    x = (means[y] + rng.normal(0.0, 1.0, size=(n_total, dim))).astype(np.float32)
    x = x.reshape((n_total,) + tuple(feat_shape))
    parts = np.array_split(rng.permutation(n_total), num_clients)
    client_x, client_y = [], []
    for part in parts:
        idxs = np.sort(part)
        if ragged:
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
