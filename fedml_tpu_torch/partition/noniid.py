"""Non-IID data partitioners (port of ``fedml_tpu/partition/noniid.py``;
pure numpy, host-side).

A copy of the reference's code: each class's sample indices are split
across clients by a Dirichlet(alpha) draw, with a retry loop guaranteeing
every client at least ``min_size`` samples, and clients already at their
fair share receive no more of a class. The draws come from the same
generator in the same order, so the same seed gives the same index maps
(tests/test_torch_partition.py)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def homo_partition(n_samples: int, num_clients: int, rng: np.random.Generator) -> Dict[int, np.ndarray]:
    """IID partition: shuffle and split evenly."""
    idxs = rng.permutation(n_samples)
    return {i: np.sort(part) for i, part in enumerate(np.array_split(idxs, num_clients))}


def partition_class_samples_with_dirichlet(
    rng: np.random.Generator,
    alpha: float,
    client_idx_batches: List[List[int]],
    class_idxs: np.ndarray,
    n_total: int,
    num_clients: int,
) -> List[List[int]]:
    """Split one class's indices across clients by a capped Dirichlet draw."""
    rng.shuffle(class_idxs)
    proportions = rng.dirichlet(np.repeat(alpha, num_clients))
    # Cap: clients that already hold a fair share get none of this class.
    fair = n_total / num_clients
    proportions = np.array(
        [p * (len(batch) < fair) for p, batch in zip(proportions, client_idx_batches)]
    )
    proportions = proportions / proportions.sum()
    cuts = (np.cumsum(proportions) * len(class_idxs)).astype(int)[:-1]
    return [
        batch + split.tolist()
        for batch, split in zip(client_idx_batches, np.split(class_idxs, cuts))
    ]


def lda_partition(
    labels: np.ndarray,
    num_clients: int,
    alpha: float,
    seed: int = 0,
    min_size: int = 10,
) -> Dict[int, np.ndarray]:
    """LDA (Dirichlet) label-skew partition for classification.

    The per-client minimum is capped at the mean shard size (a larger one
    could never be met), and the retry loop gives up after 10,000 draws.
    Returns {client_id: sorted sample indices}."""
    labels = np.asarray(labels).reshape(-1)
    n_total = labels.shape[0]
    classes = np.unique(labels)
    rng = np.random.default_rng(seed)
    min_size = min(min_size, n_total // num_clients)
    current_min = -1
    batches: List[List[int]] = [[] for _ in range(num_clients)]
    for _ in range(10_000):
        batches = [[] for _ in range(num_clients)]
        for c in classes:
            class_idxs = np.where(labels == c)[0]
            batches = partition_class_samples_with_dirichlet(
                rng, alpha, batches, class_idxs, n_total, num_clients
            )
        current_min = min(len(b) for b in batches)
        if current_min >= min_size:
            break
    else:
        raise RuntimeError(
            f"LDA partition: could not reach min {min_size} samples/client "
            f"(n={n_total}, clients={num_clients}, alpha={alpha}) in 10k draws"
        )
    return {i: np.sort(np.array(batch, dtype=np.int64)) for i, batch in enumerate(batches)}


def record_data_stats(labels: np.ndarray, net_dataidx_map: Dict[int, np.ndarray]) -> Dict[int, dict]:
    """Per-client class histogram."""
    stats = {}
    for client, idxs in net_dataidx_map.items():
        unq, counts = np.unique(np.asarray(labels)[idxs], return_counts=True)
        stats[client] = {int(u): int(c) for u, c in zip(unq, counts)}
    return stats
