"""Federated dataset containers (port of ``fedml_tpu/data/base.py``).

Non-IID client shards are ragged; each round the sampled clients are padded
to a bucketed common step count and carry a float mask, so every loss is a
mask-weighted mean and padding never changes the math. The shape contract
(:func:`size_class`, :func:`bucket_steps`) is the reference's, line for
line: the same cohort gives the same [C, S, B] shapes in both packages."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _ceil_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def concat_nonempty(parts: Sequence[np.ndarray], like: np.ndarray) -> np.ndarray:
    """Concatenate, tolerating an all-empty list (returns a well-formed
    (0, *feat) array shaped and typed like ``like``'s rows)."""
    parts = [p for p in parts if len(p)]
    if not parts:
        return np.zeros((0,) + tuple(like.shape[1:]), like.dtype)
    return np.concatenate(parts, axis=0)


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length() if x > 1 else 1


def size_class(n: int) -> int:
    """Power of two up to 16, multiples of 8 above — the size-class policy
    for local-step counts."""
    return _next_pow2(n) if n <= 16 else _ceil_to(n, 8)


def bucket_steps(ns: Sequence[int], batch_size: int, pad_bucket: int):
    """Per-client sample counts → (steps, bs, cap) of the stacked batch.
    ``batch_size == -1`` = full batch (one step of every sample); otherwise
    the step count is size-class bucketed."""
    max_n = max(ns)
    bs = max_n if batch_size == -1 else batch_size
    steps = _ceil_to(_ceil_to(max_n, bs) // bs, pad_bucket)
    if batch_size != -1:
        steps = size_class(steps)
    return steps, bs, steps * bs


# size_class as an exact integer table for steps <= 16, so the vectorized
# form cannot drift from the scalar one
_POW2_LUT = np.array([size_class(i) for i in range(17)], dtype=np.int64)


def steps_class_array(counts, batch_size: int, pad_bucket: int) -> np.ndarray:
    """Each client's singleton-bucket step count in one numpy pass:
    ``steps_class_array(c, bs, pb)[i] == bucket_steps([c[i]], bs, pb)[0]``.
    Full batch (``batch_size == -1``) has no shared bs and is refused."""
    if batch_size == -1:
        raise ValueError("steps_class_array: full-batch mode has no "
                         "shared bs; use bucket_steps per client")
    c = np.asarray(counts, np.int64)
    steps = -(-np.maximum(c, 0) // batch_size)  # ceil(n / bs)
    steps = -(-steps // pad_bucket) * pad_bucket  # ceil_to pad_bucket
    small = steps <= 16
    out = np.where(small, _POW2_LUT[np.minimum(steps, 16)], -(-steps // 8) * 8)
    return out.astype(np.int64)


def partition_shape_classes(counts, batch_size: int, pad_bucket: int):
    """Every (steps, bs) shape class a partition can produce, as
    ``{(steps, bs): first client index in that class}``. A cohort's class
    reads only ``max(ns)``, which is some client's count, so the reachable
    classes are the per-client singleton buckets: one numpy pass and
    ``np.unique`` for a fixed batch size, the scalar loop at full batch."""
    if batch_size == -1:
        classes: Dict[tuple, int] = {}
        for i, n in enumerate(counts):
            klass = bucket_steps([int(n)], batch_size, pad_bucket)[:2]
            classes.setdefault(klass, i)
        return classes
    steps = steps_class_array(counts, batch_size, pad_bucket)
    uniq, first = np.unique(steps, return_index=True)
    return {(int(s), int(batch_size)): int(i) for s, i in zip(uniq, first)}


@dataclasses.dataclass
class ClientBatch:
    """Dense data for a set of sampled clients: x [C, S, B, *feat],
    y [C, S, B, *lab], mask [C, S, B] float32, num_samples [C] float32.
    Padded entries have mask 0. Host stacking yields numpy arrays, the
    device store torch tensors on its device."""

    x: object
    y: object
    mask: object
    num_samples: np.ndarray

    @property
    def num_clients(self) -> int:
        return self.x.shape[0]


@dataclasses.dataclass
class FederatedDataset:
    """Host-side federated dataset: one (x, y) numpy shard per client plus a
    central test set, and optionally one test shard per client (the file
    loaders read them)."""

    name: str
    client_x: List[np.ndarray]
    client_y: List[np.ndarray]
    test_x: np.ndarray
    test_y: np.ndarray
    num_classes: int
    client_test_x: Optional[List[np.ndarray]] = None
    client_test_y: Optional[List[np.ndarray]] = None

    @property
    def num_clients(self) -> int:
        return len(self.client_x)

    @property
    def train_sample_counts(self) -> np.ndarray:
        return np.array([len(y) for y in self.client_y], dtype=np.int64)

    def total_train_samples(self) -> int:
        return int(self.train_sample_counts.sum())

    def population_index(self):
        """This partition's metadata (counts, weights, shape classes) as a
        packed :class:`~fedml_tpu_torch.population.PopulationIndex`, built
        once from :attr:`train_sample_counts` (the mmap store's is an
        ``np.diff`` of its offsets)."""
        from fedml_tpu_torch.population import PopulationIndex

        return PopulationIndex.from_dataset(self)

    def centralized_train(self) -> tuple:
        """Every client's shard concatenated (the centralized trainer's
        pooled data)."""
        return np.concatenate(self.client_x, axis=0), np.concatenate(self.client_y, axis=0)


def stack_clients(
    data: FederatedDataset,
    client_indices: Sequence[int],
    batch_size: int,
    seed: int = 0,
    pad_bucket: int = 1,
) -> ClientBatch:
    """Dense numpy ClientBatch for the sampled clients: each client's rows in
    a ``default_rng(seed)`` permutation order, zero-padded to the bucketed
    capacity. The reference gathers the rows with its native threaded
    gather; numpy fancy indexing selects the same rows."""
    ns = [len(data.client_y[i]) for i in client_indices]
    steps, bs, cap = bucket_steps(ns, batch_size, pad_bucket)
    rng = np.random.default_rng(seed)
    first = client_indices[0]
    feat_shape = data.client_x[first].shape[1:]
    lab_shape = data.client_y[first].shape[1:]
    C = len(client_indices)
    x = np.zeros((C, cap) + feat_shape, dtype=data.client_x[first].dtype)
    y = np.zeros((C, cap) + lab_shape, dtype=data.client_y[first].dtype)
    mask = np.zeros((C, cap), dtype=np.float32)
    for j, ci in enumerate(client_indices):
        n = ns[j]
        order = rng.permutation(n)
        x[j, :n] = data.client_x[ci][order]
        y[j, :n] = data.client_y[ci][order]
        mask[j, :n] = 1.0
    return ClientBatch(
        x=x.reshape((C, steps, bs) + feat_shape),
        y=y.reshape((C, steps, bs) + lab_shape),
        mask=mask.reshape((C, steps, bs)),
        num_samples=np.array(ns, dtype=np.float32),
    )


def pad_clients_to(batch: ClientBatch, target: int) -> ClientBatch:
    """Pad the client axis to ``target`` with all-mask-zero dummy clients:
    ``num_samples`` 0 (the weighted average and DP's inclusion mask leave
    them out) and an all-zero mask (the local train skips every one of
    their steps, so their variables come back unchanged). Host (numpy) and
    device-store (torch) batches alike."""
    extra = target - batch.num_clients
    if extra <= 0:
        return batch

    def pad0(a):
        if isinstance(a, np.ndarray):
            return np.pad(a, [(0, extra)] + [(0, 0)] * (a.ndim - 1))
        return torch.cat([a, a.new_zeros((extra,) + tuple(a.shape[1:]))])

    return ClientBatch(
        x=pad0(batch.x), y=pad0(batch.y), mask=pad0(batch.mask),
        num_samples=pad0(batch.num_samples),
    )
