"""Device-resident federated data store (port of
``fedml_tpu/data/device_store.py``).

The flat concatenation of every client shard is uploaded to the device once;
each round only a [C, S·B] index matrix crosses the bus and the sampled
clients' rows are gathered on the device. The index matrix is built on the
host exactly as the reference builds it (same bucket contract, same
``default_rng(seed)`` permutations), so a gathered round equals
:func:`fedml_tpu_torch.data.base.stack_clients` for the same seed.

:func:`fits_on_device` guards the upload: a dataset past the cap (4 GB by
default, ``FEDML_TPU_DEVICE_CACHE_MAX_BYTES`` overrides it, the
reference's name and default) stays on the host and the round stacks its
cohort there; an mmap store reports its bytes in O(1), so the guard never
walks its lazy client views."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from fedml_tpu_torch.data.base import ClientBatch, FederatedDataset, bucket_steps


_DEFAULT_MAX_BYTES = 4_000_000_000


def fits_on_device(data: FederatedDataset) -> bool:
    """Whether every client's train shard together is within the device
    cache's byte cap."""
    cap = int(os.environ.get("FEDML_TPU_DEVICE_CACHE_MAX_BYTES", _DEFAULT_MAX_BYTES))
    total = getattr(data, "total_train_bytes", None)
    if total is None:
        total = sum(cx.nbytes for cx in data.client_x) + sum(cy.nbytes for cy in data.client_y)
    return total <= cap


def _gather(flat_x, flat_y, idx, mask):
    """Gather + zero padded slots (padded indices point at row 0; the mask
    multiply zeroes them, as host stacking zero-pads)."""
    x = flat_x.index_select(0, idx)
    y = flat_y.index_select(0, idx)
    mx = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
    my = mask.reshape(mask.shape + (1,) * (y.dim() - mask.dim()))
    return x * mx.to(x.dtype), y * my.to(y.dtype)


class DeviceDataStore:
    """Upload-once, gather-per-round client data store."""

    def __init__(self, data: FederatedDataset, device: torch.device):
        counts = data.train_sample_counts
        self.device = device
        self.offsets = np.concatenate([[0], np.cumsum(counts)])
        self.counts = counts
        self.flat_x = torch.from_numpy(np.concatenate(data.client_x, axis=0)).to(device)
        self.flat_y = torch.from_numpy(np.concatenate(data.client_y, axis=0)).to(device)

    def round_indices(
        self,
        client_indices: Sequence[int],
        batch_size: int,
        seed: int = 0,
        pad_bucket: int = 1,
    ):
        """Host-side (idx [C, cap] int64, mask [C, cap] float32, steps, bs,
        ns) for one round's gather; ``ns`` are the true sample counts."""
        ns = [int(self.counts[i]) for i in client_indices]
        steps, bs, cap = bucket_steps(ns, batch_size, pad_bucket)
        rng = np.random.default_rng(seed)
        C = len(client_indices)
        idx = np.zeros((C, cap), dtype=np.int64)
        mask = np.zeros((C, cap), dtype=np.float32)
        for j, ci in enumerate(client_indices):
            n = ns[j]
            order = rng.permutation(n)
            idx[j, :n] = self.offsets[ci] + order
            mask[j, :n] = 1.0
        return idx, mask, steps, bs, ns

    def round_batch(
        self,
        client_indices: Sequence[int],
        batch_size: int,
        seed: int = 0,
        pad_bucket: int = 1,
    ) -> ClientBatch:
        """ClientBatch of device tensors, shaped [C, S, B, ...] like
        :func:`stack_clients`."""
        idx, mask, steps, bs, ns = self.round_indices(
            client_indices, batch_size, seed=seed, pad_bucket=pad_bucket
        )
        C = idx.shape[0]
        idx_d = torch.from_numpy(idx.reshape(-1)).to(self.device)
        mask_d = torch.from_numpy(mask.reshape(-1)).to(self.device)
        x, y = _gather(self.flat_x, self.flat_y, idx_d, mask_d)
        return ClientBatch(
            x=x.reshape((C, steps, bs) + tuple(self.flat_x.shape[1:])),
            y=y.reshape((C, steps, bs) + tuple(self.flat_y.shape[1:])),
            mask=mask_d.reshape(C, steps, bs),
            num_samples=np.array(ns, dtype=np.float32),
        )
