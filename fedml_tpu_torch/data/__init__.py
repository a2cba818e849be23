"""Federated data containers, the device store, the FEMNIST-geometry
synthetic dataset and the synthetic Shakespeare LM data (port of
``fedml_tpu/data/``; other loaders are still to port, ROADMAP.md)."""

from fedml_tpu_torch.data.base import (  # noqa: F401
    ClientBatch,
    FederatedDataset,
    bucket_steps,
    size_class,
    stack_clients,
)
