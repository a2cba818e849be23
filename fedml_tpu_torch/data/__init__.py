"""Federated data containers, the device store, the synthetic datasets, the
LEAF and TFF-h5 file loaders and the registry that names them (port of
``fedml_tpu/data/``; the CIFAR, StackOverflow, ImageNet and Landmarks
loaders and the segmentation data are still to port, ROADMAP.md)."""

from fedml_tpu_torch.data.base import (  # noqa: F401
    ClientBatch,
    FederatedDataset,
    bucket_steps,
    pad_clients_to,
    size_class,
    stack_clients,
)
