"""Partitioners and topologies (port of ``fedml_tpu/partition/``: the
Dirichlet label-skew partition, and the decentralized runs' topology
managers)."""

from fedml_tpu_torch.partition.noniid import (  # noqa: F401
    homo_partition,
    lda_partition,
    partition_class_samples_with_dirichlet,
    record_data_stats,
)
from fedml_tpu_torch.partition.topology import (  # noqa: F401
    AsymmetricTopologyManager,
    BaseTopologyManager,
    SymmetricTopologyManager,
)
