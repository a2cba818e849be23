"""Federated algorithms (port of ``fedml_tpu/algorithms/``: FedAvg,
FedAvg-robust, FedOpt, FedNova, q-FedAvg, hierarchical FedAvg, SCAFFOLD and
Ditto with the per-client state store, decentralized DSGD/push-sum and the
base framework; the cross-silo transport form of FedAvg imports from
``fedml_tpu_torch.algorithms.fedavg_transport``, the async buffered
federation FedBuff from ``fedml_tpu_torch.algorithms.fedbuff``)."""

from fedml_tpu_torch.algorithms.ditto import DittoAPI  # noqa: F401
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI  # noqa: F401
from fedml_tpu_torch.algorithms.fedavg_robust import RobustFedAvgAPI  # noqa: F401
from fedml_tpu_torch.algorithms.fednova import FedNovaAPI  # noqa: F401
from fedml_tpu_torch.algorithms.fedopt import FedOptAPI, make_server_optimizer  # noqa: F401
from fedml_tpu_torch.algorithms.hierarchical import HierarchicalFedAvgAPI  # noqa: F401
from fedml_tpu_torch.algorithms.qfedavg import QFedAvgAPI  # noqa: F401
from fedml_tpu_torch.algorithms.scaffold import ScaffoldAPI  # noqa: F401
