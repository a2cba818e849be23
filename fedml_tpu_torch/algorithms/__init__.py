"""Federated algorithms (port of ``fedml_tpu/algorithms/``: FedAvg,
FedAvg-robust and FedOpt so far; the cross-silo transport form of FedAvg
imports from ``fedml_tpu_torch.algorithms.fedavg_transport``)."""

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI  # noqa: F401
from fedml_tpu_torch.algorithms.fedavg_robust import RobustFedAvgAPI  # noqa: F401
from fedml_tpu_torch.algorithms.fedopt import FedOptAPI, make_server_optimizer  # noqa: F401
