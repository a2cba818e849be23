"""Federated algorithms (port of ``fedml_tpu/algorithms/``: FedAvg and
FedAvg-robust so far)."""

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI  # noqa: F401
from fedml_tpu_torch.algorithms.fedavg_robust import RobustFedAvgAPI  # noqa: F401
