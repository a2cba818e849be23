"""Client-level differential privacy (port of ``fedml_tpu/privacy/``):
DP-FedAvg (clip, then calibrated Gaussian noise on the fixed-denominator
cohort mean) and the Rényi-DP accountant that reports (epsilon, delta)."""

from fedml_tpu_torch.privacy.accountant import RdpAccountant, rdp_subsampled_gaussian  # noqa: F401
from fedml_tpu_torch.privacy.dp_fedavg import DpConfig, DPFedAvgAPI, make_dp_hooks  # noqa: F401
