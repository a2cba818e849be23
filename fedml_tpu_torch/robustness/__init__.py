"""Robust aggregation (port of ``fedml_tpu/robustness/``)."""

from fedml_tpu_torch.robustness.robust_aggregation import (  # noqa: F401
    RobustConfig,
    coordinate_median,
    make_byzantine_aggregate,
    norm_diff_clip_tree,
    trimmed_mean,
)
