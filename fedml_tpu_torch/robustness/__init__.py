"""Robust aggregation and the backdoor harness (port of
``fedml_tpu/robustness/``; the harness imports from
``fedml_tpu_torch.robustness.backdoor``)."""

from fedml_tpu_torch.robustness.robust_aggregation import (  # noqa: F401
    BYZANTINE_AGGREGATORS,
    CLIP_DEFENSES,
    RobustConfig,
    add_gaussian_noise,
    coordinate_median,
    krum_aggregate,
    krum_scores,
    krum_select,
    make_byzantine_aggregate,
    norm_diff_clip_tree,
    tree_weight_norm,
    trimmed_mean,
)
