"""Robust aggregation defenses (port of
``fedml_tpu/robustness/robust_aggregation.py``).

Ported: norm-difference clipping and the coordinate-wise Byzantine
aggregators (median, trimmed mean), which run on kernel K1
(ops/robust_stats.py) — once per weight leaf per round. Weak-DP noise and
Krum / Multi-Krum are still to port (ROADMAP.md) and raise.

Trees here are ``{name: tensor}`` dicts; a stacked tree carries a leading
client axis on every leaf."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from fedml_tpu_torch.ops.robust_stats import median_1d, trimmed_mean_1d

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Copy of the reference's RobustConfig: the defense and its knobs."""

    # "norm_diff_clipping" | "weak_dp" | "no_defense"
    # | "median" | "trimmed_mean" | "krum" | "multi_krum"
    defense_type: str = "norm_diff_clipping"
    norm_bound: float = 5.0
    stddev: float = 0.025
    # trimmed_mean: drop this many highest+lowest per coordinate;
    # krum/multi_krum: assumed number of Byzantine clients
    num_byzantine: int = 1
    # multi_krum: average the m best-scored clients
    multi_krum_m: int = 3


BYZANTINE_AGGREGATORS = ("median", "trimmed_mean", "krum", "multi_krum")
CLIP_DEFENSES = ("norm_diff_clipping", "weak_dp", "no_defense")


def _is_weight_leaf(name: str) -> bool:
    """Non-parameter statistics (the reference's ``batch_stats``
    collection) are excluded from clipping and from order statistics."""
    return "batch_stats" not in name


def tree_weight_norm(tree: Tree, ref_tree: Tree = None) -> torch.Tensor:
    """L2 norm over weight leaves of (tree − ref_tree)."""
    total = 0.0
    for name, leaf in tree.items():
        if not _is_weight_leaf(name):
            continue
        d = leaf - ref_tree[name] if ref_tree is not None else leaf
        total = total + torch.sum(torch.square(d.float()))
    return torch.sqrt(total)


def norm_diff_clip_tree(local_tree: Tree, global_tree: Tree, norm_bound: float) -> Tree:
    """w_g + clip(w_l − w_g): scale the diff by min(1, bound/‖diff‖).
    Non-weight leaves pass through."""
    norm = tree_weight_norm(local_tree, global_tree)
    scale = torch.clamp(norm_bound / torch.clamp(norm, min=1e-12), max=1.0)
    return {
        name: global_tree[name] + (leaf - global_tree[name]) * scale
        if _is_weight_leaf(name)
        else leaf
        for name, leaf in local_tree.items()
    }


def coordinate_median(stacked_tree: Tree, num_samples=None) -> Tree:
    """Coordinate-wise median over the leading client axis (sample weights
    ignored by construction); non-weight leaves keep the weighted mean."""

    def reduce(v):
        C = v.shape[0]
        return median_1d(v.reshape(C, -1)).reshape(v.shape[1:])

    return _byzantine_reduce(stacked_tree, num_samples, reduce)


def trimmed_mean(stacked_tree: Tree, num_samples=None, trim_k: int = 1) -> Tree:
    """Per coordinate: drop the ``trim_k`` largest and smallest client
    values, average the rest (Yin et al. 2018)."""

    def reduce(v):
        C = v.shape[0]
        return trimmed_mean_1d(v.reshape(C, -1), trim_k).reshape(v.shape[1:])

    return _byzantine_reduce(stacked_tree, num_samples, reduce)


def _byzantine_reduce(stacked_tree: Tree, num_samples, reduce_fn) -> Tree:
    out = {}
    for name, v in stacked_tree.items():
        v = v.float()
        if _is_weight_leaf(name):
            out[name] = reduce_fn(v)
        elif num_samples is not None:
            w = num_samples / torch.clamp(torch.sum(num_samples), min=1e-12)
            out[name] = torch.tensordot(w, v, dims=1)
        else:
            out[name] = torch.mean(v, dim=0)
    return out


def make_byzantine_aggregate(robust: RobustConfig):
    """defense_type → ``aggregate_fn(stacked_client_vars, num_samples,
    global_vars=None)`` replacing the weighted average, or None for the
    clip defenses."""
    d = robust.defense_type
    if d in CLIP_DEFENSES:
        return None
    if d not in BYZANTINE_AGGREGATORS:
        raise ValueError(
            f"unknown defense_type {d!r}; expected one of "
            f"{BYZANTINE_AGGREGATORS + CLIP_DEFENSES}"
        )
    if robust.num_byzantine < 0:
        raise ValueError(f"num_byzantine must be >= 0; got {robust.num_byzantine}")
    if d in ("krum", "multi_krum"):
        raise NotImplementedError(
            f"defense_type {d!r} is not ported yet (ROADMAP.md); the port has "
            "median, trimmed_mean, norm_diff_clipping and no_defense"
        )
    if d == "median":
        return lambda cv, ns, g=None: coordinate_median(cv, ns)
    return lambda cv, ns, g=None: trimmed_mean(cv, ns, trim_k=robust.num_byzantine)
