"""Robust aggregation defenses (port of
``fedml_tpu/robustness/robust_aggregation.py``).

Norm-difference clipping, weak-DP Gaussian noise, the coordinate-wise
Byzantine aggregators (median, trimmed mean), which run on kernel K1
(ops/robust_stats.py) once per weight leaf per round, and Krum /
Multi-Krum, whose pairwise distances come from one Gram product of the
[C, D] client matrix in full float32.

Trees here are ``{name: tensor}`` dicts; a stacked tree carries a leading
client axis on every leaf."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from fedml_tpu_torch.device import fp32_math
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


def _client_matrix(stacked_tree: Tree) -> torch.Tensor:
    """[C, D]: each client's weight leaves, flattened and concatenated."""
    return torch.cat(
        [v.float().reshape(v.shape[0], -1) for name, v in stacked_tree.items()
         if _is_weight_leaf(name)],
        dim=1,
    )


def krum_scores(stacked_tree: Tree, num_byzantine: int) -> torch.Tensor:
    """Krum scores (Blanchard et al. 2017), [C]: for each client, the sum
    of its C − f − 2 smallest squared distances to the other clients, from
    the Gram form ||x_i − x_j||² = n_i + n_j − 2·x_i·x_j. The product runs
    in full float32: TF32 would move the distances enough to change which
    client wins."""
    X = _client_matrix(stacked_tree)
    C = X.shape[0]
    # the admissibility regime C >= 2f + 3: with f a majority the
    # colluders' mutual distances are 0 and Krum picks one of them
    if num_byzantine < 0 or 2 * num_byzantine + 3 > C:
        raise ValueError(
            f"krum needs 0 <= byzantine <= (clients − 3)/2; got C={C}, f={num_byzantine}"
        )
    with fp32_math():
        gram = X @ X.T
    n = torch.sum(torch.square(X), dim=1)
    sq = n[:, None] + n[None, :] - 2.0 * gram
    # a client's distance to itself is left out
    sq = torch.clamp(sq, min=0.0) + torch.diag(torch.full((C,), float("inf"), device=X.device))
    closest = C - num_byzantine - 2
    return torch.sum(torch.sort(sq, dim=1).values[:, :closest], dim=1)


def krum_select(stacked_tree: Tree, num_byzantine: int, m: int = 1) -> torch.Tensor:
    """The indices of the ``m`` best-scored clients ([m] int64, best
    first; ties keep the lower index)."""
    scores = krum_scores(stacked_tree, num_byzantine)
    C = scores.shape[0]
    if not 1 <= m <= C - num_byzantine - 2:
        raise ValueError(
            f"multi-krum needs 1 <= m <= clients − byzantine − 2 "
            f"(Blanchard et al.); got m={m}, C={C}, f={num_byzantine}"
        )
    return torch.argsort(scores, stable=True)[:m]


def krum_aggregate(stacked_tree: Tree, num_byzantine: int, m: int = 1) -> Tree:
    """Krum (m = 1) / Multi-Krum (m > 1): the unweighted mean of the
    selected clients over every leaf, running statistics included."""
    sel = krum_select(stacked_tree, num_byzantine, m)
    return {
        name: torch.mean(torch.index_select(v.float(), 0, sel.to(v.device)), dim=0)
        for name, v in stacked_tree.items()
    }


def make_byzantine_aggregate(robust: RobustConfig):
    """defense_type → ``aggregate_fn(stacked_client_vars, num_samples,
    global_vars=None)`` replacing the weighted average, or None for the
    clip/noise defenses."""
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
    f = robust.num_byzantine
    aggregates = {
        "median": lambda cv, ns, g=None: coordinate_median(cv, ns),
        "trimmed_mean": lambda cv, ns, g=None: trimmed_mean(cv, ns, trim_k=f),
        "krum": lambda cv, ns, g=None: krum_aggregate(cv, f, m=1),
        "multi_krum": lambda cv, ns, g=None: krum_aggregate(cv, f, m=robust.multi_krum_m),
    }
    return aggregates[d]


def add_gaussian_noise(tree: Tree, draw, stddev: float) -> Tree:
    """Weak-DP noise on the weight leaves: ``leaf + z·stddev``, where
    ``draw(names, shapes)`` gives one standard-normal tensor for EVERY
    leaf of the tree, in its order (the statistics' draws go unused, as the
    reference splits its key over every leaf)."""
    names = list(tree)
    noise = draw(names, [tuple(tree[k].shape) for k in names])
    return {
        name: tree[name] + z.to(tree[name].device) * stddev if _is_weight_leaf(name) else tree[name]
        for name, z in zip(names, noise)
    }
