"""flax variables ⇄ port variables.

The reference's weights are a nested flax ``params`` dict
(``{scope: {... {leaf: array}}}``, with array leaves at any depth — the
LM's ``block0/ln1/scale`` or its top-level ``pos_embed``); a BatchNorm
model's variables add a ``batch_stats`` collection beside it (leaves
``mean``/``var``). The port's are a flat ``{name: tensor}`` dict keyed like
the module's ``state_dict``, the scopes joined by dots, the running
statistics under ``batch_stats.`` + their path (models/__init__.py).
Leaves keep their names except the dense and conv ``kernel``, which is
the port's ``weight``; the layouts differ by transposes only — the same
ones ``fedml_tpu/models/pretrained.py`` applies to torch checkpoints:

- conv kernel: flax HWIO ⇄ torch OIHW (a depthwise kernel's I is 1 on both
  sides);
- dense kernel: flax [in, out] ⇄ torch [out, in];
- biases, norm scales, running statistics, embedding tables and
  ``pos_embed`` unchanged.

Ported models keep the reference's flatten order (see models/cnn.py), so no
row permutation is needed and both directions are exact:
``to_flax(from_flax(p))`` is ``p`` for a params tree and
``to_flax_variables(from_flax(v))`` is ``v`` for a whole variables tree.
``lead`` counts leading axes that stack one tree per client (SCAFFOLD's
control variates, Ditto's personal models): the transposes act on the
trailing dims only. :func:`flax_leaves` and :func:`flax_unflatten` give a
nested tree's leaves in ``jax.tree_util`` order (keys sorted at every
level), the order the reference's checkpoints number them in."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _transpose_kernel(a: np.ndarray, lead: int, to_torch: bool) -> np.ndarray:
    """A kernel between the two layouts, its ``lead`` leading axes kept."""
    rank = a.ndim - lead
    if rank == 4:
        tail = (3, 2, 0, 1) if to_torch else (2, 3, 1, 0)  # HWIO <-> OIHW
    elif rank == 2:
        tail = (1, 0)
    else:
        raise ValueError(f"unsupported kernel rank {rank}")
    return a.transpose(tuple(range(lead)) + tuple(lead + i for i in tail))


_COLLECTIONS = ("params", "batch_stats")
_STATS = "batch_stats."


def _is_variables(tree) -> bool:
    """A whole variables tree (``{"params": …[, "batch_stats": …]}``) rather
    than a params tree."""
    return "params" in tree and all(k in _COLLECTIONS for k in tree)


def from_flax(tree: Dict[str, object], lead: int = 0) -> Dict[str, torch.Tensor]:
    """A flax ``params`` tree, or a whole variables tree with its
    ``batch_stats``, (numpy leaves) → port variables (CPU tensors)."""
    if _is_variables(tree):
        state = from_flax(tree["params"], lead)
        state.update({_STATS + k: v for k, v in from_flax(tree.get("batch_stats", {}), lead).items()})
        return state
    state = {}

    def walk(prefix: str, tree) -> None:
        for key, value in tree.items():
            if hasattr(value, "items"):  # a scope (dict or FrozenDict)
                walk(f"{prefix}{key}.", value)
                continue
            a = np.asarray(value)
            if key == "kernel":
                a, key = _transpose_kernel(a, lead, to_torch=True), "weight"
            # a contiguous copy: the source may be read-only (a JAX array's
            # view), and a kernel's transposed view would hand the layers
            # strided weights (other kernels, other summation orders)
            state[prefix + key] = torch.tensor(np.ascontiguousarray(a))

    walk("", tree)
    return state


def _sorted_keys(tree):
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    return tree


def _nest(state: Dict[str, torch.Tensor], kernels: bool, lead: int = 0) -> Dict[str, object]:
    tree: Dict[str, object] = {}
    for name, t in state.items():
        *scopes, leaf = name.split(".")
        a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        if kernels and leaf == "weight":
            a, leaf = _transpose_kernel(a, lead, to_torch=False), "kernel"
        node = tree
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = np.ascontiguousarray(a)
    return _sorted_keys(tree)


def to_flax(state: Dict[str, torch.Tensor], lead: int = 0) -> Dict[str, object]:
    """Port parameters → nested flax ``params`` with numpy leaves (the
    inverse of :func:`from_flax` on a params tree), keys sorted at every
    level as JAX's tree utilities leave a reference model — the order its
    wire header lists them in. A model's running statistics are not
    parameters: :func:`to_flax_variables` carries them."""
    stats = [k for k in state if k.startswith(_STATS)]
    if stats:
        raise ValueError(f"{len(stats)} running statistics ({stats[0]}, …): use to_flax_variables")
    return _nest(state, kernels=True, lead=lead)


def to_flax_variables(state: Dict[str, torch.Tensor], lead: int = 0) -> Dict[str, object]:
    """Port variables → the whole flax variables tree,
    ``{"batch_stats": …, "params": …}`` (``batch_stats`` only for a model
    that has them), keys sorted at every level: the inverse of
    :func:`from_flax`, and the tree a reference model's ``init`` gives."""
    params = {k: v for k, v in state.items() if not k.startswith(_STATS)}
    stats = {k[len(_STATS):]: v for k, v in state.items() if k.startswith(_STATS)}
    out = {"params": _nest(params, kernels=True, lead=lead)}
    if stats:
        out["batch_stats"] = _nest(stats, kernels=False, lead=lead)
    return _sorted_keys(out)


def flax_leaves(tree) -> list:
    """A nested tree's leaves in ``jax.tree_util`` order (sorted keys)."""
    if hasattr(tree, "items"):
        return [leaf for k in sorted(tree) for leaf in flax_leaves(tree[k])]
    return [tree]


def flax_unflatten(template, leaves) -> Dict[str, object]:
    """The inverse of :func:`flax_leaves` on ``template``'s structure."""
    it = iter(leaves)

    def build(node):
        if hasattr(node, "items"):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(template)


# The split-learning cut and the vertical-FL parties hold their weights in
# groups. SplitNN's reference tree is {"bottom": params, "top": params}; a VFL
# party's is {"extractor": {"params": {"fc": …}}, "dense": {"params": …}},
# the port's a flat dict with ``extractor.``/``dense.`` names
# (models/vfl.py). The optimizers' momentum traces have their parameters'
# layout and cross the same way.


def split_from_flax(tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"bottom", "top"}`` flax trees → the port's per-group variables."""
    return {g: from_flax(tree[g]) for g in ("bottom", "top")}


def split_to_flax(groups) -> Dict[str, object]:
    """The inverse of :func:`split_from_flax`."""
    return {g: to_flax(groups[g]) for g in ("bottom", "top")}


_PARTY_PARTS = ("dense", "extractor")


def party_from_flax(tree) -> Dict[str, torch.Tensor]:
    """A VFL party's flax tree → its flat port dict."""
    return {f"{part}.{k}": v for part in _PARTY_PARTS for k, v in from_flax(tree[part]).items()}


def party_to_flax(params: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """The inverse of :func:`party_from_flax`."""
    return {part: to_flax_variables({k[len(part) + 1:]: v for k, v in params.items()
                                     if k.startswith(part + ".")})
            for part in _PARTY_PARTS}
