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
``to_flax_variables(from_flax(v))`` is ``v`` for a whole variables tree."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _kernel_to_torch(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if a.ndim == 2:
        return a.T
    raise ValueError(f"unsupported kernel rank {a.ndim}")


def _kernel_to_flax(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if a.ndim == 2:
        return a.T
    raise ValueError(f"unsupported kernel rank {a.ndim}")


_COLLECTIONS = ("params", "batch_stats")
_STATS = "batch_stats."


def _is_variables(tree) -> bool:
    """A whole variables tree (``{"params": …[, "batch_stats": …]}``) rather
    than a params tree."""
    return "params" in tree and all(k in _COLLECTIONS for k in tree)


def from_flax(tree: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """A flax ``params`` tree, or a whole variables tree with its
    ``batch_stats``, (numpy leaves) → port variables (CPU tensors)."""
    if _is_variables(tree):
        state = from_flax(tree["params"])
        state.update({_STATS + k: v for k, v in from_flax(tree.get("batch_stats", {})).items()})
        return state
    state = {}

    def walk(prefix: str, tree) -> None:
        for key, value in tree.items():
            if hasattr(value, "items"):  # a scope (dict or FrozenDict)
                walk(f"{prefix}{key}.", value)
                continue
            a = np.asarray(value)
            if key == "kernel":
                a, key = _kernel_to_torch(a), "weight"
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


def _nest(state: Dict[str, torch.Tensor], kernels: bool) -> Dict[str, object]:
    tree: Dict[str, object] = {}
    for name, t in state.items():
        *scopes, leaf = name.split(".")
        a = t.detach().cpu().numpy()
        if kernels and leaf == "weight":
            a, leaf = _kernel_to_flax(a), "kernel"
        node = tree
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = np.ascontiguousarray(a)
    return _sorted_keys(tree)


def to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """Port parameters → nested flax ``params`` with numpy leaves (the
    inverse of :func:`from_flax` on a params tree), keys sorted at every
    level as JAX's tree utilities leave a reference model — the order its
    wire header lists them in. A model's running statistics are not
    parameters: :func:`to_flax_variables` carries them."""
    stats = [k for k in state if k.startswith(_STATS)]
    if stats:
        raise ValueError(f"{len(stats)} running statistics ({stats[0]}, …): use to_flax_variables")
    return _nest(state, kernels=True)


def to_flax_variables(state: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """Port variables → the whole flax variables tree,
    ``{"batch_stats": …, "params": …}`` (``batch_stats`` only for a model
    that has them), keys sorted at every level: the inverse of
    :func:`from_flax`, and the tree a reference model's ``init`` gives."""
    params = {k: v for k, v in state.items() if not k.startswith(_STATS)}
    stats = {k[len(_STATS):]: v for k, v in state.items() if k.startswith(_STATS)}
    out = {"params": _nest(params, kernels=True)}
    if stats:
        out["batch_stats"] = _nest(stats, kernels=False)
    return _sorted_keys(out)
