"""flax params ⇄ port variables.

The reference's weights are a nested flax ``params`` dict
(``{scope: {... {leaf: array}}}``, with array leaves at any depth — the
LM's ``block0/ln1/scale`` or its top-level ``pos_embed``); the port's are a
flat ``{name: tensor}`` dict keyed like the module's ``state_dict``, the
scopes joined by dots. Leaves keep their names except the dense and conv
``kernel``, which is the port's ``weight``; the layouts differ by transposes
only — the same ones ``fedml_tpu/models/pretrained.py`` applies to torch
checkpoints:

- conv kernel: flax HWIO ⇄ torch OIHW;
- dense kernel: flax [in, out] ⇄ torch [out, in];
- biases, norm scales, embedding tables and ``pos_embed`` unchanged.

Ported models keep the reference's flatten order (see models/cnn.py), so no
row permutation is needed and ``to_flax(from_flax(p))`` is exactly ``p``."""

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


def from_flax(params: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """Nested flax ``params`` (numpy leaves) → port variables (CPU tensors)."""
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

    walk("", params)
    return state


def _sorted_keys(tree):
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    return tree


def to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """Port variables → nested flax ``params`` with numpy leaves (the
    inverse of :func:`from_flax`), keys sorted at every level as JAX's tree
    utilities leave a reference model — the order its wire header lists
    them in."""
    params: Dict[str, object] = {}
    for name, t in state.items():
        *scopes, leaf = name.split(".")
        a = t.detach().cpu().numpy()
        if leaf == "weight":
            a, leaf = _kernel_to_flax(a), "kernel"
        node = params
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = np.ascontiguousarray(a)
    return _sorted_keys(params)
