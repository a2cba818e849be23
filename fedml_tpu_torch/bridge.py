"""flax params ⇄ port variables.

The reference's weights are a nested flax ``params`` dict
(``{layer: {"kernel", "bias"}}``); the port's are a flat ``{name: tensor}``
dict keyed like the module's ``state_dict`` (``layer.weight``,
``layer.bias``). The layouts differ by transposes only — the same ones
``fedml_tpu/models/pretrained.py`` applies to torch checkpoints:

- conv kernel: flax HWIO ⇄ torch OIHW;
- dense kernel: flax [in, out] ⇄ torch [out, in];
- biases unchanged.

Ported models keep the reference's flatten order (see models/cnn.py), so no
row permutation is needed and ``to_flax(from_flax(p))`` is exactly ``p``."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_FLAX_TO_TORCH = {"kernel": "weight", "bias": "bias"}
_TORCH_TO_FLAX = {v: k for k, v in _FLAX_TO_TORCH.items()}


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


def from_flax(params: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """Nested flax ``params`` (numpy leaves) → port variables (CPU tensors)."""
    state = {}
    for layer, leaves in params.items():
        for leaf, value in leaves.items():
            if leaf not in _FLAX_TO_TORCH:
                raise ValueError(f"unsupported flax leaf {layer}/{leaf}")
            a = np.asarray(value)
            if leaf == "kernel":
                a = _kernel_to_torch(a)
            # a copy: the source may be read-only (a JAX array's view)
            state[f"{layer}.{_FLAX_TO_TORCH[leaf]}"] = torch.tensor(a)
    return state


def to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, np.ndarray]]:
    """Port variables → nested flax ``params`` with numpy leaves (the
    inverse of :func:`from_flax`)."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for name, t in state.items():
        layer, leaf = name.rsplit(".", 1)
        if leaf not in _TORCH_TO_FLAX:
            raise ValueError(f"unsupported variable {name}")
        a = t.detach().cpu().numpy()
        if leaf == "weight":
            a = _kernel_to_flax(a)
        params.setdefault(layer, {})[_TORCH_TO_FLAX[leaf]] = np.ascontiguousarray(a)
    return params
