"""Pretrained weights: the torch-checkpoint import and export of the
ResNet zoo and the ``save_pretrained`` npz recipe (port of
``fedml_tpu/models/pretrained.py``).

The reference's torch ResNet names its state dict ``layer1.0.conv1.weight``,
``downsample.0`` (the shortcut's conv) / ``downsample.1`` (its BatchNorm),
``bn1.weight``/``bn1.bias`` and ``bn1.running_mean``/``running_var``; the
reference's flax variables (and so the port's, through
fedml_tpu_torch/bridge.py) name them ``layer1_block0/conv1/kernel``,
``downsample_conv``, ``downsample_bn``, ``scale``/``bias`` and
``batch_stats/…/mean``/``var``. Both files hold the reference's layouts: a
``.pth`` torch's (OIHW, [out, in]), an npz flax's (HWIO, [in, out]) under
``/``-joined paths such as ``params/conv1/kernel``. Every function here
goes through the flax tree, so a file either package writes loads in the
other byte for byte."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from fedml_tpu_torch.bridge import from_flax, to_flax_variables

Variables = Dict[str, torch.Tensor]


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flax_path_to_torch_key(path: Tuple[str, ...]) -> str:
    """('params','layer1_block0','conv1','kernel') → 'layer1.0.conv1.weight'."""
    collection, *mods, leaf = path
    parts = []
    for m in mods:
        if m.startswith("layer") and "_block" in m:
            stage, block = m.split("_block")
            parts += [stage, block]
        elif m == "downsample_conv":
            parts += ["downsample", "0"]
        elif m == "downsample_bn":
            parts += ["downsample", "1"]
        else:
            parts.append(m)
    if collection == "batch_stats":
        leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
    else:
        leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
    return ".".join(parts + [leaf])


def _leaf_kind(path: Tuple[str, ...], arr: np.ndarray) -> str:
    if path[-1] == "kernel":
        return "conv" if arr.ndim == 4 else "linear"
    return "other"


def _iter_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _iter_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _map_template(tree, convert, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_template(v, convert, prefix + (k,)) for k, v in tree.items()}
    return convert(prefix, np.asarray(tree))


def import_torch_state_dict(state_dict: Dict[str, object], template: Variables) -> Variables:
    """Pour a torch state dict into port variables shaped like ``template``
    (``model.init(...)``). Strips the DataParallel ``module.`` prefix as the
    reference does; raises KeyError or ValueError on a missing key or a
    shape that differs — a silent partial load is worse than failing."""
    sd = {
        (k[len("module."):] if k.startswith("module.") else k): _to_numpy(v)
        for k, v in state_dict.items()
    }

    def convert(path, tmpl):
        key = _flax_path_to_torch_key(path)
        if key not in sd:
            raise KeyError(f"torch checkpoint is missing {key!r} (flax {'/'.join(path)})")
        arr = sd[key]
        kind = _leaf_kind(path, tmpl)
        if kind == "conv":
            arr = arr.transpose(2, 3, 1, 0)  # OIHW → HWIO
        elif kind == "linear":
            arr = arr.transpose(1, 0)
        if arr.shape != tmpl.shape:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != model {tmpl.shape}")
        return arr.astype(tmpl.dtype)

    return from_flax(_map_template(to_flax_variables(template), convert))


def export_torch_state_dict(variables: Variables) -> Dict[str, np.ndarray]:
    """The inverse of :func:`import_torch_state_dict`: port variables → a
    state dict in the reference torch ResNet's names (numpy values)."""
    out = {}
    for path, arr in _iter_leaves(to_flax_variables(variables)):
        key = _flax_path_to_torch_key(path)
        kind = _leaf_kind(path, arr)
        if kind == "conv":
            arr = arr.transpose(3, 2, 0, 1)  # HWIO → OIHW
        elif kind == "linear":
            arr = arr.transpose(1, 0)
        out[key] = np.ascontiguousarray(arr)
    return out


def load_torch_checkpoint(path: str, template: Variables) -> Variables:
    """Load a reference-format ``.pth`` (``torch.save`` of
    ``{'state_dict': ...}`` or a bare state dict) into port variables."""
    # weights_only: such checkpoints are tensor dicts; never run a
    # downloaded file's pickle
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return import_torch_state_dict(state_dict, template)


def save_pretrained(path: str, variables: Variables) -> None:
    """The train-and-save recipe: a flat npz of the flax variables tree."""
    flat = {"/".join(p): a for p, a in _iter_leaves(to_flax_variables(variables))}
    np.savez(path, **flat)


def load_pretrained(path: str, template: Variables) -> Variables:
    """Load a :func:`save_pretrained` npz (either package's) into port
    variables shaped like ``template``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}

    def convert(prefix, tmpl):
        key = "/".join(prefix)
        if key not in flat:
            raise KeyError(f"pretrained file is missing {key!r}")
        arr = flat[key]
        if arr.shape != tmpl.shape:
            raise ValueError(f"{key}: saved shape {arr.shape} != model {tmpl.shape}")
        return arr.astype(tmpl.dtype)

    return from_flax(_map_template(to_flax_variables(template), convert))
