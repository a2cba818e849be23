"""Round-level checkpoints (port of ``fedml_tpu/utils/checkpoint.py``), in
the reference's file format, so ``python -m fedml_tpu`` and
``python -m fedml_tpu_torch`` resume from each other's checkpoints.

Format: one ``<path>.npz`` of flattened (path → array) leaves — the
model under ``vars/``, the server optimizer's state under ``opt/``, an
algorithm's own state under ``algo/``, the scheduler's under ``sched/`` —
and the metadata as JSON bytes under ``__meta__``, installed with
``os.replace``; then a ``<path>.json`` copy of the metadata for humans.
Dicts flatten by sorted key, lists and tuples to ``#0``, ``#1``, … plus
``#len``.

The trees are the reference's:

- ``vars`` holds ``{"params": <flax tree>}``, and a BatchNorm model's
  ``"batch_stats"`` beside it (``bridge.to_flax_variables``: conv kernels
  HWIO, dense kernels [in, out]), read back through ``bridge.from_flax``;
- ``opt`` holds optax's state layout, which the port's optimizers share
  (train/optim.py): NamedTuples as lists, ``count`` as an int32 scalar,
  an ``EmptyState`` as an empty list, and every per-parameter tree (Adam's
  ``mu`` and ``nu``, a momentum trace) as a flax tree;
- ``sched`` holds ``ClientScheduler.state_dict()``, already numpy."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from fedml_tpu_torch.bridge import from_flax, to_flax, to_flax_variables

_SEP = "/"


def _flatten(prefix: str, node, out: Dict[str, np.ndarray]) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _flatten(f"{prefix}{_SEP}{k}" if prefix else str(k), node[k], out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(f"{prefix}{_SEP}#{i}", v, out)
        out[f"{prefix}{_SEP}#len"] = np.asarray(len(node))
    else:
        out[prefix] = np.asarray(node)


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = val

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if "#len" in node:
            return [rebuild(node[f"#{i}"]) for i in range(int(node["#len"]))]
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def _is_variables(node) -> bool:
    return isinstance(node, dict) and bool(node) and all(
        isinstance(v, torch.Tensor) for v in node.values()
    )


def _to_reference(node):
    """A port state → the reference's tree: tuples as lists, port
    variables as flax trees, Python ints (optax's step counts) as int32."""
    if isinstance(node, tuple):
        return [_to_reference(v) for v in node]
    if _is_variables(node):
        return to_flax(node)
    if isinstance(node, dict):
        return {k: _to_reference(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_reference(v) for v in node]
    if isinstance(node, torch.Tensor):
        return node.detach().cpu().numpy()
    if isinstance(node, (bool, int)) and not isinstance(node, np.generic):
        return np.int32(node)
    return node


def _is_writer() -> bool:
    """Rank 0 writes where torch.distributed is initialized (the processes
    hold the same state); a lone process always writes."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def save_checkpoint(
    path: str,
    global_vars: Dict[str, torch.Tensor],
    round_idx: int,
    server_opt_state=None,
    sched_state=None,
    algo_state=None,
    extra_meta=None,
) -> None:
    """Write ``<path>.npz`` atomically (a per-process temporary file moved
    into place with ``os.replace``, the metadata inside it), then the
    ``<path>.json`` sidecar. ``global_vars`` are port variables;
    ``algo_state`` an algorithm's own state (DP-FedAvg's
    ``checkpoint_state()``: numpy arrays); ``extra_meta`` JSON values
    merged into the metadata (FedSeg's ``best_miou``). The reference's
    ``rng`` slot stays empty: the port's round keys derive from the seed."""
    if not _is_writer():
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat: Dict[str, np.ndarray] = {}
    _flatten("vars", to_flax_variables(global_vars), flat)
    if server_opt_state is not None:
        _flatten("opt", _to_reference(server_opt_state), flat)
    if algo_state is not None:
        _flatten("algo", _to_reference(algo_state), flat)
    if sched_state is not None:
        _flatten("sched", _to_reference(sched_state), flat)
    meta = {
        "round_idx": int(round_idx),
        "has_opt": server_opt_state is not None,
        "has_algo": algo_state is not None,
        "has_sched": sched_state is not None,
    }
    meta.update(extra_meta or {})
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path + ".npz")
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], int, Any, Any, Any, Any]:
    """Returns (global_vars, round_idx, rng, server_opt_state, algo_state,
    sched_state). ``global_vars`` are port variables (CPU tensors) read
    through ``bridge.from_flax``; the other slots are the raw trees (nested
    dicts and lists of numpy arrays) for :func:`restore_like`, or None
    where the checkpoint has none."""
    with np.load(path + ".npz") as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(flat.pop("__meta__").tobytes().decode("utf-8"))
    rng = flat.pop("rng", None)

    def slot(name):
        pre = name + _SEP
        return _unflatten({k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)})

    variables = slot("vars")
    if set(variables) not in ({"params"}, {"params", "batch_stats"}):
        raise ValueError(
            f"checkpoint vars hold {sorted(variables)}; the port's models have 'params' "
            "and, with BatchNorm, 'batch_stats'"
        )
    global_vars = from_flax(variables)
    opt_state = slot("opt") if meta.get("has_opt") else None
    algo_state = slot("algo") if meta.get("has_algo") else None
    sched_state = slot("sched") if meta.get("has_sched") else None
    return global_vars, meta["round_idx"], rng, opt_state, algo_state, sched_state


def restore_like(template, loaded):
    """Pour ``loaded`` into ``template``'s structure: NamedTuples and
    tuples from lists, port variables from flax trees (or from port
    variables), step counts as ints, each tensor on its template's device
    with its dtype."""
    if isinstance(template, tuple):
        if len(loaded) != len(template):
            raise ValueError(f"checkpoint has {len(loaded)} entries where the state has {len(template)}")
        items = [restore_like(t, v) for t, v in zip(template, loaded)]
        return type(template)(*items) if hasattr(template, "_fields") else tuple(items)
    if _is_variables(template):
        src = loaded if _is_variables(loaded) else from_flax(loaded)
        if src.keys() != template.keys():
            raise ValueError(
                f"checkpoint variables {sorted(src)} do not match the model's {sorted(template)}"
            )
        return {k: src[k].to(device=t.device, dtype=t.dtype) for k, t in template.items()}
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(np.asarray(loaded)).to(device=template.device, dtype=template.dtype)
    if isinstance(template, int):
        return int(loaded)
    return loaded
