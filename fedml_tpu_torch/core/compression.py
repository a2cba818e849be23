"""Uplink (and int8 downlink) update compression for the cross-silo
transport (port of ``fedml_tpu/core/compression.py``, numpy only).

The client encodes the round DELTA ``w_local − w_round`` (both sides hold
``w_round``: the server just broadcast it) and the server reconstructs
``w_round + decode(payload)`` before the weighted average. Codecs are pure
numpy on flat per-leaf arrays; payloads are dicts of numpy arrays, so they
ride the binary Message envelope unchanged.

- ``int8``: per-tensor symmetric linear quantization — payload int8 +
  one fp32 scale per leaf;
- ``int4``: symmetric quantization to 4-bit levels [-7, 7], two values per
  byte (even index → low nibble), one fp32 scale per leaf;
- ``topk``: the top ``frac`` fraction of entries by magnitude per leaf —
  (int32 indices, fp32 values);
- ``topk8``: top-k with int8-quantized values — (int32 indices, int8
  values, fp32 scale).

Payloads name leaves ``q{i}``/``s{i}``/``i{i}``/``v{i}`` by their index in
the tree's leaf order, so that order must be ``jax.tree_util.tree_flatten``'s
— depth first, dict keys sorted — or a payload decodes against the wrong
leaves of a reference peer's template. :func:`tree_flatten` is that order.
The trees here are the reference's flax layout (``bridge.to_flax``), so a
port payload is byte-identical to a reference payload of the same update.

Opt-in cross-round error feedback lives in :class:`ErrorFeedback`
(CommConfig.error_feedback).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np


class _Leaf:
    """The leaf marker of a tree structure."""


_LEAF = _Leaf()


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, structure) of a tree of dicts, lists and tuples in
    ``jax.tree_util.tree_flatten``'s order: depth first, dict keys sorted;
    ``None`` is an empty subtree."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        if node is None:
            return None
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(structure, leaves) -> Any:
    """Inverse of :func:`tree_flatten` (dicts come back with sorted keys,
    as from JAX)."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(fill(x) for x in node)
        if node is None:
            return None
        return next(it)

    return fill(structure)


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    leaves, structure = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(structure, [fn(*xs) for xs in zip(leaves, *others)])


def _leaves(tree) -> Tuple[list, object]:
    leaves, structure = tree_flatten(tree)
    return [np.asarray(l) for l in leaves], structure


def delta_tree(new, ref):
    return tree_map(
        lambda a, b: np.asarray(a, np.float32) - np.asarray(b, np.float32),
        new,
        ref,
    )


def add_tree(ref, delta):
    return tree_map(
        lambda b, d: (np.asarray(b, np.float32) + d).astype(np.asarray(b).dtype),
        ref,
        delta,
    )


def encode_int8(tree) -> Dict[str, np.ndarray]:
    """Per-leaf symmetric linear quantization to int8 (q = round(x/s),
    s = max|x|/127). Exact zeros stay exact; max abs error s/2."""
    leaves, _ = _leaves(tree)
    payload: Dict[str, np.ndarray] = {"n": np.int32(len(leaves))}
    for i, a in enumerate(leaves):
        a = a.astype(np.float32)
        scale = float(np.max(np.abs(a))) / 127.0 if a.size else 0.0
        q = (
            np.zeros(a.shape, np.int8)
            if scale == 0.0
            else np.clip(np.round(a / scale), -127, 127).astype(np.int8)
        )
        payload[f"q{i}"] = q
        payload[f"s{i}"] = np.float32(scale)
    return payload


def encode_int4(tree) -> Dict[str, np.ndarray]:
    """Per-leaf symmetric quantization to 4-bit [-7, 7], nibble-packed —
    two quantized values per uint8 byte (even index → low nibble). Odd
    sizes pad the last byte's high nibble with 0; the decoder reads the
    true element count from the template, so the pad never leaks."""
    leaves, _ = _leaves(tree)
    payload: Dict[str, np.ndarray] = {"n": np.int32(len(leaves))}
    for i, a in enumerate(leaves):
        flat = a.astype(np.float32).reshape(-1)
        scale = float(np.max(np.abs(flat))) / 7.0 if flat.size else 0.0
        if scale == 0.0:
            q = np.zeros(flat.size, np.int8)
        else:
            q = np.clip(np.round(flat / scale), -7, 7).astype(np.int8)
        if q.size % 2:
            q = np.concatenate([q, np.zeros(1, np.int8)])
        # biased to [0, 14] so both nibbles pack into one unsigned byte
        u = (q + 7).astype(np.uint8)
        payload[f"q{i}"] = (u[0::2] | (u[1::2] << 4)).astype(np.uint8)
        payload[f"s{i}"] = np.float32(scale)
    return payload


def decode_int4(payload: Dict[str, np.ndarray], template) -> object:
    leaves, treedef = _leaves(template)
    _check_leaf_count(payload, leaves)
    out = []
    for i, a in enumerate(leaves):
        packed = np.asarray(payload[f"q{i}"])
        s = float(payload[f"s{i}"])
        u = np.empty(packed.size * 2, np.uint8)
        u[0::2] = packed & 0x0F
        u[1::2] = packed >> 4
        q = u[: a.size].astype(np.float32) - 7.0
        out.append((q * s).reshape(a.shape))
    return tree_unflatten(treedef, out)


def _topk_select(flat: np.ndarray, frac: float):
    """Shared index selection for the top-k family: the ceil(frac·n)
    largest-magnitude positions of a flat fp32 leaf, sorted, with the
    keep-everything fallback for tiny leaves. ONE definition so the
    plain and int8-valued encoders can never diverge on tie-breaking or
    k rounding (decoder compatibility rests on identical index sets)."""
    k = max(1, int(np.ceil(frac * flat.size))) if flat.size else 0
    if k and k < flat.size:
        return np.sort(np.argpartition(np.abs(flat), -k)[-k:].astype(np.int32))
    return np.arange(flat.size, dtype=np.int32)


def encode_topk_int8(tree, frac: float) -> Dict[str, np.ndarray]:
    """Top-k sparsification with int8-quantized values: the kept entries'
    magnitudes are already the leaf's largest, so one per-leaf scale over
    the KEPT values loses little — the value half of the payload shrinks
    4× on top of the sparsification."""
    leaves, _ = _leaves(tree)
    payload: Dict[str, np.ndarray] = {"n": np.int32(len(leaves))}
    for i, a in enumerate(leaves):
        flat = a.astype(np.float32).reshape(-1)
        idx = _topk_select(flat, frac)
        vals = flat[idx]
        scale = float(np.max(np.abs(vals))) / 127.0 if vals.size else 0.0
        q = (
            np.zeros(vals.shape, np.int8)
            if scale == 0.0
            else np.clip(np.round(vals / scale), -127, 127).astype(np.int8)
        )
        payload[f"i{i}"] = idx
        payload[f"v{i}"] = q
        payload[f"s{i}"] = np.float32(scale)
    return payload


def decode_topk_int8(payload: Dict[str, np.ndarray], template) -> object:
    leaves, treedef = _leaves(template)
    _check_leaf_count(payload, leaves)
    out = []
    for i, a in enumerate(leaves):
        flat = np.zeros(a.size, np.float32)
        s = float(payload[f"s{i}"])
        flat[np.asarray(payload[f"i{i}"])] = (
            np.asarray(payload[f"v{i}"]).astype(np.float32) * s
        )
        out.append(flat.reshape(a.shape))
    return tree_unflatten(treedef, out)


def _check_leaf_count(payload, leaves):
    n = int(payload["n"])
    if n != len(leaves):
        raise ValueError(
            f"compressed payload has {n} leaves but the decoding template "
            f"has {len(leaves)} — client/server model mismatch"
        )


def decode_int8(payload: Dict[str, np.ndarray], template) -> object:
    leaves, treedef = _leaves(template)
    _check_leaf_count(payload, leaves)
    out = []
    for i, a in enumerate(leaves):
        q = np.asarray(payload[f"q{i}"])
        s = float(payload[f"s{i}"])
        out.append((q.astype(np.float32) * s).reshape(a.shape))
    return tree_unflatten(treedef, out)


def encode_topk(tree, frac: float) -> Dict[str, np.ndarray]:
    """Keep the ceil(frac·n) largest-magnitude entries per leaf."""
    leaves, _ = _leaves(tree)
    payload: Dict[str, np.ndarray] = {"n": np.int32(len(leaves))}
    for i, a in enumerate(leaves):
        flat = a.astype(np.float32).reshape(-1)
        idx = _topk_select(flat, frac)
        payload[f"i{i}"] = idx
        payload[f"v{i}"] = flat[idx]
    return payload


def decode_topk(payload: Dict[str, np.ndarray], template) -> object:
    leaves, treedef = _leaves(template)
    _check_leaf_count(payload, leaves)
    out = []
    for i, a in enumerate(leaves):
        flat = np.zeros(a.size, np.float32)
        flat[np.asarray(payload[f"i{i}"])] = np.asarray(payload[f"v{i}"])
        out.append(flat.reshape(a.shape))
    return tree_unflatten(treedef, out)


# codec registry: method name -> (encode(delta, frac), decode(payload,
# template)). ONE definition shared by encode_update/decode_update and
# the error-feedback store, so a new codec cannot be wired into one side
# and silently dropped from the other.
CODECS: Dict[str, tuple] = {
    "int8": (lambda d, frac: encode_int8(d), decode_int8),
    "int4": (lambda d, frac: encode_int4(d), decode_int4),
    "topk": (encode_topk, decode_topk),
    "topk8": (encode_topk_int8, decode_topk_int8),
}


def encode_delta(delta, method: str, topk_frac: float = 0.01):
    """Compress an already-computed delta tree with ``method``."""
    if method not in CODECS:
        raise ValueError(f"unknown compression {method!r}")
    return CODECS[method][0](delta, topk_frac)


def decode_delta(payload, template, method: str):
    """Reconstruct a delta tree from its compressed payload."""
    if method not in CODECS:
        raise ValueError(f"unknown compression {method!r}")
    return CODECS[method][1](payload, template)


def encode_update(w_local, w_round, method: str, topk_frac: float = 0.01):
    """Client side: compress this round's update. Returns the payload tree."""
    return encode_delta(delta_tree(w_local, w_round), method, topk_frac)


def decode_update(payload, w_round, method: str):
    """Server side: reconstruct the client's model from the payload."""
    return add_tree(w_round, decode_delta(payload, w_round, method))


def payload_bytes(tree) -> int:
    """Wire payload size of a tree of numpy arrays (buffer bytes only)."""
    leaves, _ = _leaves(tree)
    return int(sum(a.nbytes for a in leaves))


# Lossy codecs whose per-round error is worth remembering (int8's grid is
# fine enough that one-shot encoding converges on its own, but the residual
# loop is still valid math for it).
EF_METHODS = ("topk", "topk8", "int4", "int8")


class ErrorFeedback:
    """Per-client residual memory for lossy uplink codecs (error-feedback
    / EF-SGD, Stich et al. 2018): whatever the codec drops this round —
    sparsified coordinates (top-k) or quantization error (int4/int8) —
    is remembered and added to the next round's delta, so every
    coordinate's contribution eventually reaches the server instead of
    being lost.

    Memory is keyed by CLIENT id (the data owner), not transport rank: the
    server re-points ranks at different sampled clients each round
    (ref FedAVGTrainer.update_dataset), and a residual must follow its
    client. Opt-in via CommConfig.error_feedback — the default one-shot
    encoding keeps the reference's stateless-client contract."""

    def __init__(self, frac: float, method: str = "topk"):
        if method not in EF_METHODS:
            raise ValueError(
                f"error feedback supports {EF_METHODS}; got {method!r}"
            )
        self.frac = frac
        self.method = method
        self._residual: Dict[int, object] = {}

    @classmethod
    def maybe_from_config(cls, comm) -> "ErrorFeedback | None":
        """The one activation rule (CommConfig → instance or None)."""
        if comm.error_feedback and comm.compression in EF_METHODS:
            return ErrorFeedback(comm.topk_frac, method=comm.compression)
        return None

    def encode(self, client_id: int, w_local, w_round) -> Dict[str, np.ndarray]:
        d = delta_tree(w_local, w_round)
        r = self._residual.get(int(client_id))
        if r is not None:
            d = tree_map(lambda a, b: a + b, d, r)
        payload = encode_delta(d, self.method, self.frac)
        sent = decode_delta(payload, d, self.method)
        self._residual[int(client_id)] = tree_map(lambda a, b: a - b, d, sent)
        return payload
