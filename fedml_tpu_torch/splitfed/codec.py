"""Activation-wire compression for the split/vertical boundary (port of
``fedml_tpu/splitfed/codec.py``).

Per-batch *activations* (and their returned gradients) dominate the
split-learning wire the way per-round weight deltas dominate the
horizontal one, so the boundary composes the same codecs
(core/compression.py int8/int4) over them. Two deltas from the model
path:

- activations are **values, not deltas** — there is no reference tree to
  subtract, so the codec quantizes the raw array (quantization error is
  relative to activation magnitude, which the relu'd cut keeps tame);
- error feedback is **per-stream**: each direction of each (client,
  batch-shape) pair keeps its own residual, added into the *next* tensor
  on the same stream before quantizing — the split analogue of the
  per-client residual in :class:`~fedml_tpu_torch.core.compression.ErrorFeedback`.
  Residuals only make sense while the stream's shape is stable; a shape
  change (last partial batch, new round cohort) resets that stream.

Payloads travel as the same flat ``{"n", "q0", "s0", ...}`` dicts the
model path ships, plus a ``"shape"`` key so the receiver can build the
decode template without out-of-band metadata (decoders ignore unknown
keys). Metering happens at the call sites through the existing
``on_uplink``/``on_downlink`` accounting — the cut factor is read off
``comm/*``, never asserted.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from fedml_tpu_torch.core import compression as CZ

# codecs that make sense for dense activation tensors (topk variants are
# delta-sparsity codecs — activations are dense, so they are excluded)
BOUNDARY_CODECS = ("none", "int8", "int4")


class ActivationCodec:
    """Quantize boundary tensors, optionally with per-stream error
    feedback. One instance per endpoint; streams are keyed by the caller
    (e.g. ``"up:3"`` for client 3's uplink)."""

    def __init__(self, method: str, error_feedback: bool = False):
        if method not in BOUNDARY_CODECS or method == "none":
            raise ValueError(
                f"activation codec must be one of {BOUNDARY_CODECS[1:]}, got {method!r}"
            )
        self.method = method
        self.error_feedback = bool(error_feedback)
        self._residual: Dict[str, np.ndarray] = {}

    @classmethod
    def from_config(cls, comm) -> Optional["ActivationCodec"]:
        method = getattr(comm, "activation_compression", "none")
        if method in (None, "", "none"):
            return None
        return cls(method, error_feedback=getattr(comm, "activation_error_feedback", False))

    def encode(self, stream: str, arr) -> Dict[str, np.ndarray]:
        a = np.ascontiguousarray(np.asarray(arr), dtype=np.float32)
        if self.error_feedback:
            res = self._residual.get(stream)
            if res is not None and res.shape == a.shape:
                a = a + res
        payload = CZ.encode_delta(a, self.method)
        if self.error_feedback:
            decoded = CZ.decode_delta(payload, np.zeros_like(a), self.method)
            self._residual[stream] = a - np.asarray(decoded, dtype=np.float32)
        payload = dict(payload)
        payload["shape"] = np.asarray(a.shape, np.int32)
        return payload

    @staticmethod
    def decode(payload: Dict[str, np.ndarray], method: str) -> np.ndarray:
        shape = tuple(int(d) for d in np.asarray(payload["shape"]).tolist())
        template = np.zeros(shape, np.float32)
        return np.asarray(CZ.decode_delta(payload, template, method), dtype=np.float32)
