"""Normalisation layers (port of the LayerNorm part of
``fedml_tpu/models/norms.py``).

Only the reference's fused path is ported: :class:`LayerNorm` runs
``ops/fused_groupnorm.ln_act`` (float32 statistics, output in x's type).
The reference's ``FEDML_TPU_FUSED_NORMS=0`` switch selects flax's own
LayerNorm, which has no counterpart here. Epsilon is flax's 1e-6, not
torch's 1e-5."""

from __future__ import annotations

import torch
from torch import nn

from fedml_tpu_torch.ops.fused_groupnorm import ln_act


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with flax's parameter names
    (``scale``, ``bias``) and initial values (ones, zeros)."""

    def __init__(self, features: int, epsilon: float = 1e-6, relu: bool = False):
        super().__init__()
        self.epsilon = epsilon
        self.relu = relu
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return ln_act(x, self.scale, self.bias, self.epsilon, self.relu)


def fp32_layer_norm(features: int, relu: bool = False) -> LayerNorm:
    """LayerNorm with float32 statistics, output cast back to x's type."""
    return LayerNorm(features, relu=relu)
