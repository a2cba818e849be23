"""Linear models (port of ``fedml_tpu/models/linear.py``)."""

from __future__ import annotations

import math

import torch
from torch import nn


class LogisticRegression(nn.Module):
    """Flatten → one dense layer (``linear``), returning logits; the loss
    applies the softmax."""

    def __init__(self, num_classes: int, input_shape=(1,)):
        super().__init__()
        self.linear = nn.Linear(math.prod(input_shape), num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x.reshape(x.shape[0], -1))
