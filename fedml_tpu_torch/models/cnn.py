"""FedAvg CNNs (port of ``fedml_tpu/models/cnn.py``: CNNOriginalFedAvg
and CNNDropOut).

The module takes the reference's NHWC input, runs the convolutions in
PyTorch's NCHW, and permutes back to NHWC before the flatten. The reference
flattens NHWC after the second pool (``fedml_tpu/models/cnn.py:29``), so this
keeps ``linear_1``'s input rows in the reference's order and the weight
bridge a plain transpose (fedml_tpu_torch/bridge.py). Flattening NCHW would
train a different model with no error to show it."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Conv2d, Dropout


class CNNOriginalFedAvg(nn.Module):
    """conv32(5×5, SAME) → relu → pool → conv64(5×5, SAME) → relu → pool →
    fc512 → relu → fc#classes. Parameter names follow the reference's
    layer names (``conv2d_1`` … ``linear_2``)."""

    def __init__(self, num_classes: int = 62, input_shape=(28, 28, 1)):
        super().__init__()
        h, w, c = input_shape
        # padding=2: flax "SAME" for a 5×5 stride-1 conv
        self.conv2d_1 = nn.Conv2d(c, 32, 5, padding=2)
        self.conv2d_2 = nn.Conv2d(32, 64, 5, padding=2)
        self.linear_1 = nn.Linear((h // 4) * (w // 4) * 64, 512)
        self.linear_2 = nn.Linear(512, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.max_pool2d(F.relu(self.conv2d_1(x)), 2)
        x = F.max_pool2d(F.relu(self.conv2d_2(x)), 2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flatten in NHWC order
        x = F.relu(self.linear_1(x))
        return self.linear_2(x)


class CNNDropOut(nn.Module):
    """conv32(3×3, VALID) → relu → conv64(3×3, VALID) → relu → pool →
    dropout .25 → fc128 → relu → dropout .5 → fc#classes; the flatten in
    NHWC order, as :class:`CNNOriginalFedAvg`'s."""

    def __init__(self, num_classes: int = 62, input_shape=(28, 28, 1),
                 dropout1: float = 0.25, dropout2: float = 0.5):
        super().__init__()
        h, w, c = input_shape
        self.conv2d_1 = Conv2d(c, 32, 3, padding="VALID")
        self.conv2d_2 = Conv2d(32, 64, 3, padding="VALID")
        self.drop1 = Dropout(dropout1)
        self.linear_1 = nn.Linear(((h - 4) // 2) * ((w - 4) // 2) * 64, 128)
        self.drop2 = Dropout(dropout2)
        self.linear_2 = nn.Linear(128, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.relu(self.conv2d_2(F.relu(self.conv2d_1(x))))
        x = self.drop1(F.max_pool2d(x, 2), train)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flatten in NHWC order
        x = self.drop2(F.relu(self.linear_1(x)), train)
        return self.linear_2(x)
