"""VGG 11/13/16/19, with or without BatchNorm (port of
``fedml_tpu/models/vgg.py``).

The reference's layer tables A/B/D/E: 3×3 SAME convolutions (``conv{i}``,
with bias), each followed by ReLU or by a BatchNorm with the ReLU folded in
(``bn{i}``), 2×2 max pools, then the 4096-4096-classes head (``fc1``,
``fc2``, ``fc3``) with ReLU and ``Dropout(0.5)`` after each hidden layer.

Two traps of the reference's layout:

- its pool before the head (:func:`adaptive_avg_pool`) is not PyTorch's
  ``AdaptiveAvgPool2d``: at 7×7 it is the identity, on multiples of 7 an
  average pool, and otherwise (CIFAR's 32×32 leaves 1×1) the global mean
  broadcast to 7×7;
- the flatten runs in NHWC order, as ``models/cnn.py`` does it, so ``fc1``
  bridges with a plain transpose.

NHWC in, NCHW inside (see models/resnet.py)."""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Conv2d, Dropout, to_nchw
from fedml_tpu_torch.models.norms import fp32_batch_norm

CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
          512, 512, 512, 512, "M"],
}
_TABLE = {"vgg11": "A", "vgg13": "B", "vgg16": "D", "vgg19": "E"}


def adaptive_avg_pool(h, out_hw: int = 7):
    """The reference's ``_adaptive_avg_pool`` on NCHW: the identity at
    out_hw × out_hw, an average pool of stride H/out_hw on multiples of
    out_hw, else the global mean broadcast to out_hw × out_hw."""
    B, C, H, W = h.shape
    if H == out_hw and W == out_hw:
        return h
    if H % out_hw == 0 and W % out_hw == 0:
        kh, kw = H // out_hw, W // out_hw
        return F.avg_pool2d(h, (kh, kw), (kh, kw))
    return torch.mean(h, dim=(2, 3), keepdim=True).expand(B, C, out_hw, out_hw)


class VGG(nn.Module):
    def __init__(self, cfg: Sequence[Union[int, str]], num_classes: int = 1000,
                 batch_norm: bool = False, dropout: float = 0.5, in_ch: int = 3):
        super().__init__()
        self.cfg = tuple(cfg)
        self.batch_norm = batch_norm
        c_in, ci = in_ch, 0
        for v in self.cfg:
            if v == "M":
                continue
            self.add_module(f"conv{ci}", Conv2d(c_in, int(v), 3))
            if batch_norm:
                self.add_module(f"bn{ci}", fp32_batch_norm(int(v), relu=True))
            c_in, ci = int(v), ci + 1
        self.fc1 = nn.Linear(7 * 7 * c_in, 4096)
        self.drop1 = Dropout(dropout)
        self.fc2 = nn.Linear(4096, 4096)
        self.drop2 = Dropout(dropout)
        self.fc3 = nn.Linear(4096, num_classes)

    def forward(self, x, train: bool = False):
        h, ci = to_nchw(x), 0
        for v in self.cfg:
            if v == "M":
                h = F.max_pool2d(h, 2, 2)
                continue
            h = getattr(self, f"conv{ci}")(h)
            h = getattr(self, f"bn{ci}")(h, train) if self.batch_norm else F.relu(h)
            ci += 1
        h = adaptive_avg_pool(h, 7)
        h = h.permute(0, 2, 3, 1).flatten(1)  # flatten in NHWC order
        h = self.drop1(F.relu(self.fc1(h)), train)
        h = self.drop2(F.relu(self.fc2(h)), train)
        return self.fc3(h)


def vgg(name: str, num_classes: int = 1000, batch_norm: bool = False, in_ch: int = 3) -> VGG:
    """``vgg11`` … ``vgg19`` by name (without the ``_bn`` suffix)."""
    return VGG(CFGS[_TABLE[name]], num_classes=num_classes, batch_norm=batch_norm, in_ch=in_ch)
