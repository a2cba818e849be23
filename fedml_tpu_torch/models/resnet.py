"""CIFAR ResNets with BatchNorm — resnet56 / resnet110 (port of
``fedml_tpu/models/resnet.py``).

A 3×3 stem (stride 1, 16 channels), three stages of Bottleneck blocks
of widths 16/32/64 (expansion 4) with (6, 6, 6) blocks (resnet56) or
(12, 12, 12) (resnet110), a global average pool and a dense head. The
input is the reference's NHWC; inside, the model runs NCHW, the layout
cuDNN takes, and the weight bridge (fedml_tpu_torch/bridge.py) maps the
conv kernels. Module names are the reference's (``conv1``, ``bn1``,
``layer{s}_block{b}``, ``downsample_conv``/``downsample_bn``, ``fc``), so
the variables bridge one to one and the torch-checkpoint naming of
models/pretrained.py applies unchanged."""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Conv2d, global_avg_pool, to_nchw
from fedml_tpu_torch.models.norms import fp32_batch_norm


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1, expansion: int = 4):
        super().__init__()
        out_ch = planes * expansion
        self.conv1 = Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = fp32_batch_norm(planes, relu=True)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, bias=False)
        self.bn2 = fp32_batch_norm(planes, relu=True)
        self.conv3 = Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = fp32_batch_norm(out_ch)
        self.has_downsample = stride != 1 or in_ch != out_ch
        if self.has_downsample:
            self.downsample_conv = Conv2d(in_ch, out_ch, 1, stride=stride, bias=False)
            self.downsample_bn = fp32_batch_norm(out_ch)
        self.out_ch = out_ch

    def forward(self, x, train: bool = False):
        identity = x
        h = self.bn1(self.conv1(x), train)
        h = self.bn2(self.conv2(h), train)
        h = self.bn3(self.conv3(h), train)
        if self.has_downsample:
            identity = self.downsample_bn(self.downsample_conv(x), train)
        return F.relu(h + identity)


class CifarResNet(nn.Module):
    def __init__(self, layers: Sequence[int] = (6, 6, 6), num_classes: int = 10, in_ch: int = 3):
        super().__init__()
        self.conv1 = Conv2d(in_ch, 16, 3, bias=False)
        self.bn1 = fp32_batch_norm(16, relu=True)
        ch = 16
        self.block_names = []
        for si, (planes, blocks) in enumerate(zip((16, 32, 64), layers)):
            for bi in range(blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                block = Bottleneck(ch, planes, stride=stride)
                name = f"layer{si + 1}_block{bi}"
                self.add_module(name, block)
                self.block_names.append(name)
                ch = block.out_ch
        self.fc = nn.Linear(ch, num_classes)

    def forward(self, x, train: bool = False):
        h = self.bn1(self.conv1(to_nchw(x)), train)
        for name in self.block_names:
            h = getattr(self, name)(h, train)
        return self.fc(global_avg_pool(h))


def resnet56(num_classes: int, in_ch: int = 3) -> CifarResNet:
    return CifarResNet(layers=(6, 6, 6), num_classes=num_classes, in_ch=in_ch)


def resnet110(num_classes: int, in_ch: int = 3) -> CifarResNet:
    return CifarResNet(layers=(12, 12, 12), num_classes=num_classes, in_ch=in_ch)
