"""ImageNet-style ResNets with GroupNorm — resnet18 … resnet152 (port of
``fedml_tpu/models/resnet_gn.py``).

``channels_per_group`` is the reference's knob: the channels of one
GroupNorm group, 2 by default; 0 selects BatchNorm (the model then has
batch statistics). ``small_input`` swaps the 7×7 stride-2 stem and its
max-pool for a 3×3 stride-1 stem. NHWC in, NCHW inside (see
models/resnet.py); module names are the reference's."""

from __future__ import annotations

from typing import Sequence, Type

import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Conv2d, global_avg_pool, to_nchw
from fedml_tpu_torch.models.norms import fp32_batch_norm, fp32_group_norm


def _norm(features: int, channels_per_group: int, relu: bool = False) -> nn.Module:
    if channels_per_group > 0:
        return fp32_group_norm(features, channels_per_group, relu=relu)
    return fp32_batch_norm(features, relu=relu)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1, channels_per_group: int = 2):
        super().__init__()
        cpg = channels_per_group
        self.conv1 = Conv2d(in_ch, planes, 3, stride=stride, bias=False)
        self.bn1 = _norm(planes, cpg, relu=True)
        self.conv2 = Conv2d(planes, planes, 3, bias=False)
        self.bn2 = _norm(planes, cpg)
        self.out_ch = planes * self.expansion
        self.has_downsample = stride != 1 or in_ch != self.out_ch
        if self.has_downsample:
            self.downsample_conv = Conv2d(in_ch, self.out_ch, 1, stride=stride, bias=False)
            self.downsample_bn = _norm(self.out_ch, cpg)

    def forward(self, x, train: bool = False):
        identity = x
        h = self.bn1(self.conv1(x), train)
        h = self.bn2(self.conv2(h), train)
        if self.has_downsample:
            identity = self.downsample_bn(self.downsample_conv(x), train)
        return F.relu(h + identity)


class BottleneckGN(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1, channels_per_group: int = 2):
        super().__init__()
        cpg = channels_per_group
        self.out_ch = planes * self.expansion
        self.conv1 = Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = _norm(planes, cpg, relu=True)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, bias=False)
        self.bn2 = _norm(planes, cpg, relu=True)
        self.conv3 = Conv2d(planes, self.out_ch, 1, bias=False)
        self.bn3 = _norm(self.out_ch, cpg)
        self.has_downsample = stride != 1 or in_ch != self.out_ch
        if self.has_downsample:
            self.downsample_conv = Conv2d(in_ch, self.out_ch, 1, stride=stride, bias=False)
            self.downsample_bn = _norm(self.out_ch, cpg)

    def forward(self, x, train: bool = False):
        identity = x
        h = self.bn1(self.conv1(x), train)
        h = self.bn2(self.conv2(h), train)
        h = self.bn3(self.conv3(h), train)
        if self.has_downsample:
            identity = self.downsample_bn(self.downsample_conv(x), train)
        return F.relu(h + identity)


class ResNetGN(nn.Module):
    def __init__(self, block: Type[nn.Module] = BasicBlock, layers: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 1000, channels_per_group: int = 2,
                 small_input: bool = False, in_ch: int = 3):
        super().__init__()
        cpg = channels_per_group
        self.small_input = small_input
        if small_input:
            self.conv1 = Conv2d(in_ch, 64, 3, bias=False)
        else:
            self.conv1 = Conv2d(in_ch, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _norm(64, cpg, relu=True)
        ch = 64
        self.block_names = []
        for si, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            for bi in range(blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                b = block(ch, planes, stride=stride, channels_per_group=cpg)
                name = f"layer{si + 1}_block{bi}"
                self.add_module(name, b)
                self.block_names.append(name)
                ch = b.out_ch
        self.fc = nn.Linear(ch, num_classes)

    def forward(self, x, train: bool = False):
        h = self.bn1(self.conv1(to_nchw(x)), train)
        if not self.small_input:
            # flax max_pool pads with -inf, as torch's does
            h = F.max_pool2d(h, 3, stride=2, padding=1)
        for name in self.block_names:
            h = getattr(self, name)(h, train)
        return self.fc(global_avg_pool(h))


def _make(block, layers):
    def ctor(num_classes: int, channels_per_group: int = 2, small_input: bool = False,
             in_ch: int = 3) -> ResNetGN:
        return ResNetGN(block=block, layers=layers, num_classes=num_classes,
                        channels_per_group=channels_per_group, small_input=small_input,
                        in_ch=in_ch)

    return ctor


resnet18 = _make(BasicBlock, (2, 2, 2, 2))
resnet34 = _make(BasicBlock, (3, 4, 6, 3))
resnet50 = _make(BottleneckGN, (3, 4, 6, 3))
resnet101 = _make(BottleneckGN, (3, 4, 23, 3))
resnet152 = _make(BottleneckGN, (3, 8, 36, 3))
