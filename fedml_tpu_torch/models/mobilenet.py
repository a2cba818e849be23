"""MobileNet v1 and MobileNetV3 (port of ``fedml_tpu/models/mobilenet.py``).

V1 follows the reference's CIFAR layout: a stride-1 stem, BatchNorm after
every conv, depthwise-separable blocks 64 → 128×2 → 256×2 → 512×6 →
1024×2 and a width multiplier α. V3 is the standard LARGE (or SMALL)
table with hard-swish, hard-sigmoid squeeze-excite and dropout before the
head. Depthwise convs are grouped convs (``groups = channels``); NHWC in,
NCHW inside (see models/resnet.py); module names are the reference's."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import (
    Conv2d, Dropout, global_avg_pool, hard_sigmoid, hard_swish, to_nchw,
)
from fedml_tpu_torch.models.norms import fp32_batch_norm


class DepthSeparableConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.depthwise = Conv2d(in_ch, in_ch, 3, stride=stride, groups=in_ch, bias=False)
        self.bn_dw = fp32_batch_norm(in_ch, relu=True)
        self.pointwise = Conv2d(in_ch, out_ch, 1, bias=False)
        self.bn_pw = fp32_batch_norm(out_ch, relu=True)

    def forward(self, x, train: bool = False):
        h = self.bn_dw(self.depthwise(x), train)
        return self.bn_pw(self.pointwise(h), train)


_V1_PLAN: Sequence[Tuple[int, int]] = [
    (64, 1),
    (128, 2), (128, 1),
    (256, 2), (256, 1),
    (512, 2), (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
    (1024, 2), (1024, 1),
]


class MobileNet(nn.Module):
    def __init__(self, num_classes: int = 100, width_multiplier: float = 1.0, in_ch: int = 3):
        super().__init__()

        def ch(c):
            return int(c * width_multiplier)

        self.stem = Conv2d(in_ch, ch(32), 3, bias=False)
        self.stem_bn = fp32_batch_norm(ch(32), relu=True)
        c_in = ch(32)
        self.n_blocks = len(_V1_PLAN)
        for i, (c, s) in enumerate(_V1_PLAN):
            self.add_module(f"ds{i}", DepthSeparableConv(c_in, ch(c), stride=s))
            c_in = ch(c)
        self.fc = nn.Linear(c_in, num_classes)

    def forward(self, x, train: bool = False):
        h = self.stem_bn(self.stem(to_nchw(x)), train)
        for i in range(self.n_blocks):
            h = getattr(self, f"ds{i}")(h, train)
        return self.fc(global_avg_pool(h))


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduce: int = 4):
        super().__init__()
        self.fc1 = nn.Linear(channels, max(1, channels // reduce))
        self.fc2 = nn.Linear(max(1, channels // reduce), channels)

    def forward(self, x):
        s = F.relu(self.fc1(global_avg_pool(x)))
        s = hard_sigmoid(self.fc2(s))
        return x * s[:, :, None, None]


class MBConvV3(nn.Module):
    def __init__(self, in_ch: int, exp_ch: int, out_ch: int, kernel: int, stride: int,
                 use_se: bool, use_hs: bool):
        super().__init__()
        self.act = hard_swish if use_hs else F.relu
        self.has_expand = exp_ch != in_ch
        if self.has_expand:
            self.expand = Conv2d(in_ch, exp_ch, 1, bias=False)
            self.bn_expand = fp32_batch_norm(exp_ch)
        self.depthwise = Conv2d(exp_ch, exp_ch, kernel, stride=stride, groups=exp_ch, bias=False)
        self.bn_dw = fp32_batch_norm(exp_ch)
        self.use_se = use_se
        if use_se:
            self.se = SqueezeExcite(exp_ch)
        self.project = Conv2d(exp_ch, out_ch, 1, bias=False)
        self.bn_project = fp32_batch_norm(out_ch)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x, train: bool = False):
        h = x
        if self.has_expand:
            h = self.act(self.bn_expand(self.expand(h), train))
        h = self.act(self.bn_dw(self.depthwise(h), train))
        if self.use_se:
            h = self.se(h)
        h = self.bn_project(self.project(h), train)
        return h + x if self.residual else h


# (kernel, expansion, out, SE, HS, stride) — MobileNetV3-LARGE table.
_V3_LARGE = [
    (3, 16, 16, False, False, 1),
    (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1),
    (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2),
    (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1),
    (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2),
    (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
]

# MobileNetV3-SMALL table.
_V3_SMALL = [
    (3, 16, 16, True, False, 2),
    (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1),
    (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1),
    (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
]


class MobileNetV3(nn.Module):
    def __init__(self, num_classes: int = 1000, model_mode: str = "LARGE", dropout: float = 0.2,
                 in_ch: int = 3):
        super().__init__()
        large = model_mode.upper() == "LARGE"
        table = _V3_LARGE if large else _V3_SMALL
        self.stem = Conv2d(in_ch, 16, 3, stride=2, bias=False)
        self.stem_bn = fp32_batch_norm(16)
        c_in = 16
        self.n_blocks = len(table)
        for i, (k, exp, out, se, hs, s) in enumerate(table):
            self.add_module(f"block{i}", MBConvV3(c_in, exp, out, k, s, se, hs))
            c_in = out
        last_exp, head = (960, 1280) if large else (576, 1024)
        self.head_conv = Conv2d(c_in, last_exp, 1, bias=False)
        self.head_bn = fp32_batch_norm(last_exp)
        self.head_fc = nn.Linear(last_exp, head)
        self.dropout = Dropout(dropout)
        self.fc = nn.Linear(head, num_classes)

    def forward(self, x, train: bool = False):
        h = hard_swish(self.stem_bn(self.stem(to_nchw(x)), train))
        for i in range(self.n_blocks):
            h = getattr(self, f"block{i}")(h, train)
        h = hard_swish(self.head_bn(self.head_conv(h), train))
        h = hard_swish(self.head_fc(global_avg_pool(h)))
        return self.fc(self.dropout(h, train))
