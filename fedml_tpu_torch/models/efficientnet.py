"""EfficientNet B0–B7 (port of ``fedml_tpu/models/efficientnet.py``).

MBConv inverted bottlenecks with squeeze-excite and SiLU, the B0 stage
table scaled by each variant's width and depth coefficients
(:data:`COEFFS`, with :func:`round_filters` and :func:`round_repeats`
copied as written), a 1×1 head conv, the spatial mean, ``Dropout`` and
the dense classifier. Module names are the reference's (``stem``,
``stage{s}_block{r}`` with ``expand``/``depthwise``/``se_reduce``/
``se_expand``/``project`` and their ``bn_*``, ``head``, ``fc``).

Traps of the reference's layout:

- its strided depthwise convs pad as XLA's "SAME" does, the odd pixel at
  the high end (:class:`~fedml_tpu_torch.models.layers.Conv2d`);
- the squeeze-excite width comes from the block's INPUT channels, not the
  expanded ones;
- stochastic depth: block ``bi`` of ``total`` drops its residual branch
  at rate ``drop_connect_rate·bi/total``, with one Bernoulli(keep) draw a
  sample (shape [B, 1, 1, 1]), scaled by 1/keep. Its masks and the head's
  dropout mask come from the apply's generator, the dropout stream
  (models ``dropout_generator``), drawn in the order the layers run.

NHWC in, NCHW inside (see models/resnet.py); the depthwise kernel is
[mid, 1, k, k] against the reference's HWIO [k, k, 1, mid], which the
bridge's conv transpose maps."""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Conv2d, Dropout, global_avg_pool, to_nchw
from fedml_tpu_torch.models.norms import fp32_batch_norm


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


# (expand, out, repeats, stride, kernel): the B0 stage table
B0_STAGES: Tuple = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

COEFFS = {  # variant -> (width, depth, dropout)
    "b0": (1.0, 1.0, 0.2),
    "b1": (1.0, 1.1, 0.2),
    "b2": (1.1, 1.2, 0.3),
    "b3": (1.2, 1.4, 0.3),
    "b4": (1.4, 1.8, 0.4),
    "b5": (1.6, 2.2, 0.4),
    "b6": (1.8, 2.6, 0.5),
    "b7": (2.0, 3.1, 0.5),
}


class MBConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, expand: int, kernel: int, stride: int,
                 se_ratio: float = 0.25, drop_rate: float = 0.0):
        super().__init__()
        mid = in_ch * expand
        self.has_expand = expand != 1
        if self.has_expand:
            self.expand = Conv2d(in_ch, mid, 1, bias=False)
            self.bn_expand = fp32_batch_norm(mid)
        self.depthwise = Conv2d(mid, mid, kernel, stride=stride, groups=mid, bias=False)
        self.bn_dw = fp32_batch_norm(mid)
        se_ch = max(1, int(in_ch * se_ratio))  # from the block's input channels
        self.se_reduce = nn.Linear(mid, se_ch)
        self.se_expand = nn.Linear(se_ch, mid)
        self.project = Conv2d(mid, out_ch, 1, bias=False)
        self.bn_project = fp32_batch_norm(out_ch)
        self.residual = stride == 1 and in_ch == out_ch
        self.drop_rate = drop_rate

    def forward(self, x, train: bool = False):
        h = x
        if self.has_expand:
            h = F.silu(self.bn_expand(self.expand(h), train))
        h = F.silu(self.bn_dw(self.depthwise(h), train))
        s = F.silu(self.se_reduce(global_avg_pool(h)))
        s = torch.sigmoid(self.se_expand(s))
        h = h * s[:, :, None, None]
        h = self.bn_project(self.project(h), train)
        if not self.residual:
            return h
        if train and self.drop_rate > 0.0:
            from fedml_tpu_torch.models import dropout_generator

            keep = 1.0 - self.drop_rate
            u = torch.rand((h.shape[0], 1, 1, 1), generator=dropout_generator(), device=h.device)
            h = h * (u < keep).to(h.dtype) / keep
        return h + x


class EfficientNet(nn.Module):
    def __init__(self, num_classes: int = 1000, variant: str = "b0",
                 drop_connect_rate: float = 0.2, in_ch: int = 3):
        super().__init__()
        width, depth, dropout = COEFFS[variant]
        c = round_filters(32, width)
        self.stem = Conv2d(in_ch, c, 3, stride=2, bias=False)
        self.stem_bn = fp32_batch_norm(c)
        total = sum(round_repeats(r, depth) for _, _, r, _, _ in B0_STAGES)
        self.block_names = []
        bi = 0
        for si, (expand, out, repeats, stride, kernel) in enumerate(B0_STAGES):
            out_ch = round_filters(out, width)
            for r in range(round_repeats(repeats, depth)):
                name = f"stage{si}_block{r}"
                self.add_module(name, MBConv(c, out_ch, expand, kernel, stride if r == 0 else 1,
                                             drop_rate=drop_connect_rate * bi / total))
                self.block_names.append(name)
                c, bi = out_ch, bi + 1
        head = round_filters(1280, width)
        self.head = Conv2d(c, head, 1, bias=False)
        self.head_bn = fp32_batch_norm(head)
        self.dropout = Dropout(dropout)
        self.fc = nn.Linear(head, num_classes)

    def forward(self, x, train: bool = False):
        h = F.silu(self.stem_bn(self.stem(to_nchw(x)), train))
        for name in self.block_names:
            h = getattr(self, name)(h, train)
        h = F.silu(self.head_bn(self.head(h), train))
        return self.fc(self.dropout(global_avg_pool(h), train))
