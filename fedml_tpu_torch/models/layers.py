"""flax layer semantics the model zoo needs in PyTorch: ``Conv`` with
XLA's ``"SAME"`` padding, ``Dropout`` on an explicit generator, and the
hard-swish activations. No reference module of its own: these
are the pieces of ``flax.linen`` that ``fedml_tpu/models/*.py`` build on.

XLA's ``"SAME"`` pads ``max((⌈n/s⌉−1)·s + k − n, 0)`` in all, the odd one
at the high end; ``nn.Conv2d(padding=k//2)`` pads both ends alike, which
for a stride-2 3×3 conv on an even size samples other pixels (torch's
first window starts at −1, XLA's at 0). :class:`Conv2d` pads as XLA does,
through the convolution's own symmetric padding where the two agree; a
dilated kernel pads for its dilated extent d·(k−1)+1. The SAME pools pad
the same way: :func:`max_pool_same` with −inf, :func:`avg_pool_same`
with zeros that count toward the mean, as flax's ``nn.avg_pool`` does."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(n: int, k: int, s: int):
    """(low, high) padding of XLA's "SAME" for size ``n``, kernel ``k``,
    stride ``s``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, s: int, value: float = 0.0):
    """x (NCHW) padded as XLA's "SAME" pads a k×k window of stride s."""
    (h0, h1), (w0, w1) = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
    return F.pad(x, (w0, w1, h0, h1), value=value)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on NCHW with flax's padding: ``"SAME"`` (the default),
    ``"VALID"`` or an int for both ends of both spatial axes; ``dilation``
    is flax's ``kernel_dilation``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding="SAME", groups: int = 1, bias: bool = True, dilation: int = 1):
        pad = {"VALID": 0, "SAME": 0}.get(padding, padding)
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=pad, groups=groups,
                         bias=bias, dilation=dilation)
        self.same = padding == "SAME"

    def forward(self, x):
        if not self.same:
            return super().forward(x)
        (kh, kw), (sh, sw), (dh, dw) = self.kernel_size, self.stride, self.dilation
        ph = same_pads(x.shape[2], dh * (kh - 1) + 1, sh)
        pw = same_pads(x.shape[3], dw * (kw - 1) + 1, sw)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, self.weight, self.bias, self.stride, (ph[0], pw[0]),
                            self.dilation, self.groups)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, self.dilation, self.groups)


def max_pool_same(x, k: int, s: int):
    """flax's ``nn.max_pool(x, (k, k), (s, s), "SAME")`` on NCHW: the pads
    are −inf, so a window's maximum is over its real pixels."""
    return F.max_pool2d(_pad_same(x, k, s, float("-inf")), k, s)


def avg_pool_same(x, k: int, s: int):
    """flax's ``nn.avg_pool(x, (k, k), (s, s), "SAME")`` on NCHW: the zero
    pads count toward the mean (flax's ``count_include_pad=True``)."""
    return F.avg_pool2d(_pad_same(x, k, s), k, s)


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: in training, keep each element with
    probability 1 − rate and scale it by 1/(1 − rate); the mask comes from
    the apply's generator (models ``dropout_generator``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, train: bool = False):
        if not train or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        from fedml_tpu_torch.models import dropout_generator

        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=dropout_generator(), device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def hard_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x):
    return x * hard_sigmoid(x)


def to_nchw(x):
    return x.permute(0, 3, 1, 2)


def global_avg_pool(h):
    """The mean over the spatial axes of an NCHW activation."""
    return torch.mean(h, dim=(2, 3))
