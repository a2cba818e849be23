"""The segmentation model: a compact encoder-decoder (port of
``fedml_tpu/models/segnet.py``).

Three 3×3 conv + BatchNorm + ReLU stages (widths w, 2w, 4w; the second and
third of stride 2), a decoder of two ×2 bilinear upsamplings, each
concatenated with the encoder stage of its size (the upsampled map first,
the skip after it on the channel axis, flax's order) and followed by a
3×3 conv + BatchNorm + ReLU, and a 1×1 head of per-pixel class logits.
Module names are the reference's (``enc1``…``enc3``, ``dec2``, ``dec1``,
``bn1``…``bn5``, ``head``), so the variables bridge one to one.

The reference upsamples with ``jax.image.resize(..., "bilinear")``; here
it is ``F.interpolate(scale_factor=2, mode="bilinear",
align_corners=False)``: both sample at half-pixel centres and, at ×2, both
come down to the edge pixel at the borders; they round differently (up to
~1e-7 apart). The input is the reference's NHWC and so are the logits
[B, H, W, classes] (a view of the NCHW output)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Conv2d, to_nchw
from fedml_tpu_torch.models.norms import fp32_batch_norm


def _up2(h):
    return F.interpolate(h, scale_factor=2, mode="bilinear", align_corners=False)


class EncoderDecoder(nn.Module):
    def __init__(self, num_classes: int, width: int = 32, in_ch: int = 3):
        super().__init__()
        w = width
        self.enc1 = Conv2d(in_ch, w, 3, bias=False)
        self.bn1 = fp32_batch_norm(w, relu=True)
        self.enc2 = Conv2d(w, w * 2, 3, stride=2, bias=False)
        self.bn2 = fp32_batch_norm(w * 2, relu=True)
        self.enc3 = Conv2d(w * 2, w * 4, 3, stride=2, bias=False)
        self.bn3 = fp32_batch_norm(w * 4, relu=True)
        self.dec2 = Conv2d(w * 4 + w * 2, w * 2, 3, bias=False)
        self.bn4 = fp32_batch_norm(w * 2, relu=True)
        self.dec1 = Conv2d(w * 2 + w, w, 3, bias=False)
        self.bn5 = fp32_batch_norm(w, relu=True)
        self.head = Conv2d(w, num_classes, 1)

    def forward(self, x, train: bool = False):
        e1 = self.bn1(self.enc1(to_nchw(x)), train)
        e2 = self.bn2(self.enc2(e1), train)
        e3 = self.bn3(self.enc3(e2), train)
        d2 = self.bn4(self.dec2(torch.cat([_up2(e3), e2], dim=1)), train)
        d1 = self.bn5(self.dec1(torch.cat([_up2(d2), e1], dim=1)), train)
        return self.head(d1).permute(0, 2, 3, 1)
