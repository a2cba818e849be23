"""Normalisation layers (port of ``fedml_tpu/models/norms.py``).

Only the reference's fused paths are ported: :class:`BatchNorm` runs
``ops/fused_batchnorm`` (``bn_act`` in training, ``bn_inference`` on the
running statistics), :class:`GroupNorm` and :class:`LayerNorm` run
``ops/fused_groupnorm`` (``gn_act``, ``ln_act``); all take float32
statistics and give their output in x's type. The reference's
``FEDML_TPU_FUSED_BN=0`` and ``FEDML_TPU_FUSED_NORMS=0`` switches select
flax's own layers, which have no counterpart here.

Names and constants are flax's: parameters ``scale`` (ones) and ``bias``
(zeros); BatchNorm's running statistics ``mean`` (zeros) and ``var``
(ones), momentum 0.9, epsilon 1e-5; GroupNorm's and LayerNorm's epsilon
1e-6. The running statistics follow flax, not ``nn.BatchNorm2d``:
``ra = m·ra + (1−m)·batch`` with the biased batch variance, and the layer
never writes its buffers. In training it hands the new statistics to the
:class:`~fedml_tpu_torch.models.ModelDef` ``apply`` around it
(:func:`~fedml_tpu_torch.models.record_batch_stats`), which returns them
as flax's ``mutable=["batch_stats"]`` does.

The convolutional models run NCHW, so BatchNorm and GroupNorm take the
channels at axis 1; LayerNorm normalises the last axis."""

from __future__ import annotations

import torch
from torch import nn

from fedml_tpu_torch.ops.fused_batchnorm import bn_act, bn_inference
from fedml_tpu_torch.ops.fused_groupnorm import gn_act, ln_act


def _affine(module: nn.Module, features: int) -> None:
    module.scale = nn.Parameter(torch.ones(features))
    module.bias = nn.Parameter(torch.zeros(features))


class BatchNorm(nn.Module):
    """BatchNorm(+ReLU) with flax's variables: parameters ``scale``/``bias``,
    running statistics ``mean``/``var`` (buffers; the ModelDef keys them
    under ``batch_stats.``)."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5,
                 relu: bool = False):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.relu = relu
        _affine(self, features)
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, train: bool = False):
        if not train:
            return bn_inference(x, self.mean, self.var, self.scale, self.bias,
                                self.epsilon, self.relu, channel_axis=1)
        from fedml_tpu_torch.models import record_batch_stats

        y, mean, var = bn_act(x, self.scale, self.bias, self.epsilon, self.relu, channel_axis=1)
        m = self.momentum
        record_batch_stats(self, m * self.mean + (1.0 - m) * mean, m * self.var + (1.0 - m) * var)
        return y


class GroupNorm(nn.Module):
    """GroupNorm(+ReLU) over groups of ``group_size`` channels, with flax's
    parameter names."""

    def __init__(self, features: int, group_size: int, epsilon: float = 1e-6,
                 relu: bool = False):
        super().__init__()
        self.group_size = group_size
        self.epsilon = epsilon
        self.relu = relu
        _affine(self, features)

    def forward(self, x, train: bool = False):
        del train  # no batch statistics
        return gn_act(x, self.scale, self.bias, self.group_size, self.epsilon, self.relu,
                      channel_axis=1)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with flax's parameter names."""

    def __init__(self, features: int, epsilon: float = 1e-6, relu: bool = False):
        super().__init__()
        self.epsilon = epsilon
        self.relu = relu
        _affine(self, features)

    def forward(self, x):
        return ln_act(x, self.scale, self.bias, self.epsilon, self.relu)


# the layers whose scale and bias get float32 gradients from a custom
# backward (train/client.py make_mixed_forward)
AFFINE_NORMS = (BatchNorm, GroupNorm, LayerNorm)


def fp32_batch_norm(features: int, momentum: float = 0.9, relu: bool = False) -> BatchNorm:
    """BatchNorm with float32 statistics, output cast back to x's type."""
    return BatchNorm(features, momentum=momentum, relu=relu)


def fp32_group_norm(features: int, group_size: int, relu: bool = False) -> GroupNorm:
    """GroupNorm with float32 statistics, output cast back to x's type."""
    return GroupNorm(features, group_size, relu=relu)


def fp32_layer_norm(features: int, relu: bool = False) -> LayerNorm:
    """LayerNorm with float32 statistics, output cast back to x's type."""
    return LayerNorm(features, relu=relu)
