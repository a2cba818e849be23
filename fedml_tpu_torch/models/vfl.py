"""Vertical-FL party models (port of ``fedml_tpu/models/vfl.py``).

A party's feature extractor (one dense layer, then LeakyReLU 0.01) and its
dense head (one dense layer to the logit contribution, with a bias only
for the label-holding guest). The layers are ``fc``, as in the reference,
so the weight bridge maps ``fc/kernel`` ([in, out]) and ``fc/bias`` to
``fc.weight`` ([out, in]) and ``fc.bias``. A party's parameters are one
flat dict, the extractor's under ``extractor.`` and the head's under
``dense.`` (``fedml_tpu_torch/bridge.py`` ``party_from_flax``), and
:func:`party_contribution` computes h = dense(extractor(x)) from it."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

NEGATIVE_SLOPE = 0.01


class VFLFeatureExtractor(nn.Module):
    """One linear layer + LeakyReLU: the host/guest bottom model."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.fc = nn.Linear(input_dim, output_dim)

    def forward(self, x):
        return F.leaky_relu(self.fc(x), NEGATIVE_SLOPE)


class VFLClassifier(nn.Module):
    """One linear layer over a party's features: its logit contribution."""

    def __init__(self, input_dim: int, output_dim: int, use_bias: bool = True):
        super().__init__()
        self.fc = nn.Linear(input_dim, output_dim, bias=use_bias)

    def forward(self, x):
        return self.fc(x)


class VFLPartyModel(nn.Module):
    """A party's whole stack, dense(extractor(x)); its ``state_dict`` names
    are the flat party dict's."""

    def __init__(self, feature_dim: int, hidden_dim: int, out_dim: int, has_labels: bool):
        super().__init__()
        self.extractor = VFLFeatureExtractor(feature_dim, hidden_dim)
        self.dense = VFLClassifier(hidden_dim, out_dim, use_bias=has_labels)

    def forward(self, x):
        return self.dense(self.extractor(x))


def party_contribution(params: Dict[str, torch.Tensor], x):
    """h = dense(extractor(x)) on a party's flat parameter dict (what
    :class:`VFLPartyModel` computes with those weights)."""
    h = F.leaky_relu(F.linear(x, params["extractor.fc.weight"], params["extractor.fc.bias"]),
                     NEGATIVE_SLOPE)
    return F.linear(h, params["dense.fc.weight"], params.get("dense.fc.bias"))
