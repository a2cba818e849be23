"""The GKT split ResNets: the small client feature extractor and the large
server network (port of ``fedml_tpu/models/gkt_resnet.py``; used by
FedGKT).

Client: a 3×3 stem conv of 16 channels + BatchNorm + ReLU, whose output
is the uploaded feature map [B, H, W, 16], then ``blocks`` Bottlenecks of
the 16-channel stage and a local dense head; it returns ``(features,
logits)``. Server: the 32- and 64-channel stages of ``layers`` Bottlenecks
each (the first of each of stride 2) over those features, a global
average pool and a dense head. Client ``blocks=2`` and server
``layers=(6, 6)`` are ResNet-56 cut after its stem and first stage's
start. Inputs and features keep the reference's NHWC layout (the features
are an NHWC view of the NCHW activation); module names are the
reference's, so the variables bridge one to one."""

from __future__ import annotations

from typing import Sequence

from torch import nn

from fedml_tpu_torch.models.layers import Conv2d, global_avg_pool, to_nchw
from fedml_tpu_torch.models.norms import fp32_batch_norm
from fedml_tpu_torch.models.resnet import Bottleneck


class GKTClientResNet(nn.Module):
    """Stem + 16-channel stage + local head; returns (features, logits)."""

    def __init__(self, num_classes: int = 10, blocks: int = 2, in_ch: int = 3):
        super().__init__()
        self.num_classes = num_classes
        self.conv1 = Conv2d(in_ch, 16, 3, bias=False)
        self.bn1 = fp32_batch_norm(16, relu=True)
        self.block_names = []
        for bi in range(blocks):
            name = f"layer1_block{bi}"
            self.add_module(name, Bottleneck(16, 4))
            self.block_names.append(name)
        self.fc = nn.Linear(16, num_classes)

    def forward(self, x, train: bool = False):
        h = self.bn1(self.conv1(to_nchw(x)), train)
        features = h.permute(0, 2, 3, 1)
        for name in self.block_names:
            h = getattr(self, name)(h, train)
        return features, self.fc(global_avg_pool(h))


class GKTServerResNet(nn.Module):
    """The 32/64-channel stages over the client features."""

    def __init__(self, num_classes: int = 10, layers: Sequence[int] = (6, 6), in_ch: int = 16):
        super().__init__()
        ch = in_ch
        self.block_names = []
        for si, (planes, blocks) in enumerate(zip((32, 64), layers)):
            for bi in range(blocks):
                block = Bottleneck(ch, planes, stride=2 if bi == 0 else 1)
                name = f"layer{si + 2}_block{bi}"
                self.add_module(name, block)
                self.block_names.append(name)
                ch = block.out_ch
        self.fc = nn.Linear(ch, num_classes)

    def forward(self, features, train: bool = False):
        h = to_nchw(features)
        for name in self.block_names:
            h = getattr(self, name)(h, train)
        return self.fc(global_avg_pool(h))
