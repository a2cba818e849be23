"""The MNIST GAN: generator and discriminator MLPs (port of
``fedml_tpu/models/gan.py``; used by FedGAN).

G: 100→128→256(BN)→512(BN)→1024(BN)→784, leaky ReLU 0.2 after each hidden
layer, tanh on the output, reshaped to [B, 28, 28, 1]. D: 784→512→256→1,
leaky ReLU 0.2, the raw logit (the sigmoid is folded into the BCE loss).
:class:`MNISTGan` holds both as ``netg`` and ``netd``, so FedAvg averages
them as one set of variables; names are the reference's."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.norms import fp32_batch_norm


class Generator(nn.Module):
    def __init__(self, input_size: int = 100, out_pixels: int = 784):
        super().__init__()
        self.fc1 = nn.Linear(input_size, 128)
        self.fc2 = nn.Linear(128, 256)
        self.bn2 = fp32_batch_norm(256)
        self.fc3 = nn.Linear(256, 512)
        self.bn3 = fp32_batch_norm(512)
        self.fc4 = nn.Linear(512, 1024)
        self.bn4 = fp32_batch_norm(1024)
        self.fc5 = nn.Linear(1024, out_pixels)

    def forward(self, z, train: bool = False):
        h = F.leaky_relu(self.fc1(z), 0.2)
        h = F.leaky_relu(self.bn2(self.fc2(h), train), 0.2)
        h = F.leaky_relu(self.bn3(self.fc3(h), train), 0.2)
        h = F.leaky_relu(self.bn4(self.fc4(h), train), 0.2)
        return torch.tanh(self.fc5(h)).reshape(z.shape[0], 28, 28, 1)


class Discriminator(nn.Module):
    def __init__(self, input_size: int = 784):
        super().__init__()
        self.fc1 = nn.Linear(input_size, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, 1)

    def forward(self, x):
        h = F.leaky_relu(self.fc1(x.reshape(x.shape[0], -1)), 0.2)
        h = F.leaky_relu(self.fc2(h), 0.2)
        return self.fc3(h)


class MNISTGan(nn.Module):
    """G + D under one set of variables (``netg.*``, ``netd.*``)."""

    def __init__(self, z_dim: int = 100):
        super().__init__()
        self.netg = Generator(z_dim)
        self.netd = Discriminator()

    def forward(self, z, x_real=None, train: bool = False):
        fake = self.netg(z, train)
        d_real = self.netd(x_real) if x_real is not None else None
        return fake, self.netd(fake), d_real
