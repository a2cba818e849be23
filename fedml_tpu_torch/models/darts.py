"""The DARTS search space for FedNAS (port of ``fedml_tpu/models/darts.py``).

A differentiable cell: every edge is a softmax(α)-weighted mixture of the
candidate ops, ``tensordot(weights, stack(ops))``; the network stacks
normal cells and, in the middle, a reduction cell (its edges from the two
inputs have stride 2). α is two parameters of the network,
``alpha_normal`` and ``alpha_reduce`` [edges, ops], initialised as
1e-3 · N(0, 1); FedNAS steps them apart from the weights.

Module and parameter names are flax's auto-names, so a reference state
bridges without renaming: inside ``sep3`` (:class:`_SepConv`) the convs
are ``Conv_0``…``Conv_3`` and the norms ``BatchNorm_0``/``BatchNorm_1``,
inside ``dil3`` (:class:`_DilConv`) ``Conv_0``, ``Conv_1`` and
``BatchNorm_0``; a stride-2 skip is ``skip_reduce``. Every op of a cell
returns its ``ch`` channels, so the reference's ``adj_<op>`` channel
adapters never exist. The ops keep :data:`DEFAULT_OPS`' order, and the
``none`` op of a stride-2 edge is zeros of the strided shape. The input is
the reference's NHWC; inside, the network runs NCHW."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import (
    Conv2d, avg_pool_same, global_avg_pool, max_pool_same, to_nchw,
)
from fedml_tpu_torch.models.norms import fp32_batch_norm

DEFAULT_OPS: Tuple[str, ...] = (
    "none",
    "skip_connect",
    "avg_pool_3x3",
    "max_pool_3x3",
    "sep_conv_3x3",
    "dil_conv_3x3",
)


class _SepConv(nn.Module):
    """ReLU, depthwise k×k (stride s), 1×1, BN, ReLU, depthwise k×k, 1×1, BN."""

    def __init__(self, ch: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv2d(ch, ch, kernel, stride=stride, groups=ch, bias=False)
        self.Conv_1 = Conv2d(ch, ch, 1, bias=False)
        self.BatchNorm_0 = fp32_batch_norm(ch)
        self.Conv_2 = Conv2d(ch, ch, kernel, groups=ch, bias=False)
        self.Conv_3 = Conv2d(ch, ch, 1, bias=False)
        self.BatchNorm_1 = fp32_batch_norm(ch)

    def forward(self, x, train: bool = False):
        h = self.BatchNorm_0(self.Conv_1(self.Conv_0(F.relu(x))), train)
        return self.BatchNorm_1(self.Conv_3(self.Conv_2(F.relu(h))), train)


class _DilConv(nn.Module):
    """ReLU, depthwise k×k of dilation 2 (stride s), 1×1, BN."""

    def __init__(self, ch: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv2d(ch, ch, kernel, stride=stride, groups=ch, bias=False, dilation=2)
        self.Conv_1 = Conv2d(ch, ch, 1, bias=False)
        self.BatchNorm_0 = fp32_batch_norm(ch)

    def forward(self, x, train: bool = False):
        return self.BatchNorm_0(self.Conv_1(self.Conv_0(F.relu(x))), train)


class MixedOp(nn.Module):
    def __init__(self, ch: int, stride: int, ops: Sequence[str] = DEFAULT_OPS):
        super().__init__()
        self.stride = stride
        self.ops = tuple(ops)
        for name in self.ops:
            if name == "skip_connect" and stride != 1:
                self.skip_reduce = Conv2d(ch, ch, 1, stride=stride, bias=False)
            elif name == "sep_conv_3x3":
                self.sep3 = _SepConv(ch, 3, stride)
            elif name == "dil_conv_3x3":
                self.dil3 = _DilConv(ch, 3, stride)
            elif name not in ("none", "skip_connect", "avg_pool_3x3", "max_pool_3x3"):
                raise ValueError(name)

    def forward(self, x, weights, train: bool = False):
        s = self.stride
        outs = []
        for name in self.ops:
            if name == "none":
                o = torch.zeros_like(x if s == 1 else x[:, :, ::s, ::s])
            elif name == "skip_connect":
                o = x if s == 1 else self.skip_reduce(x)
            elif name == "avg_pool_3x3":
                o = avg_pool_same(x, 3, s)
            elif name == "max_pool_3x3":
                o = max_pool_same(x, 3, s)
            elif name == "sep_conv_3x3":
                o = self.sep3(x, train)
            else:
                o = self.dil3(x, train)
            outs.append(o)
        return torch.tensordot(weights, torch.stack(outs), dims=1)


class Cell(nn.Module):
    def __init__(self, c0: int, c1: int, ch: int, steps: int = 4, reduction: bool = False,
                 ops: Sequence[str] = DEFAULT_OPS):
        super().__init__()
        self.steps = steps
        self.pre0 = Conv2d(c0, ch, 1, bias=False)
        self.pre1 = Conv2d(c1, ch, 1, bias=False)
        for i in range(steps):
            for j in range(2 + i):
                self.add_module(f"edge_{i}_{j}", MixedOp(ch, 2 if reduction and j < 2 else 1, ops))

    def forward(self, s0, s1, weights, train: bool = False):
        """weights: [num_edges, num_ops] softmaxed α rows."""
        states: List[torch.Tensor] = [self.pre0(s0), self.pre1(s1)]
        offset = 0
        for i in range(self.steps):
            acc = None
            for j, h in enumerate(states):
                o = getattr(self, f"edge_{i}_{j}")(h, weights[offset + j], train)
                acc = o if acc is None else acc + o
            offset += len(states)
            states.append(acc)
        return torch.cat(states[-self.steps:], dim=1)


def num_edges(steps: int = 4) -> int:
    return sum(2 + i for i in range(steps))


class DARTSNetwork(nn.Module):
    def __init__(self, num_classes: int, ch: int = 16, cells: int = 3, steps: int = 4,
                 ops: Sequence[str] = DEFAULT_OPS, in_ch: int = 3):
        super().__init__()
        E, O = num_edges(steps), len(ops)
        self.alpha_normal = nn.Parameter(torch.zeros(E, O))
        self.alpha_reduce = nn.Parameter(torch.zeros(E, O))
        # flax's init of α: 1e-3 · N(0, 1) (ModelDef.init reads this)
        self.normal_init_std = {"alpha_normal": 1e-3, "alpha_reduce": 1e-3}
        self.stem = Conv2d(in_ch, ch, 3, bias=False)
        self.stem_bn = fp32_batch_norm(ch)
        self.reductions = []
        c0 = c1 = ch
        for ci in range(cells):
            reduction = ci == cells // 2 and cells > 1
            self.add_module(f"cell{ci}", Cell(c0, c1, ch, steps, reduction, ops))
            self.reductions.append(reduction)
            c0, c1 = (c1, steps * ch) if not reduction else (steps * ch, steps * ch)
        self.classifier = nn.Linear(c1, num_classes)

    def forward(self, x, train: bool = False):
        w_n = F.softmax(self.alpha_normal, dim=-1)
        w_r = F.softmax(self.alpha_reduce, dim=-1)
        h = self.stem_bn(self.stem(to_nchw(x)), train)
        s0 = s1 = h
        for ci, reduction in enumerate(self.reductions):
            out = getattr(self, f"cell{ci}")(s0, s1, w_r if reduction else w_n, train)
            s0, s1 = (s1, out) if not reduction else (out, out)
        return self.classifier(global_avg_pool(s1))


def derive_genotype(alpha, ops: Sequence[str] = DEFAULT_OPS, steps: int = 4):
    """Per node keep the 2 strongest non-``none`` incoming edges: each edge
    scored by its best op's softmax weight, ties broken as the reference's
    ``sort(reverse=True)`` over (weight, op name, input index) tuples."""
    a = np.asarray(alpha.detach().cpu() if torch.is_tensor(alpha) else alpha, np.float32)
    e = np.exp(a - a.max(axis=-1, keepdims=True))
    alpha = e / e.sum(axis=-1, keepdims=True)
    gene = []
    offset = 0
    none_idx = ops.index("none") if "none" in ops else -1
    for i in range(steps):
        n_in = 2 + i
        rows = alpha[offset : offset + n_in]
        best_per_edge = []
        for j in range(n_in):
            row = [w for k, w in enumerate(rows[j]) if k != none_idx]
            names = [ops[k] for k in range(len(ops)) if k != none_idx]
            k_best = int(np.argmax(row))
            best_per_edge.append((float(row[k_best]), names[k_best], j))
        best_per_edge.sort(reverse=True)
        gene.extend([(op, j) for _, op, j in best_per_edge[:2]])
        offset += n_in
    return gene
