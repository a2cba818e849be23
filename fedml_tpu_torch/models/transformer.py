"""Decoder-only transformer LM with pluggable attention (port of
``fedml_tpu/models/transformer.py``, dense MLP only; ``MoEMLP`` is still to
port, ROADMAP.md).

Pre-LN blocks, learned positional embeddings indexed by global position
(``arange(T) + pos_offset``), a tanh-approximate GELU MLP (flax's
``nn.gelu`` default; torch's own default is the exact erf form). Parameter
names follow the reference's scopes (``block{i}.ln1.scale``,
``block{i}.qkv.weight``, ``tok_embed.embedding``, ``pos_embed``), so the
weight bridge (fedml_tpu_torch/bridge.py) is a rename plus a transpose of
the dense kernels. Under mixed precision every matmul takes its inputs in
the compute type; the norms keep float32 statistics and the attention
cores float32 softmax."""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.norms import fp32_layer_norm
from fedml_tpu_torch.parallel.ring_attention import full_attention

causal_full_attention = functools.partial(full_attention, causal=True)


class Embed(nn.Module):
    """flax's ``nn.Embed``: a [num_embeddings, features] table named
    ``embedding``, looked up by integer tokens."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, tokens):
        return F.embedding(tokens.long(), self.embedding)


class TransformerBlock(nn.Module):
    """Pre-LN block: x + proj(attn(ln1(x))), then x + mlp(ln2(x))."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                 attn_fn: Callable = causal_full_attention):
        super().__init__()
        C = embed_dim
        self.num_heads = num_heads
        self.attn_fn = attn_fn
        self.ln1 = fp32_layer_norm(C)
        self.qkv = nn.Linear(C, 3 * C, bias=False)
        self.proj = nn.Linear(C, C, bias=False)
        self.ln2 = fp32_layer_norm(C)
        self.mlp_up = nn.Linear(C, mlp_ratio * C)
        self.mlp_down = nn.Linear(mlp_ratio * C, C)

    def forward(self, x):
        B, T, C = x.shape
        H = self.num_heads
        D = C // H
        q, k, v = torch.split(self.qkv(self.ln1(x)), C, dim=-1)
        attn = self.attn_fn(q.reshape(B, T, H, D), k.reshape(B, T, H, D), v.reshape(B, T, H, D))
        x = x + self.proj(attn.reshape(B, T, C))
        h = F.gelu(self.mlp_up(self.ln2(x)), approximate="tanh")
        return x + self.mlp_down(h)


class TransformerLM(nn.Module):
    """tokens [B, T] int → logits [B, T, vocab_size]."""

    # flax's nn.initializers.normal(0.02) (models/__init__.py init_param_)
    normal_init_std = {"pos_embed": 0.02}

    def __init__(self, vocab_size: int, num_layers: int = 2, num_heads: int = 4,
                 embed_dim: int = 128, max_len: int = 4096,
                 attn_fn: Callable = causal_full_attention, moe_experts: int = 0):
        super().__init__()
        if moe_experts:
            raise NotImplementedError("MoEMLP is not ported yet (ROADMAP.md)")
        self.num_layers = num_layers
        self.tok_embed = Embed(vocab_size, embed_dim)
        self.pos_embed = nn.Parameter(torch.empty(max_len, embed_dim))
        for i in range(num_layers):
            setattr(self, f"block{i}", TransformerBlock(embed_dim, num_heads, attn_fn=attn_fn))
        self.ln_f = fp32_layer_norm(embed_dim)
        self.head = nn.Linear(embed_dim, vocab_size, bias=False)

    def forward(self, tokens, pos_offset: int = 0):
        """tokens [B, T_local]; ``pos_offset`` is this shard's global start."""
        T = tokens.shape[1]
        pos = torch.arange(T, device=tokens.device) + pos_offset
        x = self.tok_embed(tokens) + self.pos_embed[pos]
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x)
        return self.head(self.ln_f(x))
