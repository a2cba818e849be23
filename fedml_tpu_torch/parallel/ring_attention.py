"""Plain O(T²) attention (port of ``full_attention`` in
``fedml_tpu/parallel/ring_attention.py``; the ring itself is still to port).

It is the transformer's default ``attn_fn`` and the yardstick of the flash
kernels. [B, T, H, D] layout, scores and softmax in float32, mask value
-1e30, output in q's type — the reference's arithmetic: the Q·Kᵀ product
in the inputs' type, then float32 from the scaling on."""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def full_attention(q, k, v, causal: bool = False):
    """softmax(Q Kᵀ/√D [causal]) V on q, k, v [B, T, H, D]."""
    D, T = q.shape[-1], q.shape[1]
    # a tensor divisor on the scores' device: a true division (a scalar one
    # may become a multiply by its reciprocal on the card)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / torch.sqrt(
        torch.tensor(float(D), dtype=torch.float32, device=q.device)
    )
    if causal:
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=q.device))
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
