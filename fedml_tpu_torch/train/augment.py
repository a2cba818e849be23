"""Data augmentation — random crop, horizontal flip, Cutout (port of
``fedml_tpu/train/augment.py``).

The reference augments inside the training step, per sample, from the
step's JAX key: a crop of the image padded by ``crop_padding`` at a random
offset, a flip with probability ½, and a ``cutout_size`` square zeroed at a
random centre (clipped at the edges). Here the two halves are apart:

- :func:`draw_offsets` draws every sample's offsets from a torch
  generator (JAX's stream cannot be reproduced, so the draws differ from
  the reference's);
- :func:`apply_augment` applies given offsets to a batch, with no
  randomness, on the batch's device — held to the reference's per-sample
  functions given the same offsets (tests/test_torch_augment_cifar.py).

Policies: ``none``; ``cifar`` — crop (pad 4), flip, Cutout 16, the shape of
the reference's CIFAR pipeline; ``crop_flip`` — without Cutout. The crop
pads with 0 (the mean pixel of normalised inputs), as the reference does
unless given ``crop_fill``."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Offsets = Dict[str, torch.Tensor]


def draw_offsets(generator: torch.Generator, n: int, height: int, width: int,
                 crop_padding: int = 4, flip: bool = True, cutout_size: int = 16) -> Offsets:
    """Per-sample offsets for a batch of ``n`` images, drawn on the CPU:
    ``oy``/``ox`` in [0, 2·pad] (crop), ``flip`` in {0, 1}, ``cy`` in
    [0, height) and ``cx`` in [0, width) (Cutout's centre)."""
    out = {}
    if crop_padding:
        out["oy"] = torch.randint(0, 2 * crop_padding + 1, (n,), generator=generator)
        out["ox"] = torch.randint(0, 2 * crop_padding + 1, (n,), generator=generator)
    if flip:
        out["flip"] = torch.randint(0, 2, (n,), generator=generator)
    if cutout_size:
        out["cy"] = torch.randint(0, height, (n,), generator=generator)
        out["cx"] = torch.randint(0, width, (n,), generator=generator)
    return out


def apply_augment(x: torch.Tensor, offsets: Offsets, crop_padding: int = 4,
                  cutout_size: int = 16, crop_fill=None) -> torch.Tensor:
    """Crop, flip and Cutout of ``x`` [B, H, W, C] at the given per-sample
    offsets (any subset of :func:`draw_offsets`' keys; a missing one skips
    its transform)."""
    B, H, W, _ = x.shape
    dev = x.device
    off = {k: v.to(dev) for k, v in offsets.items()}
    if "oy" in off:
        p = crop_padding
        padded = F.pad(x, (0, 0, p, p, p, p))
        if crop_fill is not None:
            border = torch.ones((1, H, W, 1), dtype=torch.bool, device=dev)
            border = F.pad(border, (0, 0, p, p, p, p))
            padded = torch.where(border, padded, torch.as_tensor(crop_fill, dtype=x.dtype, device=dev))
        rows = off["oy"][:, None] + torch.arange(H, device=dev)
        cols = off["ox"][:, None] + torch.arange(W, device=dev)
        b = torch.arange(B, device=dev)[:, None, None]
        x = padded[b, rows[:, :, None], cols[:, None, :]]
    if "flip" in off:
        x = torch.where(off["flip"].bool()[:, None, None, None], x.flip(2), x)
    if "cy" in off:
        half = cutout_size // 2
        ys = torch.arange(H, device=dev)
        xs = torch.arange(W, device=dev)
        cy, cx = off["cy"][:, None], off["cx"][:, None]
        keep_y = (ys < cy - half) | (ys >= cy + half)
        keep_x = (xs < cx - half) | (xs >= cx + half)
        keep = keep_y[:, :, None] | keep_x[:, None, :]
        x = x * keep[:, :, :, None].to(x.dtype)
    return x


def make_augment(crop_padding: int = 4, flip: bool = True, cutout_size: int = 16,
                 crop_fill=None) -> Callable:
    """``augment(generator, x)`` for x [B, H, W, C]: offsets from
    ``generator``, then :func:`apply_augment`."""

    def augment(generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError(
                f"augmentation expects image batches [B, H, W, C]; got shape {tuple(x.shape)} "
                "— disable TrainConfig.augment for non-image tasks"
            )
        offsets = draw_offsets(generator, x.shape[0], x.shape[1], x.shape[2],
                               crop_padding, flip, cutout_size)
        return apply_augment(x, offsets, crop_padding, cutout_size, crop_fill)

    return augment


def resolve_augment(name: Optional[str]) -> Optional[Callable]:
    """TrainConfig.augment → augment function, or None for ``none``."""
    if name in ("", "none", None):
        return None
    if name == "cifar":
        return make_augment(crop_padding=4, flip=True, cutout_size=16)
    if name == "crop_flip":
        return make_augment(crop_padding=4, flip=True, cutout_size=0)
    raise ValueError(f"unknown augment policy {name!r} (none|cifar|crop_flip)")
