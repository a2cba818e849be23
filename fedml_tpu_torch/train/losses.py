"""Mask-weighted losses and metrics (port of ``fedml_tpu/train/losses.py``,
the classification, multi-label tag, next-word, per-pixel segmentation and
proximal-term parts). Zero-padded examples carry mask 0 and contribute
nothing."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def _safe_div(num, den):
    return num / torch.clamp(den, min=1e-9)


def masked_softmax_ce(logits, labels, mask):
    """Mean CE over masked examples. labels: int [B]; mask: float [B]."""
    per_ex = F.cross_entropy(logits, labels.long(), reduction="none")
    return _safe_div(torch.sum(per_ex * mask), torch.sum(mask))


def masked_accuracy_stats(logits, labels, mask):
    """(correct_count, total_count) as float32 sums."""
    pred = torch.argmax(logits, dim=-1)
    correct = torch.sum((pred == labels.long()).to(torch.float32) * mask)
    return correct, torch.sum(mask)


def masked_sigmoid_bce(logits, labels, mask):
    """Multi-label BCE for tag prediction: per example the sum over labels
    of the sigmoid cross-entropy, mean over masked examples. labels: float
    [B, C] (multi-hot)."""
    per_ex = torch.sum(
        F.binary_cross_entropy_with_logits(logits, labels.to(logits.dtype), reduction="none"),
        dim=-1,
    )
    return _safe_div(torch.sum(per_ex * mask), torch.sum(mask))


def masked_seq_ce(logits, labels, mask, pad_token: int = 0):
    """Next-word/char CE over sequences, ignoring pad tokens. logits
    [B, T, V], labels int [B, T], mask float [B] (example mask). Label 0 is
    the pad token even where it is a real symbol (the synthetic chain's),
    as in the reference."""
    V = logits.shape[-1]
    per_tok = F.cross_entropy(
        logits.reshape(-1, V), labels.reshape(-1).long(), reduction="none"
    ).reshape(labels.shape)
    tok_mask = (labels != pad_token).to(torch.float32) * mask[:, None]
    return _safe_div(torch.sum(per_tok * tok_mask), torch.sum(tok_mask))


def masked_seq_accuracy_stats(logits, labels, mask, pad_token: int = 0):
    """(correct_count, total_count) over the non-pad tokens."""
    pred = torch.argmax(logits, dim=-1)
    tok_mask = (labels != pad_token).to(torch.float32) * mask[:, None]
    correct = torch.sum((pred == labels.long()).to(torch.float32) * tok_mask)
    return correct, torch.sum(tok_mask)


SEG_IGNORE_INDEX = 255  # the label of a pixel the segmentation loss skips


def masked_pixel_ce(logits, labels, mask, ignore_index: int = SEG_IGNORE_INDEX):
    """Per-pixel CE for segmentation over the pixels whose label is not
    ``ignore_index``, of the examples with mask 1. logits [B, H, W, C] (the
    reference's layout; a permuted view of the model's NCHW output),
    labels int [B, H, W], mask float [B]."""
    safe = torch.where(labels == ignore_index, torch.zeros_like(labels), labels).long()
    per_px = F.cross_entropy(logits.permute(0, 3, 1, 2), safe, reduction="none")
    px_mask = (labels != ignore_index).to(torch.float32) * mask[:, None, None]
    return _safe_div(torch.sum(per_px * px_mask), torch.sum(px_mask))


def masked_pixel_accuracy_stats(logits, labels, mask, ignore_index: int = SEG_IGNORE_INDEX):
    """(correct pixels, counted pixels) as float32 sums."""
    pred = torch.argmax(logits, dim=-1)
    px_mask = (labels != ignore_index).to(torch.float32) * mask[:, None, None]
    correct = torch.sum((pred == labels.long()).to(torch.float32) * px_mask)
    return correct, torch.sum(px_mask)


def tree_sq_dist(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
    """Σ over leaves of ‖a − b‖² (the FedProx proximal distance)."""
    return sum(torch.sum(torch.square(a[k] - b[k])) for k in a)
