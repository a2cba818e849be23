"""Segmentation metrics: the confusion-matrix Evaluator (port of
``fedml_tpu/utils/seg_metrics.py``; the reference application's
``fedseg/utils.py`` Evaluator).

A batch's confusion matrix is one ``torch.bincount`` on the device, with
an overflow bucket for the pixels whose label is ``ignore_index`` or out
of range; the int64 matrix accumulates on the host, and the four metrics
are the reference's formulas in numpy."""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.device import DeviceLike, resolve_device


class Evaluator:
    """``device=None`` counts on the card (and raises without one);
    ``device="cpu"`` counts on the CPU."""

    def __init__(self, num_class: int, ignore_index: int = 255, device: DeviceLike = None):
        self.num_class = num_class
        self.ignore_index = ignore_index
        self.device = resolve_device(device)
        self.confusion_matrix = np.zeros((num_class, num_class), np.int64)

    def add_batch(self, gt_image, pred_image) -> None:
        """Count one batch of ground-truth and predicted label maps (numpy
        arrays or tensors of the same shape)."""
        C = self.num_class
        gt = torch.as_tensor(gt_image).to(self.device, torch.int64)
        pred = torch.as_tensor(pred_image).to(self.device, torch.int64)
        valid = (gt != self.ignore_index) & (gt >= 0) & (gt < C)
        idx = torch.where(valid, gt * C + pred, torch.full_like(gt, C * C))
        # an index outside [0, C·C] goes to the overflow bucket, as
        # jnp.bincount(length=C·C+1) clips below and drops above
        idx = torch.clamp(idx, 0, C * C)
        counts = torch.bincount(idx.reshape(-1), minlength=C * C + 1)
        self.confusion_matrix += counts[: C * C].reshape(C, C).cpu().numpy()

    def reset(self) -> None:
        self.confusion_matrix[:] = 0

    def Pixel_Accuracy(self) -> float:
        cm = self.confusion_matrix
        return float(np.diag(cm).sum() / max(cm.sum(), 1))

    def Pixel_Accuracy_Class(self) -> float:
        cm = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(cm) / cm.sum(axis=1)
        return float(np.nanmean(acc))

    def Mean_Intersection_over_Union(self) -> float:
        cm = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm))
        return float(np.nanmean(iou))

    def Frequency_Weighted_Intersection_over_Union(self) -> float:
        cm = self.confusion_matrix
        freq = cm.sum(axis=1) / max(cm.sum(), 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm))
        return float((freq[freq > 0] * iou[freq > 0]).sum())
