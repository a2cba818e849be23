"""FedSeg — federated semantic segmentation (port of
``fedml_tpu/algorithms/fedseg.py``).

FedAvg over an encoder-decoder with the per-pixel ignore-index CE task
(``"segmentation"`` in train/client.py), the confusion-matrix evaluation
(mIoU, FWIoU, pixel accuracy and its per-class mean; utils/seg_metrics.py)
on each test round, and best-mIoU checkpoint promotion: a test round whose
mIoU beats every earlier one writes the global model to
``checkpoint_path`` in the reference's format, with ``best_miou`` in its
metadata, so either package loads it."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.device import fp32_math
from fedml_tpu_torch.utils.checkpoint import save_checkpoint
from fedml_tpu_torch.utils.seg_metrics import Evaluator


class FedSegAPI(FedAvgAPI):
    """``FedAvgAPI`` with the segmentation task and rows; ``device=None``
    runs on the card."""

    def __init__(self, config, data, model, checkpoint_path: Optional[str] = None, **kw):
        kw.setdefault("task", "segmentation")
        super().__init__(config, data, model, **kw)
        self.checkpoint_path = checkpoint_path
        self.best_miou = -1.0

    @torch.no_grad()
    def evaluate_seg(self, batch_size: int = 16) -> dict:
        """mIoU, FWIoU, pixel accuracy and mean class accuracy of the global
        model on the central test set."""
        ev = Evaluator(self.data.num_classes, device=self.device)
        x, y = np.asarray(self.data.test_x), np.asarray(self.data.test_y)
        with fp32_math():
            for s in range(0, len(y), batch_size):
                xb = torch.from_numpy(x[s : s + batch_size]).to(self.device)
                logits, _ = self.model.apply(self.global_vars, xb, train=False)
                ev.add_batch(y[s : s + batch_size], torch.argmax(logits, dim=-1))
        return {
            "Test/mIoU": ev.Mean_Intersection_over_Union(),
            "Test/FWIoU": ev.Frequency_Weighted_Intersection_over_Union(),
            "Test/Acc": ev.Pixel_Accuracy(),
            "Test/Acc_class": ev.Pixel_Accuracy_Class(),
        }

    def train(self):
        cfg = self.config
        final = {}
        for round_idx in range(cfg.fed.comm_round):
            _, metrics = self.train_round(round_idx)
            count = float(metrics["count"])
            row = {
                "round": round_idx,
                "Train/Loss": float(metrics["loss_sum"]) / max(count, 1e-9),
                "Train/Acc": float(metrics["correct"]) / max(count, 1e-9),
            }
            if self._is_eval_round(round_idx):
                row.update(self.evaluate_seg())
                if self.checkpoint_path and row["Test/mIoU"] > self.best_miou:
                    self.best_miou = row["Test/mIoU"]
                    save_checkpoint(
                        self.checkpoint_path, self.global_vars, round_idx=round_idx,
                        extra_meta={"best_miou": self.best_miou},
                    )
            self.history.append(row)
            self.log_fn(row)
            final = row
        return final
