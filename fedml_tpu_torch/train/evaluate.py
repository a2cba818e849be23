"""Evaluation (port of ``fedml_tpu/train/evaluate.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fedml_tpu_torch.device import fp32_math
from fedml_tpu_torch.models import ModelDef
from fedml_tpu_torch.train.client import make_task_loss


def pad_to_batches(x: np.ndarray, y: np.ndarray, batch_size: int):
    """Host-side: pad test arrays to a whole number of batches + mask."""
    n = x.shape[0]
    steps = (n + batch_size - 1) // batch_size
    cap = steps * batch_size
    xp = np.zeros((cap,) + x.shape[1:], dtype=x.dtype)
    yp = np.zeros((cap,) + y.shape[1:], dtype=y.dtype)
    mp = np.zeros((cap,), dtype=np.float32)
    xp[:n], yp[:n], mp[:n] = x, y, 1.0
    return (
        xp.reshape((steps, batch_size) + x.shape[1:]),
        yp.reshape((steps, batch_size) + y.shape[1:]),
        mp.reshape((steps, batch_size)),
    )


def make_eval_fn(model: ModelDef, task: str = "classification"):
    """``eval_fn(variables, x, y, mask) -> {loss_sum, correct, count}`` over
    batched inputs x [S, B, ...]; sums stay on the inputs' device. The
    model runs with ``train=False``: BatchNorm on the variables' running
    statistics, dropout off."""
    task_loss = make_task_loss(task)

    @torch.no_grad()
    def eval_fn(variables, x, y, mask):
        sums = torch.zeros(3, dtype=torch.float32, device=x.device)
        for s in range(x.shape[0]):
            logits, _ = model.apply(variables, x[s], train=False)
            loss, correct, total = task_loss(logits, y[s], mask[s])
            sums = sums + torch.stack([loss * total, correct, total])
        return {"loss_sum": sums[0], "correct": sums[1], "count": sums[2]}

    return eval_fn


def metrics_to_loss_acc(m) -> Tuple[float, float]:
    """{loss_sum, correct, count} sums → (mean loss, accuracy)."""
    count = float(m["count"])
    return (
        float(m["loss_sum"]) / max(count, 1e-9),
        float(m["correct"]) / max(count, 1e-9),
    )


def evaluate(model: ModelDef, variables, x, y, batch_size: int = 256,
             task: str = "classification", eval_fn=None) -> Tuple[float, float]:
    """(loss, accuracy) of ``variables`` on host arrays x, y, batched on
    the variables' device."""
    dev = next(iter(variables.values())).device
    batches = [torch.from_numpy(a).to(dev)
               for a in pad_to_batches(np.asarray(x), np.asarray(y), batch_size)]
    fn = eval_fn or make_eval_fn(model, task)
    with fp32_math():
        return metrics_to_loss_acc(fn(variables, *batches))
