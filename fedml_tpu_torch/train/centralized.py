"""Centralized (non-federated) training (port of
``fedml_tpu/train/centralized.py``, its single-device form): the
federation's pooled data trained as one dataset, the accuracy baseline the
federated runs are held to.

Every client's shard is pooled (``FederatedDataset.centralized_train``),
reshuffled each epoch with ``default_rng((seed, epoch))``, cut into batches
(the last one masked), and trained with the client optimizer, whose state
persists across epochs. A step is the local train's step (the same mixed
forward and optimizer); ``--comm_round`` is the epoch count on the command
line. The reference's ``mesh`` form (the batch sharded over devices) is
ROADMAP.md §1 item 11."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from fedml_tpu_torch.device import DeviceLike, fp32_math, resolve_device
from fedml_tpu_torch.models import ModelDef, split_stats
from fedml_tpu_torch.train.client import LocalTrain
from fedml_tpu_torch.train.evaluate import make_eval_fn, pad_to_batches


def make_centralized_epoch(model: ModelDef, config, task: str = "classification"):
    """``(params, stats, opt_state, x, y, mask, epoch_seed) -> (params',
    stats', opt_state', {loss_sum, correct, count})``: one epoch of optimizer
    steps over the pre-batched x [S, B, ...], every step carrying data."""
    step = LocalTrain(model, dataclasses.replace(config.train, prox_mu=0.0), 1, task=task)

    def epoch_fn(params, stats, opt_state, x, y, mask, epoch_seed: int = 0):
        sums = torch.zeros(4, dtype=torch.float32, device=mask.device)
        for s in range(mask.shape[0]):
            seed = (int(np.random.SeedSequence([epoch_seed, s]).generate_state(1)[0])
                    if step._random_steps else 0)
            params, stats, opt_state, mets = step._step(
                params, stats, opt_state, x[s], y[s], mask[s], params, seed
            )
            sums = sums + mets
        return params, stats, opt_state, {"loss_sum": sums[0], "correct": sums[1],
                                          "count": sums[2]}

    return epoch_fn, step.opt


class CentralizedTrainer:
    """Pooled-data trainer (counterpart of the reference's
    ``CentralizedTrainer``): ``train()`` runs ``fed.comm_round`` epochs and
    logs the reference's rows (``epoch``, ``Train/*``, and ``Test/*`` on
    eval epochs). ``device=None`` runs on the card."""

    def __init__(self, config, data, model: ModelDef, task: str = "classification",
                 mesh=None, log_fn: Optional[Callable[[dict], None]] = None,
                 device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(
                "the centralized trainer's mesh form is not ported yet (ROADMAP.md §1 item 11)"
            )
        self.device = resolve_device(device)
        self.config, self.model, self.task, self.data = config, model, task, data
        self.log_fn = log_fn or (lambda row: None)
        x, y = data.centralized_train()
        self._x, self._y = np.asarray(x), np.asarray(y)
        bs = config.data.batch_size
        self.batch_size = len(self._x) if bs == -1 else bs
        self.epoch_fn, opt = make_centralized_epoch(model, config, task)
        self.eval_fn = make_eval_fn(model, task)
        init = model.init(torch.Generator().manual_seed(config.seed))
        self.global_vars = {k: v.to(self.device) for k, v in init.items()}
        self.opt_state = opt.init(split_stats(self.global_vars)[0])
        self.history: list = []

    def train_epoch(self, epoch: int) -> dict:
        cfg = self.config
        perm = np.random.default_rng((cfg.seed, epoch)).permutation(len(self._x))
        x, y, mask = (torch.from_numpy(a).to(self.device)
                      for a in pad_to_batches(self._x[perm], self._y[perm], self.batch_size))
        params, stats = split_stats(self.global_vars)
        with fp32_math():
            params, stats, self.opt_state, m = self.epoch_fn(
                params, stats, self.opt_state, x, y, mask,
                int(np.random.SeedSequence([cfg.seed, epoch]).generate_state(1)[0]),
            )
        self.global_vars = {**params, **stats}
        count = float(m["count"])
        return {
            "epoch": epoch,
            "Train/Loss": float(m["loss_sum"]) / max(count, 1.0),
            "Train/Acc": float(m["correct"]) / max(count, 1.0),
        }

    def evaluate(self) -> Tuple[float, float]:
        # the eval batch is capped: under batch_size -1 a test set padded
        # to the train set's size would waste the device
        xb, yb, mb = pad_to_batches(np.asarray(self.data.test_x), np.asarray(self.data.test_y),
                                    max(min(self.batch_size, 256), 1))
        batches = [torch.from_numpy(a).to(self.device) for a in (xb, yb, mb)]
        with fp32_math():
            m = self.eval_fn(self.global_vars, *batches)
        count = float(m["count"])
        return float(m["loss_sum"]) / max(count, 1.0), float(m["correct"]) / max(count, 1.0)

    def train(self, epochs: Optional[int] = None) -> dict:
        epochs = epochs if epochs is not None else self.config.fed.comm_round
        row = {}
        for e in range(epochs):
            row = self.train_epoch(e)
            if (e + 1) % self.config.fed.frequency_of_the_test == 0 or e == epochs - 1:
                row["Test/Loss"], row["Test/Acc"] = self.evaluate()
            self.history.append(row)
            self.log_fn(row)
        return row
