"""FedAvg — the main path (port of ``fedml_tpu/algorithms/fedavg.py``, its
eager parts).

One round: a uniform cohort draw, the sampled shards gathered from the
device store into a padded [C, S, B] batch, each client's local train from
the global model, then the sample-weighted float32 average (or a defense's
aggregate). The reference lifts the local train over the clients with
``vmap`` or ``lax.scan`` and proves the two schedules compute the same
thing; the port runs every ``client_parallelism`` mode as the sequential
loop — the schedule ``resolve_client_parallelism`` picks for the FEMNIST
CNN, and the "scan" schedule the flagship LM runs. ``task`` is
"classification" or "nwp" (next-word prediction, the transformer LM). Knobs that in the reference change only the schedule, never the
numbers (``client_parallelism``, ``fused_rounds``, ``fused_plan``,
``pipeline``, ``compile.*``), are not read here. Knobs that would change
the numbers and are not ported yet raise."""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.config import RunConfig
from fedml_tpu_torch.data.base import FederatedDataset, stack_clients
from fedml_tpu_torch.data.device_store import DeviceDataStore
from fedml_tpu_torch.device import DeviceLike, fp32_math, resolve_device
from fedml_tpu_torch.models import ModelDef
from fedml_tpu_torch.scheduler import ClientScheduler, select_clients
from fedml_tpu_torch.train.client import (
    EpochPerm, PermFn, client_step_seed, make_local_train, seeded_perm_fn,
)
from fedml_tpu_torch.train.evaluate import make_eval_fn, metrics_to_loss_acc, pad_to_batches

Tree = Dict[str, torch.Tensor]
_METRIC_KEYS = ("correct", "count", "loss_sum", "steps")


def weighted_average(stacked_tree: Tree, weights: torch.Tensor) -> Tree:
    """Sample-weighted average over the leading client axis."""
    wsum = torch.sum(weights)
    return {
        k: torch.tensordot(weights, p.float(), dims=1) / wsum
        for k, p in stacked_tree.items()
    }


def client_sampling(round_idx: int, client_num_in_total: int, client_num_per_round: int) -> np.ndarray:
    """Round-seeded uniform cohort (``np.random.seed(round_idx)`` then
    ``choice`` without replacement)."""
    return select_clients(round_idx, client_num_in_total, client_num_per_round)


def round_client_perms(perm_fn: PermFn, round_idx: int, num_sampled: int) -> List[EpochPerm]:
    """Per-client shuffle sources for one round — the port's counterpart of
    the reference's ``round_client_rngs``: client slot j of round r draws
    its epoch permutations from ``perm_fn(r, j, epoch, mask_flat)``."""
    return [
        (lambda epoch, m_flat, j=j: perm_fn(round_idx, j, epoch, m_flat))
        for j in range(num_sampled)
    ]


def make_fedavg_round(
    model: ModelDef,
    config: RunConfig,
    task: str = "classification",
    local_train_fn: Optional[Callable] = None,
    post_train: Optional[Callable] = None,
    post_aggregate: Optional[Callable] = None,
    aggregate_fn: Optional[Callable] = None,
    robust=None,
):
    """The round function ``(global_vars, x, y, mask, num_samples,
    client_perms, step_seeds=None) -> (global_vars', metric sums)``;
    ``step_seeds[j]`` seeds client j's dropout and augmentation.

    ``post_train(client_vars, global_vars)`` transforms the stacked
    per-client results before aggregation, ``aggregate_fn(client_vars,
    num_samples, global_vars)`` replaces the weighted average (of the
    parameters and the running statistics alike) and
    ``post_aggregate(new_global)`` transforms the result.
    ``robust`` (a RobustConfig) derives the three hooks from the defense
    config; it excludes passing hooks directly."""
    if robust is not None:
        if any(h is not None for h in (post_train, post_aggregate, aggregate_fn)):
            raise ValueError(
                "pass either robust= (describable defense config) or "
                "explicit hook closures, not both"
            )
        from fedml_tpu_torch.algorithms.fedavg_robust import make_defense_hooks

        post_train, post_aggregate, aggregate_fn = make_defense_hooks(robust)
    local_train = local_train_fn or make_local_train(
        model, config.train, config.fed.epochs, task=task
    )

    def round_fn(global_vars, x, y, mask, num_samples, client_perms, step_seeds=None):
        C = x.shape[0]
        mask_host = mask.cpu()  # which steps hold data is decided on the host
        client_vars: Tree = {}
        sums = None
        for j in range(C):
            new_vars, mets = local_train(
                global_vars, x[j], y[j], mask[j], client_perms[j], mask_host=mask_host[j],
                step_seed=0 if step_seeds is None else step_seeds[j],
            )
            for k, v in new_vars.items():
                if k not in client_vars:
                    client_vars[k] = torch.empty((C,) + tuple(v.shape), dtype=v.dtype, device=v.device)
                client_vars[k][j] = v
            vec = torch.stack([mets[k] for k in _METRIC_KEYS])
            sums = vec if sums is None else sums + vec
        if post_train is not None:
            client_vars = post_train(client_vars, global_vars)
        if aggregate_fn is not None:
            new_global = aggregate_fn(client_vars, num_samples, global_vars)
        else:
            new_global = weighted_average(client_vars, num_samples)
        if post_aggregate is not None:
            new_global = post_aggregate(new_global)
        return new_global, dict(zip(_METRIC_KEYS, sums))

    return round_fn


class FedAvgAPI:
    """Standalone FedAvg simulator (counterpart of the reference's
    ``FedAvgAPI``). ``device=None`` runs on the card and raises without
    one; pass ``device="cpu"`` for the CPU. ``perm_fn(round, client_slot,
    epoch, mask_flat)`` is the local shuffle source (default
    :func:`seeded_perm_fn` of ``config.seed``)."""

    def __init__(
        self,
        config: RunConfig,
        data: FederatedDataset,
        model: ModelDef,
        task: str = "classification",
        local_train_fn: Optional[Callable] = None,
        log_fn: Optional[Callable[[dict], None]] = None,
        device: DeviceLike = None,
        perm_fn: Optional[PermFn] = None,
    ):
        self.device = resolve_device(device)
        fed = config.fed
        if fed.fault_plan:
            raise NotImplementedError(
                "fault plans in the simulator are not ported yet (ROADMAP.md); "
                "the transport (fedavg_transport) takes them"
            )
        if fed.eval_on_clients:
            raise NotImplementedError("eval_on_clients is not ported yet (ROADMAP.md)")
        self.config = config
        self.data = data
        self.model = model
        self.task = task
        self.log_fn = log_fn or (lambda m: None)
        init = model.init(torch.Generator().manual_seed(config.seed))
        self.global_vars = {k: v.to(self.device) for k, v in init.items()}
        self.perm_fn = perm_fn or seeded_perm_fn(config.seed)
        self.round_fn = self._build_round_fn(local_train_fn)
        self.eval_fn = make_eval_fn(model, task)
        self.history: list = []
        # --resume sets global_vars, start_round (and a FedOpt's
        # server_opt_state) after construction; train() continues from there
        self.start_round = 0
        # each fresh cohort goes to log_fn (summary.json's scheduler/* keys)
        self.scheduler = ClientScheduler.from_config(
            config, num_clients=data.num_clients, data=data, log_fn=self.log_fn
        )
        self._store = None
        if config.data.device_cache:
            try:
                self._store = DeviceDataStore(data, self.device)
            except ValueError:
                # ragged per-client feature shapes cannot concatenate — the
                # one expected reason to stack on the host instead
                self._store = None
        self._test_dev = None

    def _build_round_fn(self, local_train_fn):
        return make_fedavg_round(
            self.model, self.config, task=self.task, local_train_fn=local_train_fn
        )

    def train_round(self, round_idx: int):
        sampled = self.scheduler.select(round_idx)
        placed = self._place_batch(self._round_batch(sampled, round_idx), round_idx)
        with fp32_math():
            self.global_vars, metrics = self.round_fn(self.global_vars, *placed)
        return sampled, metrics

    def _stack(self, client_indices, seed: int):
        cfg = self.config
        if self._store is not None:
            return self._store.round_batch(
                client_indices, cfg.data.batch_size, seed=seed, pad_bucket=cfg.data.pad_bucket
            )
        return stack_clients(
            self.data, client_indices, cfg.data.batch_size, seed=seed,
            pad_bucket=cfg.data.pad_bucket,
        )

    def _round_batch(self, sampled, round_idx: int):
        return self._stack(sampled, self.config.seed * 1_000_003 + round_idx)

    def _place_batch(self, batch, round_idx: int):
        dev = self.device
        return (
            torch.as_tensor(batch.x).to(dev),
            torch.as_tensor(batch.y).to(dev),
            torch.as_tensor(batch.mask).to(dev),
            torch.as_tensor(batch.num_samples).to(dev),
            round_client_perms(self.perm_fn, round_idx, batch.num_clients),
            # each slot's dropout and augmentation stream
            [client_step_seed(self.config.seed, round_idx, j) for j in range(batch.num_clients)],
        )

    def _eval_batches(self):
        if self._test_dev is None:
            xb, yb, mb = pad_to_batches(
                np.asarray(self.data.test_x), np.asarray(self.data.test_y), 256
            )
            self._test_dev = tuple(torch.from_numpy(a).to(self.device) for a in (xb, yb, mb))
        return self._test_dev

    def evaluate_global(self):
        """(loss, acc) of the global model on the central test set."""
        with fp32_math():
            return metrics_to_loss_acc(self.eval_fn(self.global_vars, *self._eval_batches()))

    def _log_round(self, round_idx: int, sampled, metrics: Dict[str, float],
                   round_time_s: float) -> dict:
        count = float(metrics["count"])
        row = {
            "round": round_idx,
            "Train/Loss": float(metrics["loss_sum"]) / max(count, 1e-9),
            "Train/Acc": float(metrics["correct"]) / max(count, 1e-9),
            "round_time_s": round_time_s,
        }
        # the loss map of the checkpoint's sched slot: the cohort mean, as
        # the reference's simulator reports it
        for cid in sampled:
            self.scheduler.report_loss(int(cid), row["Train/Loss"])
        if self._is_eval_round(round_idx):
            row["Test/Loss"], row["Test/Acc"] = self.evaluate_global()
        self.history.append(row)
        self.log_fn(row)
        return row

    def _is_eval_round(self, round_idx: int) -> bool:
        cfg = self.config
        return (
            round_idx % cfg.fed.frequency_of_the_test == 0
            or round_idx == cfg.fed.comm_round - 1
        )

    def train(self) -> Dict[str, float]:
        """Run rounds ``start_round .. comm_round-1``; each round's metrics
        come to the host once (which waits for the device), so
        ``round_time_s`` is the round's full time, device work included."""
        final = {}
        for round_idx in range(self.start_round, self.config.fed.comm_round):
            t0 = time.perf_counter()
            sampled, metrics = self.train_round(round_idx)
            host = torch.stack([metrics[k] for k in _METRIC_KEYS]).tolist()
            dt = time.perf_counter() - t0
            final = self._log_round(round_idx, sampled, dict(zip(_METRIC_KEYS, host)), dt)
        return final
