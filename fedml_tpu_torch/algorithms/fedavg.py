"""FedAvg — the main path (port of ``fedml_tpu/algorithms/fedavg.py``, its
eager parts).

One round: the cohort (the scheduler's policy, less the clients a fault
plan drops), the sampled shards gathered from the device store into a
padded [C, S, B] batch, each client's local train from the global model,
then the sample-weighted float32 average (or a defense's aggregate). The
reference lifts the local train over the clients with ``vmap`` or
``lax.scan`` (``resolve_client_parallelism`` picks one) and proves the two
schedules compute the same thing. The port has two schedules: the batched
one (``train/client.py`` :class:`BatchedLocalTrain`, every client's step
at once under ``torch.func.vmap``) where the reference resolves to vmap
and the model has neither running statistics, dropout, augmentation nor
an LSTM; the sequential loop everywhere else (``train_clients``), which
is also what "scan" means here. ``FedAvgAPI._client_mode`` is the
reference's resolved mode and ``_client_schedule`` the schedule that ran
("vmap" or "loop"). ``task`` is "classification" or "nwp" (next-word
prediction, the transformer LM). Knobs that in the reference change only
the schedule's speed, never the numbers (``fused_rounds``, ``fused_plan``,
``pipeline``, ``compile.*``), are not read here.

Two random streams are hooks, because PyTorch cannot reproduce JAX's
threefry: the local shuffles (``perm_fn``, train/client.py) and the
Gaussian noise of the private and defended rounds (``noise_fn``, below)."""

from __future__ import annotations

import functools
import logging
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.config import RunConfig
from fedml_tpu_torch.data.base import FederatedDataset, stack_clients
from fedml_tpu_torch.data.device_store import DeviceDataStore, fits_on_device
from fedml_tpu_torch.device import DeviceLike, fp32_math, resolve_device
from fedml_tpu_torch.models import ModelDef
from fedml_tpu_torch.scheduler import ClientScheduler, FaultInjector, select_clients
from fedml_tpu_torch.telemetry import ClientHealthRegistry
from fedml_tpu_torch.train.client import (
    BatchedLocalTrain, EpochPerm, PermFn, batched_schedule_refusal, client_step_seed,
    make_local_train, seeded_perm_fn,
)
from fedml_tpu_torch.train.evaluate import make_eval_fn, metrics_to_loss_acc, pad_to_batches

Tree = Dict[str, torch.Tensor]
_METRIC_KEYS = ("correct", "count", "loss_sum", "steps")
_LOCAL_METRICS = ("loss_sum", "correct", "count", "steps")  # a local train's mets order

# the tag of the noise stream of weak DP, DP-FedAvg and the backdoor
# harness (the reference folds it into the round key: NOISE_FOLD of
# fedml_tpu/algorithms/fedavg_robust.py)
NOISE_FOLD = 0x5EED

# (round, tag, leaf names, leaf shapes) -> one standard-normal float32
# tensor per leaf, in the order given
NoiseFn = Callable[[int, int, List[str], List[tuple]], List[torch.Tensor]]
# (leaf names, leaf shapes) -> tensors: one round's draw
NoiseDraw = Callable[[List[str], List[tuple]], List[torch.Tensor]]


def seeded_noise_fn(seed: int, device: torch.device) -> NoiseFn:
    """The port's default noise source: one generator on ``device`` a
    (round, tag), seeded from (seed, round, tag), drawing the leaves in the
    order given. The reference draws ``normal(split(fold_in(round_key,
    tag), n_leaves)[i])`` for leaf i in ``jax.tree_util`` order; a test
    that needs those draws passes a ``noise_fn`` that makes them."""

    def noise_fn(round_idx, tag, names, shapes):
        key = np.random.SeedSequence([seed, round_idx, tag]).generate_state(1)[0]
        gen = torch.Generator(device=device).manual_seed(int(key))
        return [torch.randn(shape, generator=gen, device=device) for shape in shapes]

    return noise_fn


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


def resolve_client_parallelism(mode: str, model: ModelDef) -> str:
    """The reference's resolution of ``FedConfig.client_parallelism``:
    "auto" is "scan" when some 4-D conv kernel has at most 64 output
    channels and a kernel height of at most 7 (under-tiled on the TPU's
    MXU) and a client's copy of the variables takes at least 1 MB, else
    "vmap". The port's kernels are OIHW, so the reference's HWIO
    ``shape[-1]`` and ``shape[0]`` are ``shape[0]`` and ``shape[2]`` here.
    The shapes are the module's own, so nothing is initialised."""
    if mode == "auto":
        module = model.module
        tensors = list(module.parameters()) + list(module.buffers())
        param_bytes = sum(t.numel() * t.element_size() for t in tensors)
        small_conv = any(
            t.dim() == 4 and t.shape[0] <= 64 and t.shape[2] <= 7 for t in module.parameters()
        )
        mode = "scan" if (small_conv and param_bytes >= 1_000_000) else "vmap"
    if mode not in ("vmap", "scan"):
        raise ValueError(f"client_parallelism must be 'vmap', 'scan' or 'auto', got {mode!r}")
    return mode


def client_schedule(mode: str, model: ModelDef, tc) -> str:
    """The schedule a resolved ``mode`` runs ``model`` on: "vmap" (the
    batched schedule) where the mode is vmap and :class:`BatchedLocalTrain`
    can train the model, else "loop"."""
    return "vmap" if mode == "vmap" and batched_schedule_refusal(model, tc) is None else "loop"


def train_clients_batched(batched_train: BatchedLocalTrain, global_vars, x, y, mask,
                          client_perms):
    """:func:`train_clients`'s result from the batched schedule: every
    client's local train at once; the metric sums added in client order,
    as the loop adds them."""
    client_vars, mets = batched_train(global_vars, x, y, mask, client_perms, mask_host=mask.cpu())
    per_client = list(mets[:, [_LOCAL_METRICS.index(k) for k in _METRIC_KEYS]].unbind(0))
    sums = per_client[0]
    for vec in per_client[1:]:
        sums = sums + vec
    return client_vars, per_client, sums


def train_clients(local_train, global_vars, x, y, mask, client_perms, step_seeds=None):
    """Every client's local train from ``global_vars``, one after the other
    (the loop schedule): ``(client_vars [C, ...], per-client
    metric vectors [C] × [4] in ``_METRIC_KEYS`` order, their sum)``."""
    C = x.shape[0]
    mask_host = mask.cpu()  # which steps hold data is decided on the host
    client_vars: Tree = {}
    sums = None
    per_client = []
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
        per_client.append(vec)
        sums = vec if sums is None else sums + vec
    return client_vars, per_client, sums


def make_fedavg_round(
    model: ModelDef,
    config: RunConfig,
    task: str = "classification",
    local_train_fn: Optional[Callable] = None,
    post_train: Optional[Callable] = None,
    post_aggregate: Optional[Callable] = None,
    aggregate_fn: Optional[Callable] = None,
    robust=None,
    client_metrics: bool = False,
    schedule: str = "loop",
):
    """The round function ``(global_vars, x, y, mask, num_samples,
    client_perms, step_seeds=None, *extra) -> (global_vars', metric
    sums)``; ``step_seeds[j]`` seeds client j's dropout and augmentation.

    ``post_train(client_vars, global_vars, *extra)`` transforms the stacked
    per-client results before aggregation, ``aggregate_fn(client_vars,
    num_samples, global_vars)`` replaces the weighted average (of the
    parameters and the running statistics alike) and
    ``post_aggregate(new_global, *extra)`` transforms the result; the
    round's arguments after ``step_seeds`` (a noise draw, an attack mask)
    go to both. ``robust`` (a RobustConfig) derives the three hooks from
    the defense config; it excludes passing hooks directly.
    ``client_metrics`` adds the per-client ``client_loss_sum`` and
    ``client_count`` vectors [C] to the sums (power-of-choice's signal).
    ``schedule`` "vmap" trains the clients with :class:`BatchedLocalTrain`
    (it takes no ``local_train_fn``; the round function's ``batched_train``
    is it, with the group size its device allowed), "loop" one after the
    other."""
    if robust is not None:
        if any(h is not None for h in (post_train, post_aggregate, aggregate_fn)):
            raise ValueError(
                "pass either robust= (describable defense config) or "
                "explicit hook closures, not both"
            )
        from fedml_tpu_torch.algorithms.fedavg_robust import make_defense_hooks

        post_train, post_aggregate, aggregate_fn = make_defense_hooks(robust)
    if schedule == "vmap":
        if local_train_fn is not None:
            raise ValueError("the batched schedule trains with BatchedLocalTrain, not "
                             "local_train_fn")
        batched = BatchedLocalTrain(model, config.train, config.fed.epochs, task=task)

        def train(global_vars, x, y, mask, client_perms, step_seeds):
            return train_clients_batched(batched, global_vars, x, y, mask, client_perms)
    elif schedule == "loop":
        batched = None
        local_train = local_train_fn or make_local_train(
            model, config.train, config.fed.epochs, task=task
        )
        train = functools.partial(train_clients, local_train)
    else:
        raise ValueError(f"schedule must be 'vmap' or 'loop', got {schedule!r}")

    def round_fn(global_vars, x, y, mask, num_samples, client_perms, step_seeds=None, *extra):
        client_vars, per_client, sums = train(global_vars, x, y, mask, client_perms, step_seeds)
        if post_train is not None:
            client_vars = post_train(client_vars, global_vars, *extra)
        if aggregate_fn is not None:
            new_global = aggregate_fn(client_vars, num_samples, global_vars)
        else:
            new_global = weighted_average(client_vars, num_samples)
        if post_aggregate is not None:
            new_global = post_aggregate(new_global, *extra)
        metrics = dict(zip(_METRIC_KEYS, sums))
        if client_metrics:
            stacked = torch.stack(per_client)
            metrics["client_loss_sum"] = stacked[:, _METRIC_KEYS.index("loss_sum")]
            metrics["client_count"] = stacked[:, _METRIC_KEYS.index("count")]
        return new_global, metrics

    round_fn.batched_train = batched
    return round_fn


class FedAvgAPI:
    """Standalone FedAvg simulator (counterpart of the reference's
    ``FedAvgAPI``). ``device=None`` runs on the card and raises without
    one; pass ``device="cpu"`` for the CPU. ``perm_fn(round, client_slot,
    epoch, mask_flat)`` is the local shuffle source (default
    :func:`seeded_perm_fn` of ``config.seed``), ``noise_fn`` the noise
    source of the subclasses that add noise (default
    :func:`seeded_noise_fn`).

    A round's cohort is the scheduler's selection less the clients the
    fault plan (``fed.fault_plan``) drops or crashes; the simulator trains
    a cohort as one program, so only participation faults apply, and
    ``faults.summary_row()`` holds the run's counts. ``health`` is the
    client health registry: after each round every sampled client is
    observed with the round's time (``straggler_aware`` reads it). With
    ``fed.eval_on_clients`` an eval round reports the global model on every
    client's shards (:meth:`local_test_on_all_clients`).

    ``_client_mode`` is ``fed.client_parallelism`` as the reference
    resolves it; ``_client_schedule`` says what trains the clients: "vmap"
    (:class:`BatchedLocalTrain`) where the mode is vmap and the model and
    the round allow it, else "loop". An explicit "vmap" that the port
    cannot batch raises NotImplementedError."""

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
        noise_fn: Optional[NoiseFn] = None,
    ):
        self.device = resolve_device(device)
        self.config = config
        self.data = data
        self.model = model
        self.task = task
        self._client_mode = resolve_client_parallelism(config.fed.client_parallelism, model)
        self._client_schedule = "loop"  # _build_round_fn sets "vmap" where it batches
        explicit_vmap = config.fed.client_parallelism == "vmap"
        reason = batched_schedule_refusal(model, config.train)
        if explicit_vmap and reason is not None:
            # refused before the model is initialised
            raise NotImplementedError(
                f"client_parallelism='vmap' does not run a model with {reason} yet "
                "(ROADMAP.md §1 item 13); 'auto' and 'scan' train it as the loop"
            )
        self.log_fn = log_fn or (lambda m: None)
        init = model.init(torch.Generator().manual_seed(config.seed))
        self.global_vars = {k: v.to(self.device) for k, v in init.items()}
        self.perm_fn = perm_fn or seeded_perm_fn(config.seed)
        self.noise_fn = noise_fn or seeded_noise_fn(config.seed, self.device)
        # the client health registry: the cohort trains as one loop, so
        # every sampled client shares the round's wall time; participation
        # and last-seen are exact per client. straggler_aware reads it, and
        # fault plans record into it
        self.health = ClientHealthRegistry.from_config(config)
        # each fresh cohort goes to log_fn (summary.json's scheduler/* keys)
        self.scheduler = ClientScheduler.from_config(
            config, num_clients=data.num_clients, data=data, log_fn=self.log_fn,
            health=self.health,
        )
        self.round_fn = self._build_round_fn(local_train_fn)
        if explicit_vmap and self._client_schedule != "vmap":
            raise NotImplementedError(
                f"{type(self).__name__} trains its clients as the loop: client_parallelism="
                "'vmap' is not ported for its round yet (ROADMAP.md §1 item 13)"
            )
        self.eval_fn = make_eval_fn(model, task)
        self.history: list = []
        # --resume sets global_vars, start_round (and a FedOpt's
        # server_opt_state) after construction; train() continues from there
        self.start_round = 0
        self.faults = FaultInjector.from_config(config, health=self.health)
        # round -> cohort after faults: one decision a round, so the fault
        # counters count each fault once
        self._round_plans: Dict[int, np.ndarray] = {}
        # rounds whose clients' own losses went to the scheduler
        # (power_of_choice); the others report the cohort mean
        self._client_loss_rounds: set = set()
        self._store = None
        # past the byte cap (an mmap store of 100k clients) the data stays on
        # the host and each round stacks only its cohort
        if config.data.device_cache and fits_on_device(data):
            try:
                self._store = DeviceDataStore(data, self.device)
            except ValueError:
                # ragged per-client feature shapes cannot concatenate — the
                # one expected reason to stack on the host instead
                self._store = None
        self._test_dev = None
        self._local_eval_dev = None

    def _build_round_fn(self, local_train_fn):
        self._client_schedule = (
            "loop" if local_train_fn is not None
            else client_schedule(self._client_mode, self.model, self.config.train)
        )
        return make_fedavg_round(
            self.model, self.config, task=self.task, local_train_fn=local_train_fn,
            client_metrics=self.scheduler.wants_client_losses, schedule=self._client_schedule,
        )

    def train_round(self, round_idx: int):
        sampled = self._round_plan(round_idx)
        placed = self._place_batch(self._round_batch(sampled, round_idx), round_idx)
        with fp32_math():
            self.global_vars, metrics = self.round_fn(self.global_vars, *placed)
        if "client_loss_sum" in metrics:
            self._report_client_losses(sampled, metrics, round_idx)
        return sampled, metrics

    def _report_client_losses(self, sampled, metrics, round_idx: int) -> None:
        """Each client's own mean train loss to the scheduler (a client
        without samples reports none), as the transport clients attach
        theirs to their uploads."""
        losses, counts = metrics["client_loss_sum"].tolist(), metrics["client_count"].tolist()
        for cid, s, c in zip(sampled, losses, counts):
            if c > 0:
                self.scheduler.report_loss(int(cid), float(s) / float(c))
        self._client_loss_rounds.add(int(round_idx))

    def _round_plan(self, round_idx: int) -> np.ndarray:
        """The round's cohort, memoized: the round, the backdoor harness's
        attack mask and the fault counters see one decision a round."""
        sampled = self._round_plans.get(round_idx)
        if sampled is None:
            sampled = self._round_plans[round_idx] = self._sample_clients(round_idx)
        return sampled

    def _sample_clients(self, round_idx: int) -> np.ndarray:
        """The scheduler's cohort less the clients the fault plan removes
        (DP-FedAvg draws its own cohorts instead)."""
        sel = self.scheduler.select(round_idx)
        if self.faults is not None:
            sel = self._apply_participation_faults(sel, round_idx)
        return sel

    def _apply_participation_faults(self, selected, round_idx: int) -> np.ndarray:
        """Dropout and crash remove a client from the cohort before
        batching. When every selected client faults, the first is spared
        (and no fault is recorded for it: it trains) so the round stays
        well-formed."""
        r = int(round_idx)
        decisions = [(int(cid), self.faults.decide(int(cid), r)) for cid in selected]
        survivors = [cid for cid, d in decisions if d.participates]
        spared = None
        if not survivors:
            spared = int(selected[0])
            survivors = [spared]
            logging.warning(
                "fault plan removed the ENTIRE round-%d cohort; sparing client %d so the "
                "round stays well-formed", r, spared,
            )
        for cid, d in decisions:
            if cid == spared or d.participates:
                continue
            self.faults.record(cid, r, "crash" if d.crashed else "dropout")
        return np.asarray(survivors, np.int64)

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

    def _noise_draw(self, round_idx: int) -> NoiseDraw:
        """The round's noise stream, for the hooks that add noise."""
        return functools.partial(self.noise_fn, round_idx, NOISE_FOLD)

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

    def local_test_on_all_clients(self, round_idx: int = 0) -> Dict[str, float]:
        """The global model on every client's data: train metrics over all
        clients' train shards, test metrics over their test shards (the
        central test set when the dataset has no per-client split). The
        reference's per-client sums weighted by sample counts equal one
        pooled pass, so the shards are concatenated. ``fed.ci`` evaluates
        client 0 only."""
        if self._local_eval_dev is None:
            # the pooled shards do not change between rounds: placed once
            ids = [0] if self.config.fed.ci else range(self.data.num_clients)
            xs = np.concatenate([self.data.client_x[i] for i in ids], axis=0)
            ys = np.concatenate([self.data.client_y[i] for i in ids], axis=0)
            self._local_eval_dev = {
                split: tuple(torch.from_numpy(a).to(self.device) for a in pad_to_batches(x, y, 256))
                for split, (x, y) in {"Train": (xs, ys), "Test": self._client_test_pool(ids)}.items()
            }
        row = {"round": round_idx}
        with fp32_math():
            for split, batches in self._local_eval_dev.items():
                loss, acc = metrics_to_loss_acc(self.eval_fn(self.global_vars, *batches))
                row[f"{split}/Loss"], row[f"{split}/Acc"] = loss, acc
        return row

    def _client_test_pool(self, ids):
        if self.data.client_test_x is not None:
            return (
                np.concatenate([self.data.client_test_x[i] for i in ids], axis=0),
                np.concatenate([self.data.client_test_y[i] for i in ids], axis=0),
            )
        return np.asarray(self.data.test_x), np.asarray(self.data.test_y)

    def _log_round(self, round_idx: int, sampled, metrics: Dict[str, float],
                   round_time_s: float) -> dict:
        count = float(metrics["count"])
        row = {
            "round": round_idx,
            "Train/Loss": float(metrics["loss_sum"]) / max(count, 1e-9),
            "Train/Acc": float(metrics["correct"]) / max(count, 1e-9),
            "round_time_s": round_time_s,
        }
        # a round without per-client losses gives every participant the
        # cohort mean (the loss map of the checkpoint's sched slot)
        if round_idx not in self._client_loss_rounds:
            for cid in sampled:
                self.scheduler.report_loss(int(cid), row["Train/Loss"])
        if self._is_eval_round(round_idx):
            if self.config.fed.eval_on_clients:
                # all clients' metrics replace the cohort's, as the
                # reference's rows have them
                local = self.local_test_on_all_clients(round_idx)
                row.update({k: v for k, v in local.items() if k != "round"})
            else:
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
            for cid in sampled:
                self.health.observe_train(int(cid), round_idx, dt)
            final = self._log_round(round_idx, sampled, dict(zip(_METRIC_KEYS, host)), dt)
        return final
