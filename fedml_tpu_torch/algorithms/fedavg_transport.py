"""Distributed FedAvg over the Message/Observer transport — cross-silo
federation (port of ``fedml_tpu/algorithms/fedavg_transport.py``, its plain
synchronous path).

The server runs the round FSM (all uploads received → weighted average →
optional FedOpt server step → eval → resample → broadcast); each client
actor trains its assigned client's shard and uploads. Participants talk
through any BaseCommManager (the in-process loopback hub, or shared memory
between processes of one host).

**Wire layout.** On the wire a model is the reference's: ``{"params":
<nested flax tree of numpy arrays>}`` with conv kernels HWIO and dense
kernels [in, out], keys sorted (:func:`wire_model`, built with
``bridge.to_flax``). Messages carry the reference's keys in the reference's
order, and the codecs (core/compression.py) run on that tree, so a
``fedml_tpu`` server takes a port client's uploads as they are, and the
reverse.

**Threads.** The client actors share the card. Each has its own copy of the
model's ``nn.Module``: ``torch.func.functional_call`` swaps the weights
into the module for the length of a call, so two threads calling it on one
module would run on each other's weights.

Beyond the reference's history row the server logs ``Train/Loss``, the
uploads' mean train loss weighted by their sample counts — the
simulator's ΣLoss/ΣCount. Not ported (each raises NotImplementedError
naming ROADMAP.md): secure aggregation and its dropout recovery, the
straggler deadline and quorum (``deadline_s``, ``min_clients``), fault
plans, overprovisioning, AOT warmup, the client health registry and the
flight recorder, and the gRPC and MQTT transports."""

from __future__ import annotations

import copy
import dataclasses
import logging
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import weighted_average
from fedml_tpu_torch.algorithms.fedopt import make_server_optimizer, make_server_step
from fedml_tpu_torch.bridge import from_flax, to_flax
from fedml_tpu_torch.config import RunConfig
from fedml_tpu_torch.core import compression as CZ
from fedml_tpu_torch.core.comm import BaseCommManager
from fedml_tpu_torch.core.loopback import LoopbackCommManager, LoopbackHub
from fedml_tpu_torch.core.managers import ClientManager, ServerManager
from fedml_tpu_torch.core.message import Message, MessageType as MT
from fedml_tpu_torch.data.base import FederatedDataset, bucket_steps, stack_clients
from fedml_tpu_torch.device import DeviceLike, fp32_math, resolve_device
from fedml_tpu_torch.models import ModelDef
from fedml_tpu_torch.scheduler import ClientScheduler
from fedml_tpu_torch.telemetry import get_comm_meter, get_tracer
from fedml_tpu_torch.telemetry.wire import beacon_nbytes, build_beacon
from fedml_tpu_torch.train.client import PermFn, make_local_train, seeded_perm_fn
from fedml_tpu_torch.train.evaluate import make_eval_fn, metrics_to_loss_acc, pad_to_batches

Variables = Dict[str, torch.Tensor]


def _check_ported(config: RunConfig) -> None:
    """Raise NotImplementedError for what the port's transport does not do
    yet (selection policies and overprovisioning raise in the scheduler)."""
    fed, comm = config.fed, config.comm
    missing = {
        "secure aggregation (comm.secure_agg) and its dropout recovery": comm.secure_agg,
        "straggler deadlines and quorum rounds (fed.deadline_s, fed.min_clients)": fed.deadline_s,
        "fault injection (fed.fault_plan)": fed.fault_plan,
    }
    for what, asked in missing.items():
        if asked:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md)")
    if comm.downlink_compression not in ("none", "int8"):
        raise ValueError(
            f"downlink_compression supports 'none' or 'int8'; got {comm.downlink_compression!r}"
        )


def wire_model(variables: Variables) -> dict:
    """Port variables → the model as it goes on the wire."""
    return {"params": to_flax(variables)}


def model_vars(wire: dict, device: torch.device) -> Variables:
    """The model from the wire → port variables on ``device``."""
    return {k: v.to(device) for k, v in from_flax(wire["params"]).items()}


def _own_copy(model: ModelDef) -> ModelDef:
    """The model with a module of its own (see the module docstring)."""
    return dataclasses.replace(model, module=copy.deepcopy(model.module))


def _model_wire_cost(tree) -> tuple:
    """(as-shipped, float32-equivalent) bytes of one model."""
    leaves = CZ.tree_leaves(tree)
    return sum(int(a.nbytes) for a in leaves), 4 * sum(int(np.size(a)) for a in leaves)


class FedAvgAggregator:
    """Server-side accumulate + sample-weighted average, in worker-index
    order, so the order uploads arrive in never changes the numbers."""

    def __init__(self, worker_num: int):
        self.worker_num = worker_num
        self.model_dict: Dict[int, Variables] = {}
        self.sample_num_dict: Dict[int, float] = {}

    def add_local_trained_result(self, index: int, variables: Variables, num_samples: float) -> None:
        self.model_dict[index] = variables
        self.sample_num_dict[index] = float(num_samples)

    def check_whether_all_receive(self) -> bool:
        return len(self.model_dict) == self.worker_num

    def received_count(self) -> int:
        return len(self.model_dict)

    def aggregate(self) -> Variables:
        idxs = sorted(self.model_dict)
        first = self.model_dict[idxs[0]]
        stacked = {k: torch.stack([self.model_dict[i][k] for i in idxs]) for k in first}
        weights = torch.tensor(
            [self.sample_num_dict[i] for i in idxs], dtype=torch.float32,
            device=next(iter(first.values())).device,
        )
        avg = weighted_average(stacked, weights)
        self.model_dict.clear()
        self.sample_num_dict.clear()
        return avg


class LocalTrainer:
    """Client-side trainer: ``update_dataset(client_index)``, then
    ``train(round, variables) -> (variables', num_samples)``.

    The client's shard is stacked with the reference's seed
    ``seed·1_000_003 + round·8191 + client_index`` and shuffled each epoch by
    ``perm_fn(round, client_index, epoch, mask_flat)`` — keyed by the client
    index, as the reference folds ``(round+1)·7919 + client_index`` into its
    key, so every client of a round draws its own permutation. The default
    is :func:`seeded_perm_fn` of the run seed."""

    def __init__(
        self,
        config: RunConfig,
        data: FederatedDataset,
        model: ModelDef,
        task: str = "classification",
        device: DeviceLike = None,
        perm_fn: Optional[PermFn] = None,
    ):
        self.config = config
        self.data = data
        self.model = _own_copy(model)
        self.device = resolve_device(device)
        self.local_train = make_local_train(self.model, config.train, config.fed.epochs, task=task)
        self.perm_fn = perm_fn or seeded_perm_fn(config.seed)
        self.client_index = 0
        # the last local mean train loss, attached to the upload
        self.last_loss: Optional[float] = None

    def update_dataset(self, client_index: int):
        self.client_index = int(client_index)

    def train(self, round_idx: int, variables: Variables):
        with get_tracer().span("local_train", client=self.client_index, round=int(round_idx)):
            return self._train(int(round_idx), variables)

    def _train(self, round_idx: int, variables: Variables):
        cfg, ci, dev = self.config, self.client_index, self.device
        batch = stack_clients(
            self.data, [ci], cfg.data.batch_size,
            seed=cfg.seed * 1_000_003 + round_idx * 8191 + ci,
            pad_bucket=cfg.data.pad_bucket,
        )
        mask_host = torch.as_tensor(batch.mask[0])

        def epoch_perm(epoch, m_flat):
            return self.perm_fn(round_idx, ci, epoch, m_flat)

        with fp32_math():
            new_vars, m = self.local_train(
                variables,
                torch.as_tensor(batch.x[0]).to(dev),
                torch.as_tensor(batch.y[0]).to(dev),
                mask_host.to(dev),
                epoch_perm,
                mask_host=mask_host,
            )
        count = float(m["count"])
        # a zero-sample shard has no loss signal: None, as the reference
        self.last_loss = float(m["loss_sum"]) / count if count > 0 else None
        return new_vars, len(self.data.client_y[ci])


def actor_order_perm_fn(config: RunConfig, data: FederatedDataset) -> PermFn:
    """``perm_fn`` for the simulator (FedAvgAPI, FedOptAPI) that trains
    each sampled client on the minibatches its client actor takes here, so
    the two runtimes can be held to each other at any batch size.

    They stack a client's rows in other orders (one generator over the
    cohort, seeded ``seed·1_000_003 + round``, against one a client,
    ``seed·1_000_003 + round·8191 + client_index``) and key their shuffles
    by cohort slot against client index. This maps the actor's epoch order
    (its stacked rows under :func:`seeded_perm_fn` keyed by the client
    index, the cohort taken from the scheduler) onto the simulator's
    stacked rows; padding follows, so both take the same steps."""
    sched = ClientScheduler.from_config(config, num_clients=data.num_clients)
    actor_perm = seeded_perm_fn(config.seed)
    sizes = [len(y) for y in data.client_y]

    def stacked_rows(seed, clients):  # each client's row order, as stack_clients draws it
        rng = np.random.default_rng(seed)
        return [rng.permutation(sizes[c]) for c in clients]

    def perm_fn(round_idx, slot, epoch, m_flat):
        cohort = [int(c) for c in sched.select(round_idx)]
        ci, n = cohort[slot], sizes[cohort[slot]]
        sim_rows = stacked_rows(config.seed * 1_000_003 + round_idx, cohort)[slot]
        (actor_rows,) = stacked_rows(config.seed * 1_000_003 + round_idx * 8191 + ci, [ci])
        cap = bucket_steps([n], config.data.batch_size, config.data.pad_bucket)[2]
        m_actor = (torch.arange(cap) < n).float()
        rows = actor_rows[actor_perm(round_idx, ci, epoch, m_actor)[:n].numpy()]
        slot_of_row = np.empty(n, dtype=np.int64)
        slot_of_row[sim_rows] = np.arange(n)
        return torch.cat([torch.from_numpy(slot_of_row[rows]), torch.arange(n, len(m_flat))])

    return perm_fn


class FedAvgServerManager(ServerManager):
    """The round FSM. ``server_opt`` steps the FedOpt server optimizer
    (``config.server``) on each round's pseudo-gradient. ``init_vars``
    (port variables) replaces the model's seeded init."""

    def __init__(
        self,
        config: RunConfig,
        comm: BaseCommManager,
        model: ModelDef,
        data: Optional[FederatedDataset] = None,
        task: str = "classification",
        log_fn: Optional[Callable[[dict], None]] = None,
        server_opt: bool = False,
        device: DeviceLike = None,
        init_vars: Optional[Variables] = None,
    ):
        _check_ported(config)
        self.device = resolve_device(device)
        self.scheduler = ClientScheduler.from_config(config, num_clients=config.fed.client_num_in_total)
        super().__init__(comm, rank=0, config=config)
        self.config = config
        self.model = _own_copy(model)
        self.data = data
        self.log_fn = log_fn or (lambda m: None)
        self.worker_num = config.fed.client_num_per_round
        self.aggregator = FedAvgAggregator(self.worker_num)
        self._server_step = None
        self._server_opt_state = None
        if server_opt:
            self._server_optimizer = make_server_optimizer(config.server)
            self._server_step = make_server_step(self._server_optimizer)
        self.round_idx = 0
        self._round_lock = threading.Lock()
        if init_vars is None:
            init_vars = model.init(torch.Generator().manual_seed(config.seed))
        self.global_vars: Variables = {k: v.to(self.device) for k, v in init_vars.items()}
        # the round's model as the clients received it: compressed uploads
        # decode against it
        self._round_wire: Optional[dict] = None
        self._round_losses: Dict[int, tuple] = {}
        self.history: List[dict] = []
        self._eval_fn = make_eval_fn(self.model, task) if data is not None else None
        self._test_dev = None
        self._tracer = get_tracer()
        self._round_span = None
        self.dropped_uploads = 0  # uploads tagged with a closed round
        self._dead_workers: set = set()

    @property
    def health(self):
        raise NotImplementedError("the client health registry is not ported yet (ROADMAP.md)")

    def _broadcast(self, msg: Message) -> bool:
        """Send a server->client message, tolerating a dead peer: a worker
        whose send failed is remembered and skipped until it is heard from
        again."""
        worker = msg.get_receiver_id()
        if worker in self._dead_workers:
            logging.info("skipping broadcast to dead worker %d", worker)
            return False
        try:
            self.send_message(msg)
            return True
        except Exception as e:  # noqa: BLE001 — transport errors vary by backend
            self._dead_workers.add(worker)
            logging.warning("broadcast to worker %d failed (%s)", worker, e)
            return False

    def send_init_msg(self):
        """Sample the opening round's clients and broadcast the model."""
        self._t0 = time.monotonic()
        with self._round_lock:
            self._start_round(MT.S2C_INIT_CONFIG)

    def _start_round(self, msg_type: str):
        r = self.round_idx
        sampled = self.scheduler.select(r)
        self._round_span = self._tracer.start_span("round", round=r)
        with self._tracer.span("broadcast", round=r):
            self._broadcast_round(msg_type, r, sampled)

    def _broadcast_round(self, msg_type: str, round_idx: int, sampled):
        """Ship the round's model to the cohort, encoded ONCE per round:
        every worker's message references the same host buffers. With
        ``downlink_compression="int8"`` the dequantized model becomes the
        round's reference model, so both wire ends start from the same
        numbers."""
        host = wire_model(self.global_vars)
        dl = self.config.comm.downlink_compression
        payload = None
        if dl != "none":
            payload = CZ.encode_delta(host, dl, self.config.comm.topk_frac)
            host = CZ.decode_delta(payload, host, dl)
            self.global_vars = model_vars(host, self.device)
            shipped = CZ.payload_bytes(payload)
            raw = 4 * sum(int(np.size(a)) for a in CZ.tree_leaves(host))
        else:
            shipped, raw = _model_wire_cost(host)
        self._round_wire = host
        for worker, client_idx in enumerate(sampled, start=1):
            msg = Message(msg_type, 0, worker)
            if payload is not None:
                msg.add_params(MT.ARG_MODEL_QUANT, payload)
                msg.add_params(MT.ARG_MODEL_CODEC, dl)
            else:
                msg.add_params(MT.ARG_MODEL_PARAMS, host)
            msg.add_params(MT.ARG_CLIENT_INDEX, int(client_idx))
            msg.add_params(MT.ARG_ROUND_IDX, round_idx)
            if self._broadcast(msg):
                get_comm_meter().on_downlink(shipped, raw)

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MT.C2S_SEND_MODEL, self._on_model_from_client)

    def _on_model_from_client(self, msg: Message):
        self._dead_workers.discard(msg.get_sender_id())
        with self._round_lock:
            # an untagged upload fails safe: -1 never matches a round
            upload_round = msg.get(MT.ARG_ROUND_IDX, -1)
            if upload_round != self.round_idx:
                self.dropped_uploads += 1
                return
            params = msg.get(MT.ARG_MODEL_PARAMS)
            if params is None:
                # compressed uplink: reconstruct against this round's model,
                # decoding by the message's codec tag
                payload, method = msg.get(MT.ARG_MODEL_DELTA), msg.get(MT.ARG_COMPRESSION)
                if payload is None or method is None:
                    raise ValueError(
                        f"model upload from sender {msg.get_sender_id()} carries neither "
                        "model_params nor a tagged compressed delta"
                    )
                params = CZ.decode_update(payload, self._round_wire, method)
            worker = msg.get_sender_id() - 1
            n = msg.get(MT.ARG_NUM_SAMPLES)
            self.aggregator.add_local_trained_result(worker, model_vars(params, self.device), n)
            self._round_losses[worker] = (msg.get(MT.ARG_TRAIN_LOSS), float(n))
            if self.aggregator.check_whether_all_receive():
                self._complete_round()

    def _train_loss(self) -> Optional[float]:
        """The uploads' train losses weighted by their sample counts (None
        when an upload carried none)."""
        pairs = list(self._round_losses.values())
        self._round_losses = {}
        if not pairs or any(loss is None for loss, _ in pairs):
            return None
        return sum(loss * n for loss, n in pairs) / max(sum(n for _, n in pairs), 1e-9)

    def _eval_batches(self):
        if self._test_dev is None:
            xb, yb, mb = pad_to_batches(np.asarray(self.data.test_x), np.asarray(self.data.test_y), 256)
            self._test_dev = tuple(torch.from_numpy(a).to(self.device) for a in (xb, yb, mb))
        return self._test_dev

    def _complete_round(self):
        """Aggregate, step the server optimizer, eval, then broadcast the
        next round or FINISH. Caller holds _round_lock."""
        r = self.round_idx
        with self._tracer.span("aggregate", round=r, n_uploads=self.aggregator.received_count()):
            with fp32_math():
                avg = self.aggregator.aggregate()
            if self._server_step is not None:
                if self._server_opt_state is None:
                    self._server_opt_state = self._server_optimizer.init(self.global_vars)
                self.global_vars, self._server_opt_state = self._server_step(
                    self.global_vars, avg, self._server_opt_state
                )
            else:
                self.global_vars = avg
        row = {"round": r, "t_s": round(time.monotonic() - self._t0, 3)}
        train_loss = self._train_loss()
        if train_loss is not None:
            row["Train/Loss"] = train_loss
        fed = self.config.fed
        if self.data is not None and (r % fed.frequency_of_the_test == 0 or r == fed.comm_round - 1):
            with self._tracer.span("eval", round=r), fp32_math():
                row["Test/Loss"], row["Test/Acc"] = metrics_to_loss_acc(
                    self._eval_fn(self.global_vars, *self._eval_batches())
                )
        self.history.append(row)
        self.log_fn(row)
        self._round_span.end()
        self.round_idx += 1
        if self.round_idx >= fed.comm_round:
            for worker in range(1, self.worker_num + 1):
                self._broadcast(Message(MT.FINISH, 0, worker))
            self.finish()
            return
        self._start_round(MT.S2C_SYNC_MODEL)


class FedAvgClientManager(ClientManager):
    """A client actor: train on each sync, upload the model (or its
    compressed delta) with the sample count, round tag, train loss and a
    telemetry beacon. ``ef`` is the error-feedback store, shared by all the
    actors of a federation since residuals follow the client, not the
    worker slot."""

    def __init__(self, config: RunConfig, comm: BaseCommManager, rank: int,
                 trainer: LocalTrainer, ef=None):
        super().__init__(comm, rank, config=config)
        self.config = config
        self.trainer = trainer
        self._ef = ef if ef is not None else CZ.ErrorFeedback.maybe_from_config(config.comm)
        # quantized-downlink decode template (leaf shapes and order only)
        self._downlink_template = None

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MT.S2C_INIT_CONFIG, self._on_sync)
        self.register_message_receive_handler(MT.S2C_SYNC_MODEL, self._on_sync)
        self.register_message_receive_handler(MT.FINISH, lambda m: self.finish())

    def _on_sync(self, msg: Message):
        trainer = self.trainer
        trainer.update_dataset(msg.get(MT.ARG_CLIENT_INDEX))
        round_idx = msg.get(MT.ARG_ROUND_IDX)
        w_round = msg.get(MT.ARG_MODEL_PARAMS)
        if w_round is None:
            payload, codec = msg.get(MT.ARG_MODEL_QUANT), msg.get(MT.ARG_MODEL_CODEC)
            if payload is None or codec is None:
                raise ValueError(
                    f"model sync for round {round_idx} carries neither model_params nor a "
                    "codec-tagged quantized payload"
                )
            if self._downlink_template is None:
                self._downlink_template = wire_model(
                    trainer.model.init(torch.Generator().manual_seed(0))
                )
            w_round = CZ.decode_delta(payload, self._downlink_template, codec)
        t_train = time.perf_counter()
        new_vars, n = trainer.train(round_idx, model_vars(w_round, trainer.device))
        weights = wire_model(new_vars)
        train_s = time.perf_counter() - t_train
        comp = self.config.comm.compression
        meter = get_comm_meter()
        out = Message(MT.C2S_SEND_MODEL, self.rank, 0)
        leaves = CZ.tree_leaves(weights)
        # float32-equivalent cost of the update: 4 B × element count
        raw_bytes = 4 * sum(int(np.size(a)) for a in leaves)
        encode_s = 0.0
        if comp != "none":
            t_enc = time.perf_counter()
            if self._ef is not None:
                payload = self._ef.encode(trainer.client_index, weights, w_round)
            else:
                payload = CZ.encode_update(weights, w_round, comp, self.config.comm.topk_frac)
            encode_s = time.perf_counter() - t_enc
            meter.on_uplink(CZ.payload_bytes(payload), raw_bytes)
            out.add_params(MT.ARG_MODEL_DELTA, payload)
            out.add_params(MT.ARG_COMPRESSION, comp)
        else:
            meter.on_uplink(sum(int(a.nbytes) for a in leaves), raw_bytes)
            out.add_params(MT.ARG_MODEL_PARAMS, weights)
        out.add_params(MT.ARG_NUM_SAMPLES, n)
        out.add_params(MT.ARG_ROUND_IDX, round_idx)
        if trainer.last_loss is not None:
            out.add_params(MT.ARG_TRAIN_LOSS, float(trainer.last_loss))
        if self.config.comm.beacons:
            beacon = build_beacon(
                train_s=train_s, encode_s=encode_s,
                retries=sum(meter.snapshot()["send_retries"].values()), codec=comp,
            )
            out.add_params(MT.ARG_TELEMETRY, beacon)
            meter.on_beacon(beacon_nbytes(beacon))
        self.send_message(out)


def run_federation(
    config: RunConfig,
    data: FederatedDataset,
    model: ModelDef,
    comm_factory: Callable[[int], BaseCommManager],
    task: str = "classification",
    log_fn: Optional[Callable[[dict], None]] = None,
    trainer_factory: Optional[Callable[[int], LocalTrainer]] = None,
    server_opt: bool = False,
    warmup: bool = False,
    device: DeviceLike = None,
    init_vars: Optional[Variables] = None,
) -> FedAvgServerManager:
    """One-process federation over any transport: a server and
    ``client_num_per_round`` client actors in threads, each on
    ``comm_factory(rank)``. Blocks until the last round, re-raises an
    error from any actor, and returns the server manager (``global_vars``,
    ``history``). ``device=None`` runs every actor on the card."""
    if warmup:
        raise NotImplementedError("AOT warmup is not ported yet (ROADMAP.md)")
    dev = resolve_device(device)
    server = FedAvgServerManager(
        config, comm_factory(0), model, data=data, task=task, log_fn=log_fn,
        server_opt=server_opt, device=dev, init_vars=init_vars,
    )
    shared_ef = CZ.ErrorFeedback.maybe_from_config(config.comm)
    make_trainer = trainer_factory or (
        lambda rank: LocalTrainer(config, data, model, task, device=dev)
    )
    clients = [
        FedAvgClientManager(config, comm_factory(rank), rank, make_trainer(rank), ef=shared_ef)
        for rank in range(1, config.fed.client_num_per_round + 1)
    ]
    errors: List[BaseException] = []

    def guarded_run(c):
        # a dead client would stall the server's barrier: stop the server
        try:
            c.run()
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
            server.finish()

    threads = [
        threading.Thread(target=guarded_run, args=(c,), daemon=True, name=f"fedml-client-{c.rank}")
        for c in clients
    ]
    for t in threads:
        t.start()
    try:
        server.send_init_msg()
        server.run()
    except BaseException:
        for c in clients:
            c.finish()
        raise
    if errors:
        for c in clients:
            c.finish()
        raise RuntimeError("client actor failed") from errors[0]
    for t in threads:
        t.join(timeout=60)
        if t.is_alive():
            raise RuntimeError("client thread failed to finish")
    return server


def run_loopback_federation(
    config: RunConfig, data: FederatedDataset, model: ModelDef, task: str = "classification",
    log_fn=None, server_opt: bool = False, warmup: bool = False, **kw,
) -> FedAvgServerManager:
    """Federation over the in-process loopback hub (see run_federation)."""
    hub = LoopbackHub()
    return run_federation(
        config, data, model, lambda rank: LoopbackCommManager(hub, rank), task=task,
        log_fn=log_fn, server_opt=server_opt, warmup=warmup, **kw,
    )


def run_shm_federation(
    config: RunConfig, data: FederatedDataset, model: ModelDef, task: str = "classification",
    log_fn=None, sock_dir: Optional[str] = None, server_opt: bool = False,
    warmup: bool = False, namespace: str = "", **kw,
) -> FedAvgServerManager:
    """Federation over the shared-memory transport: bulk bytes ride POSIX
    shared memory, only small control records cross the per-rank UNIX
    sockets. ``namespace`` must be unique per federation when two
    concurrent runs share an explicit ``sock_dir``."""
    from fedml_tpu_torch.core.shm_comm import ShmCommManager

    with tempfile.TemporaryDirectory(prefix="fedml_shm_") as d:
        return run_federation(
            config, data, model,
            lambda rank: ShmCommManager(rank, sock_dir or d, namespace=namespace),
            task=task, log_fn=log_fn, server_opt=server_opt, warmup=warmup, **kw,
        )


def run_mqtt_federation(*args, **kwargs):
    """The MQTT transport is not ported (ROADMAP.md)."""
    raise NotImplementedError("the MQTT and gRPC transports are not ported yet (ROADMAP.md)")
