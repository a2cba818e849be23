"""Distributed FedAvg over the Message/Observer transport — cross-silo
federation (port of ``fedml_tpu/algorithms/fedavg_transport.py``).

The server runs the round FSM (all uploads received, or a quorum once the
straggler deadline has passed → weighted average → optional FedOpt server
step → eval → resample → broadcast); each client actor trains its assigned
client's shard and uploads. Participants talk through any BaseCommManager:
the in-process loopback hub, shared memory between processes of one host,
MQTT (an embedded broker, or any MQTT 3.1.1 broker over TCP) or gRPC.

**Wire layout.** On the wire a model is the reference's: ``{"params":
<nested flax tree of numpy arrays>}`` with conv kernels HWIO and dense
kernels [in, out], and a BatchNorm model's ``"batch_stats"`` beside it,
keys sorted (:func:`wire_model`, built with ``bridge.to_flax_variables``).
Messages carry the reference's keys in the reference's order, and the
codecs (core/compression.py) and the secure-aggregation masks (secagg/)
run on that tree, so a ``fedml_tpu`` server takes a port client's uploads
as they are, and the reverse.

**Rounds that lose clients.** ``fed.deadline_s`` arms a timer at each
broadcast; once it passes, ``fed.min_clients`` uploads close the round and
a late upload, tagged with a closed round, is dropped
(``dropped_uploads``). A ``fed.fault_plan`` (scheduler/faults.py) is parsed
once into one injector that the client actors (crash, dropout, slowdown,
flaky upload) and the server's stall valve share: under a plan that can
drop uploads, a round with no new upload over three deadlines is abandoned
(``abandoned_rounds``). ``comm.secure_agg`` runs the pairwise-masked round
(secagg/secure_aggregation.py): keys advertised, registry relayed, masked
uploads, and survivors' recovery masks for parties that dropped after the
registry went out.

**Threads.** The client actors share the card. Each has its own copy of the
model's ``nn.Module``: ``torch.func.functional_call`` swaps the weights
into the module for the length of a call, so two threads calling it on one
module would run on each other's weights.

The history row holds the reference's keys: ``round``, ``t_s`` and, on eval
rounds, ``Test/Loss`` and ``Test/Acc``. The uploads' train loss weighted by
their sample counts (the simulator's ΣLoss/ΣCount; None for a round whose
uploads carried none) goes to the server's ``train_losses``, one entry a
round; each round's cohort goes to ``log_fn`` as the scheduler's
``scheduler/policy``/``scheduler/selected`` row, and each upload's train
loss to the scheduler's loss map (power-of-choice's signal). With
``fed.overprovision_factor`` the federation has one worker for each of
``ceil(client_num_per_round · factor)`` slots.

**Health.** The server's client health registry (``server.health``)
feeds on the tracer's ``local_train`` spans (in-process actors record
their true train time) and on each upload's broadcast→upload round trip
(the only timing a server across processes can see); the (client, round)
dedupe lets the span win. ``straggler_aware`` reads it, and the fault
injector records into it. Not ported (raising NotImplementedError naming
ROADMAP.md): AOT warmup and the flight recorder."""

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
from fedml_tpu_torch.bridge import from_flax, to_flax_variables
from fedml_tpu_torch.config import RunConfig
from fedml_tpu_torch.core import compression as CZ
from fedml_tpu_torch.core.comm import BaseCommManager
from fedml_tpu_torch.core.loopback import LoopbackCommManager, LoopbackHub
from fedml_tpu_torch.core.managers import ClientManager, ServerManager
from fedml_tpu_torch.core.message import Message, MessageType as MT
from fedml_tpu_torch.data.base import FederatedDataset, bucket_steps, stack_clients
from fedml_tpu_torch.device import DeviceLike, fp32_math, resolve_device
from fedml_tpu_torch.models import ModelDef, split_stats
from fedml_tpu_torch.scheduler import ClientScheduler, FaultInjector, FaultPlan
from fedml_tpu_torch.secagg.secure_aggregation import ClientParty, ServerAggregator, tree_dim
from fedml_tpu_torch.telemetry import ClientHealthRegistry, get_comm_meter, get_tracer
from fedml_tpu_torch.telemetry.wire import beacon_nbytes, build_beacon
from fedml_tpu_torch.train.client import PermFn, client_step_seed, make_local_train, seeded_perm_fn
from fedml_tpu_torch.train.evaluate import make_eval_fn, metrics_to_loss_acc, pad_to_batches

Variables = Dict[str, torch.Tensor]


def _check_config(config: RunConfig, worker_num: int) -> None:
    """The reference server's constructor checks. What the port does not
    have yet raises NotImplementedError where it is reached: AOT warmup in
    :func:`run_federation`."""
    comm = config.comm
    # clients size the mask registry from client_num_per_round, the only
    # value they have: another worker count would not cancel the masks
    if comm.secure_agg and worker_num != config.fed.client_num_per_round:
        raise ValueError(
            f"secure_agg requires worker_num ({worker_num}) == client_num_per_round "
            f"({config.fed.client_num_per_round}): clients derive the mask registry from the latter"
        )
    if comm.downlink_compression not in ("none", "int8"):
        raise ValueError(
            f"downlink_compression supports 'none' or 'int8'; got {comm.downlink_compression!r}"
        )
    if comm.secure_agg and comm.downlink_compression != "none":
        # masked uploads are field vectors over the exact broadcast model
        raise ValueError("secure_agg and downlink_compression are mutually exclusive")


def wire_model(variables: Variables) -> dict:
    """Port variables → the model as it goes on the wire."""
    return to_flax_variables(variables)


def model_vars(wire: dict, device: torch.device) -> Variables:
    """The model from the wire → port variables on ``device``."""
    return {k: v.to(device) for k, v in from_flax(wire).items()}


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
                step_seed=client_step_seed(cfg.seed, round_idx, ci),
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
    sched = ClientScheduler.from_config(config, num_clients=data.num_clients, data=data)
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
    (port variables) replaces the model's seeded init. ``faults`` is the
    federation's one :class:`FaultInjector`: its plan arms the stall valve
    (see the module docstring). ``worker_num``, the number of client
    actors, is the scheduler's cohort size: ``client_num_per_round``
    overprovisioned by ``overprovision_factor``, one actor a slot."""

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
        faults: Optional[FaultInjector] = None,
    ):
        self.log_fn = log_fn or (lambda m: None)
        self._tracer = get_tracer()
        # detached in finish(): sequential federations in one process must
        # not pile up listeners on the tracer
        self.health = ClientHealthRegistry.from_config(config).attach(self._tracer)
        self.scheduler = ClientScheduler.from_config(
            config, num_clients=config.fed.client_num_in_total, data=data, log_fn=self.log_fn,
            health=self.health,
        )
        self.worker_num = self.scheduler.cohort_size()
        _check_config(config, self.worker_num)
        self.device = resolve_device(device)
        super().__init__(comm, rank=0, config=config)
        self.config = config
        self.model = _own_copy(model)
        self.data = data
        self.aggregator = FedAvgAggregator(self.worker_num)
        self._server_step = None
        self._server_opt_state = None
        if server_opt:
            self._server_optimizer = make_server_optimizer(config.server)
            self._server_step = make_server_step(self._server_optimizer)
        self.round_idx = 0
        # the deadline timer races the comm receive loop: _round_lock
        # serializes round completion
        self._round_lock = threading.Lock()
        self._deadline_timer: Optional[threading.Timer] = None
        self._deadline_passed = False
        # the stall valve is armed only under a plan that can drop uploads:
        # without one every sampled client eventually uploads, and the
        # quorum-th upload closes the round whenever it arrives
        self.faults = faults
        plan = faults.plan if faults is not None else FaultPlan.from_config(config)
        self._stall_valve = plan is not None and plan.has_participation_faults()
        self._stall_last_count = -1
        self._stall_strikes = 0
        self.abandoned_rounds = 0
        self.dropped_uploads = 0  # uploads tagged with a closed round
        self._dead_workers: set = set()  # peers whose broadcasts failed
        self.deadline_error: Optional[BaseException] = None
        # secure aggregation: masked field vectors and sample counts by
        # party (rank - 1), the round's public keys, and the recovery
        # exchange for parties that dropped after the registry went out
        self._masked_uploads: Dict[int, np.ndarray] = {}
        self._masked_ns: Dict[int, float] = {}
        self._round_pks: Dict[int, int] = {}
        self._recovery_pending = False
        self._recovery_vecs: Dict[int, np.ndarray] = {}
        self._recovery_requested_for = None  # the dropped set last asked about
        self._registry_sent = False
        if init_vars is None:
            init_vars = model.init(torch.Generator().manual_seed(config.seed))
        self.global_vars: Variables = {k: v.to(self.device) for k, v in init_vars.items()}
        # the round's model as the clients received it: compressed and
        # masked uploads decode against it
        self._round_wire: Optional[dict] = None
        self._round_losses: Dict[int, tuple] = {}
        self._assigned: Dict[int, int] = {}  # worker -> the client it trains this round
        self._bcast_t = 0.0  # the round's broadcast time (health's round trip)
        self.history: List[dict] = []
        # the uploads' sample-weighted train loss, one entry a round
        self.train_losses: List[Optional[float]] = []
        self._eval_fn = make_eval_fn(self.model, task) if data is not None else None
        self._test_dev = None
        self._round_span = None

    def finish(self):
        self.health.detach()  # queries on self.health keep working
        super().finish()

    def _broadcast(self, msg: Message) -> bool:
        """Send a server->client message, tolerating a dead peer: a worker
        whose send failed is remembered and skipped until it is heard from
        again (the deadline and quorum absorb its missing upload)."""
        worker = msg.get_receiver_id()
        if worker in self._dead_workers:
            logging.info("skipping broadcast to dead worker %d", worker)
            return False
        try:
            self.send_message(msg)
            return True
        except Exception as e:  # noqa: BLE001 — transport errors vary by backend
            self._dead_workers.add(worker)
            logging.warning("broadcast to worker %d failed (%s) — continuing on quorum", worker, e)
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
        self._arm_deadline()

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
        self._assigned = {worker: int(c) for worker, c in enumerate(sampled, start=1)}
        self._bcast_t = time.monotonic()
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
        self.register_message_receive_handler(MT.C2S_PUBKEY, self._on_pubkey)
        self.register_message_receive_handler(MT.C2S_RECOVERY, self._on_recovery)

    # -- secure aggregation: advertise keys -> masked input -> unmask; the
    #    server relays public keys and never holds a party secret --
    def _send_registry(self):
        """Broadcast the public keys of the parties heard so far. Caller
        holds _round_lock. A party that never advertised a key is not in
        the round's mask algebra, so a client dead before its key cannot
        deadlock the key phase."""
        self._registry_sent = True
        parties = sorted(self._round_pks)
        for p in parties:
            out = Message(MT.S2C_PUBKEYS, 0, p + 1)
            out.add_params(MT.ARG_ROUND_IDX, self.round_idx)
            out.add_params(MT.ARG_PUBKEY_REGISTRY,
                           {"parties": parties, "pks": [self._round_pks[q] for q in parties]})
            self._broadcast(out)

    def _on_pubkey(self, msg: Message):
        self._dead_workers.discard(msg.get_sender_id())
        with self._round_lock:
            if msg.get(MT.ARG_ROUND_IDX, -1) != self.round_idx:
                return
            if self._registry_sent:
                # the registry is sealed: a late advertiser was never part
                # of the mask algebra
                self.dropped_uploads += 1
                return
            self._round_pks[msg.get_sender_id() - 1] = int(msg.get(MT.ARG_PUBKEY))
            if len(self._round_pks) == self.worker_num or (
                self._deadline_passed and len(self._round_pks) >= self._quorum()
            ):
                self._send_registry()

    def _on_recovery(self, msg: Message):
        self._dead_workers.discard(msg.get_sender_id())
        with self._round_lock:
            if msg.get(MT.ARG_ROUND_IDX, -1) != self.round_idx:
                return
            answered = set(map(int, msg.get(MT.ARG_DROPPED) or ()))
            if self._recovery_requested_for is None or answered != set(self._recovery_requested_for):
                # an answer for an earlier, smaller dropped set would leave
                # the newly dropped parties' masks in the sum
                return
            self._recovery_vecs[msg.get_sender_id() - 1] = np.asarray(
                msg.get(MT.ARG_RECOVERY_VEC), np.int64
            )
            if self._recovery_pending and set(self._recovery_vecs) >= set(self._masked_uploads):
                self._complete_round()

    def _on_recovery_deadline(self, armed_round: int):
        """A survivor that never answered its recovery request (it died
        after uploading) becomes a dropped party itself: its upload goes
        and the exchange restarts with the rest. The survivors strictly
        shrink, so this ends."""
        try:
            with self._round_lock:
                if armed_round != self.round_idx or not self._recovery_pending:
                    return
                for p in set(self._masked_uploads) - set(self._recovery_vecs):
                    self._masked_uploads.pop(p, None)
                    self._masked_ns.pop(p, None)
                self._recovery_requested_for = None  # force a new request
                self._complete_round()
        except BaseException as e:  # noqa: BLE001 — see _on_deadline
            self.deadline_error = e
            self.finish()

    # -- straggler deadline (fed.deadline_s) and quorum (fed.min_clients) --
    def _timer(self, fn, *args, delay: Optional[float] = None) -> threading.Timer:
        t = threading.Timer(self.config.fed.deadline_s if delay is None else delay, fn, args=args)
        t.daemon = True
        t.start()
        return t

    def _arm_deadline(self):
        if not self.config.fed.deadline_s:
            return
        self._deadline_passed = False
        self._stall_last_count = -1
        self._stall_strikes = 0
        # the round is captured at arm time: cancel() cannot stop a callback
        # already waiting on _round_lock, so a stale timer must see that
        # its round has closed
        self._deadline_timer = self._timer(self._on_deadline, self.round_idx)

    def _disarm_deadline(self):
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
            self._deadline_timer = None
        self._deadline_passed = False

    def _quorum(self) -> int:
        return max(1, min(self.config.fed.min_clients, self.worker_num))

    def _received_count(self) -> int:
        if self.config.comm.secure_agg:
            return len(self._masked_uploads)
        return self.aggregator.received_count()

    def _on_deadline(self, armed_round: int):
        try:
            with self._round_lock:
                if armed_round != self.round_idx:
                    return  # stale timer: its round already closed
                self._deadline_passed = True
                if (self.config.comm.secure_agg and not self._registry_sent
                        and len(self._round_pks) >= self._quorum()):
                    # the key phase waits on a client that died before its
                    # key: go on with the parties heard so far
                    self._send_registry()
                    return
                n = self._received_count()
                if n >= self._quorum():
                    self._complete_round()
                    return
                if not self._stall_valve:
                    return  # the quorum-th upload closes the round on arrival
                # below quorum under a plan that drops uploads: three
                # deadlines in a row with no new upload abandon the round
                # with what arrived (possibly nothing: the model carries
                # over) rather than wedge the federation
                if n == self._stall_last_count:
                    self._stall_strikes += 1
                else:
                    self._stall_last_count, self._stall_strikes = n, 0
                if self._stall_strikes >= 2:  # the third barren deadline
                    logging.warning(
                        "round %d stalled below quorum (%d/%d uploads after 3 deadlines) — "
                        "abandoning with the partial set", self.round_idx, n, self._quorum(),
                    )
                    self.abandoned_rounds += 1
                    self._complete_round()
                    return
                self._deadline_timer = self._timer(self._on_deadline, armed_round)
        except BaseException as e:  # noqa: BLE001
            # the timer thread would swallow this and leave the server
            # parked on its inbox: surface it through finish()
            self.deadline_error = e
            self.finish()

    def _quorum_reached(self, received: int) -> bool:
        return received == self.worker_num or (self._deadline_passed and received >= self._quorum())

    def _on_model_from_client(self, msg: Message):
        self._dead_workers.discard(msg.get_sender_id())
        with self._round_lock:
            # an untagged upload fails safe: -1 never matches a round
            upload_round = msg.get(MT.ARG_ROUND_IDX, -1)
            if upload_round != self.round_idx:
                self.dropped_uploads += 1
                return
            cid = self._assigned.get(msg.get_sender_id())
            if cid is not None:
                # health: the broadcast→upload round trip; an in-process
                # actor's local_train span came first and wins the dedupe
                self.health.observe_train(cid, upload_round, time.monotonic() - self._bcast_t)
                # power-of-choice's signal: the client's mean train loss
                # rides its upload
                loss = msg.get(MT.ARG_TRAIN_LOSS)
                if loss is not None:
                    self.scheduler.report_loss(cid, float(loss))
            worker = msg.get_sender_id() - 1
            n = msg.get(MT.ARG_NUM_SAMPLES)
            if self.config.comm.secure_agg:
                masked = msg.get(MT.ARG_MASKED_UPDATE)
                if masked is None:
                    raise ValueError(
                        f"secure-agg server received an unmasked upload from sender "
                        f"{msg.get_sender_id()} — was that client run without secure_agg?"
                    )
                if self._recovery_pending:
                    # a "dropped" party racing the recovery exchange: its
                    # masks are being unwound, so its upload must not count
                    self.dropped_uploads += 1
                    return
                self._masked_uploads[worker] = masked
                self._masked_ns[worker] = float(n)
                if self._quorum_reached(len(self._masked_uploads)):
                    self._complete_round()
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
            self.aggregator.add_local_trained_result(worker, model_vars(params, self.device), n)
            self._round_losses[worker] = (msg.get(MT.ARG_TRAIN_LOSS), float(n))
            if self._quorum_reached(self.aggregator.received_count()):
                self._complete_round()

    def _train_loss(self) -> Optional[float]:
        """The uploads' train losses weighted by their sample counts (None
        when an upload carried none, or none arrived)."""
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

    def _secure_average(self) -> Optional[tuple]:
        """(the masked round's weighted average, the uploads in it), or
        None while the recovery exchange is open (a reply or its timer
        closes the round). With every party lost the average is the current
        model. Caller holds _round_lock."""
        dropped = sorted(set(self._round_pks) - set(self._masked_uploads))
        if dropped and self._recovery_requested_for != set(dropped):
            # registry parties that never uploaded left uncancelled pair
            # masks in the survivors' uploads: ask each survivor for its
            # recovery masks. A survivor that cannot even be sent to is
            # dropped too, and the exchange restarts with the larger set.
            self._recovery_pending = True
            self._recovery_requested_for = set(dropped)
            self._recovery_vecs = {}
            unreachable = []
            for p in sorted(self._masked_uploads):
                out = Message(MT.S2C_RECOVER, 0, p + 1)
                out.add_params(MT.ARG_ROUND_IDX, self.round_idx)
                out.add_params(MT.ARG_DROPPED, list(map(int, dropped)))
                if not self._broadcast(out):
                    unreachable.append(p)
            if unreachable:
                for p in unreachable:
                    self._masked_uploads.pop(p, None)
                    self._masked_ns.pop(p, None)
                self._recovery_requested_for = None
                return self._secure_average()
            if self._masked_uploads:
                # bounds the wait on survivors that died after uploading
                self._timer(self._on_recovery_deadline, self.round_idx,
                            delay=max(self.config.fed.deadline_s, 5.0))
                return None
        if dropped and set(self._recovery_vecs) < set(self._masked_uploads):
            return None  # waiting on recovery masks (a timer bounds the wait)
        avg, received = self.global_vars, len(self._masked_uploads)
        if received:
            srv = ServerAggregator(tree_dim(self._round_wire))
            with self._tracer.span("aggregate", round=self.round_idx,
                                   n_uploads=len(self._masked_uploads), secure_agg=True):
                total = srv.masked_sum(self._masked_uploads)
                if dropped:
                    total = srv.remove_dropout_masks(total, self._recovery_vecs)
                ns = {p: self._masked_ns[p] for p in self._masked_uploads}
                avg = model_vars(srv.decode_average(total, ns, self._round_wire), self.device)
        else:
            logging.warning("secure-agg round %d lost every upload — model unchanged", self.round_idx)
        self._masked_uploads, self._masked_ns = {}, {}
        self._round_pks, self._recovery_vecs = {}, {}
        self._recovery_pending = False
        self._recovery_requested_for = None
        self._registry_sent = False
        return avg, received

    def _complete_round(self):
        """Aggregate what has arrived, step the server optimizer, eval,
        then broadcast the next round or FINISH. Caller holds _round_lock."""
        self._disarm_deadline()
        r = self.round_idx
        if self.config.comm.secure_agg:
            done = self._secure_average()
            if done is None:
                return  # the recovery exchange closes the round
            avg, received = done
        else:
            received = self.aggregator.received_count()
            if received:
                with self._tracer.span("aggregate", round=r, n_uploads=received), fp32_math():
                    avg = self.aggregator.aggregate()
            else:
                # an abandoned round with no upload: the model carries over
                logging.warning("round %d closed with no uploads — model unchanged", r)
                avg = self.global_vars
        # a round nobody trained in must not step the server optimizer: its
        # moments from earlier rounds would still move the model
        if self._server_step is not None and received:
            if self._server_opt_state is None:
                self._server_opt_state = self._server_optimizer.init(
                    split_stats(self.global_vars)[0]
                )
            self.global_vars, self._server_opt_state = self._server_step(
                self.global_vars, avg, self._server_opt_state
            )
        else:
            self.global_vars = avg
        row = {"round": r, "t_s": round(time.monotonic() - self._t0, 3)}
        self.train_losses.append(self._train_loss())
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
    compressed delta, or its masked update under secure aggregation) with
    the sample count, round tag, train loss and a telemetry beacon. ``ef``
    is the error-feedback store and ``faults`` the fault injector, both
    shared by all the actors of a federation, since residuals and faults
    follow the client, not the worker slot."""

    def __init__(self, config: RunConfig, comm: BaseCommManager, rank: int,
                 trainer: LocalTrainer, ef=None, faults: Optional[FaultInjector] = None):
        super().__init__(comm, rank, config=config)
        self.config = config
        self.trainer = trainer
        self._ef = ef if ef is not None else CZ.ErrorFeedback.maybe_from_config(config.comm)
        self._faults = faults
        # secure aggregation: the party holding this round's secret key
        # (never sent), its round, and the upload waiting for the registry
        self._secagg_party: Optional[ClientParty] = None
        self._secagg_round = -1
        self._secagg_pending = None
        # quantized-downlink decode template (leaf shapes and order only)
        self._downlink_template = None

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MT.S2C_INIT_CONFIG, self._on_sync)
        self.register_message_receive_handler(MT.S2C_SYNC_MODEL, self._on_sync)
        self.register_message_receive_handler(MT.S2C_PUBKEYS, self._on_pubkeys)
        self.register_message_receive_handler(MT.S2C_RECOVER, self._on_recover)
        self.register_message_receive_handler(MT.FINISH, lambda m: self.finish())

    def _on_pubkeys(self, msg: Message):
        """The round's registry arrived: agree the pair keys and upload the
        masked update."""
        if self._secagg_party is None or msg.get(MT.ARG_ROUND_IDX) != self._secagg_round:
            return
        reg = msg.get(MT.ARG_PUBKEY_REGISTRY)
        weights, w_round, n = self._secagg_pending
        out = Message(MT.C2S_SEND_MODEL, self.rank, 0)
        # key agreement and masking, the client's share of the protocol's cost
        with get_tracer().span("mask", round=self._secagg_round):
            self._secagg_party.set_registry(
                {int(p): int(pk) for p, pk in zip(reg["parties"], reg["pks"])})
            out.add_params(MT.ARG_MASKED_UPDATE, self._secagg_party.masked_update(weights, w_round, n))
        out.add_params(MT.ARG_NUM_SAMPLES, n)
        out.add_params(MT.ARG_ROUND_IDX, self._secagg_round)
        self.send_message(out)

    def _on_recover(self, msg: Message):
        """Some registry parties dropped before uploading: send the masks
        this party applied toward them."""
        if self._secagg_party is None or msg.get(MT.ARG_ROUND_IDX) != self._secagg_round:
            return
        dropped = msg.get(MT.ARG_DROPPED)
        out = Message(MT.C2S_RECOVERY, self.rank, 0)
        out.add_params(MT.ARG_ROUND_IDX, self._secagg_round)
        out.add_params(MT.ARG_DROPPED, list(map(int, dropped)))
        out.add_params(MT.ARG_RECOVERY_VEC, self._secagg_party.recovery_mask(dropped))
        self.send_message(out)

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
        fd = None
        cid = trainer.client_index
        if self._faults is not None:
            fd = self._faults.decide(cid, int(round_idx))
            # a crashed client is silent from crash_at_round on, a dropped
            # one for this round: no training, no upload (the server's
            # deadline and quorum absorb it); the worker slot stays alive
            # for the clients later rounds assign it
            if fd.crashed or fd.drop:
                self._faults.record(cid, int(round_idx), "crash" if fd.crashed else "dropout")
                return
        t_train = time.perf_counter()
        new_vars, n = trainer.train(round_idx, model_vars(w_round, trainer.device))
        weights = wire_model(new_vars)
        if fd is not None and fd.slowdown_s:
            self._faults.record(cid, int(round_idx), "slowdown", detail=fd.slowdown_s)
            time.sleep(fd.slowdown_s)
        # the beacon's train time includes an injected slowdown
        train_s = time.perf_counter() - t_train
        if self.config.comm.secure_agg:
            # advertise a fresh key pair; the masked upload waits for the
            # registry (_on_pubkeys)
            self._secagg_party = ClientParty(self.rank - 1, tree_dim(weights))
            self._secagg_round = round_idx
            self._secagg_pending = (weights, w_round, n)
            adv = Message(MT.C2S_PUBKEY, self.rank, 0)
            adv.add_params(MT.ARG_ROUND_IDX, round_idx)
            adv.add_params(MT.ARG_PUBKEY, self._secagg_party.pk)
            self.send_message(adv)
            return
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
                payload = self._ef.encode(cid, weights, w_round)
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
                tier=self._faults.plan.tier_of(cid) if self._faults is not None else None,
            )
            out.add_params(MT.ARG_TELEMETRY, beacon)
            meter.on_beacon(beacon_nbytes(beacon))
        self.send_message(out)
        if fd is not None and fd.flaky:
            # a flaky upload is delivered twice; the server's worker slot
            # absorbs the duplicate
            self._faults.record(cid, int(round_idx), "flaky")
            try:
                self.send_message(out)
            except Exception:  # noqa: BLE001 — the real upload already landed
                pass


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
    """One-process federation over any transport: a server and one client
    actor a scheduler slot (``ceil(client_num_per_round ·
    overprovision_factor)``) in threads, each on
    ``comm_factory(rank)``. A ``fed.fault_plan`` is parsed ONCE into one
    injector that every client actor and the server's stall valve share;
    after the last round its ``faults/*`` counters go to ``log_fn``.
    Blocks until the last round, re-raises an error from any actor or the
    server's timers, and returns the server manager (``global_vars``,
    ``history``, ``train_losses``). ``device=None`` runs every actor on the
    card."""
    if warmup:
        raise NotImplementedError("AOT warmup is not ported yet (ROADMAP.md)")
    dev = resolve_device(device)
    injector = FaultInjector.from_config(config, tracer=get_tracer())
    if injector is not None and injector.plan.has_participation_faults() and not config.fed.deadline_s:
        raise ValueError(
            "fault_plan can drop uploads (dropout_p/crash_at_round) but deadline_s is 0: the "
            "server's all-received barrier would wait forever — set FedConfig.deadline_s/min_clients"
        )
    shared_ef = CZ.ErrorFeedback.maybe_from_config(config.comm)
    if shared_ef is not None and config.fed.deadline_s:
        raise ValueError(
            "error_feedback cannot be combined with deadline_s quorum rounds: a dropped late "
            "upload loses residual-cleared mass"
        )
    server = FedAvgServerManager(
        config, comm_factory(0), model, data=data, task=task, log_fn=log_fn,
        server_opt=server_opt, device=dev, init_vars=init_vars, faults=injector,
    )
    if injector is not None:
        # the injector predates the server (its stall valve reads the
        # plan): point the fault accounting at the server's registry
        injector.health = server.health
    make_trainer = trainer_factory or (
        lambda rank: LocalTrainer(config, data, model, task, device=dev)
    )
    clients = [
        FedAvgClientManager(config, comm_factory(rank), rank, make_trainer(rank), ef=shared_ef,
                            faults=injector)
        for rank in range(1, server.worker_num + 1)
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
    if server.deadline_error is not None or errors:
        for c in clients:
            c.finish()
        if server.deadline_error is not None:
            raise RuntimeError("server deadline path failed") from server.deadline_error
        raise RuntimeError("client actor failed") from errors[0]
    for t in threads:
        t.join(timeout=60)
        if t.is_alive():
            raise RuntimeError("client thread failed to finish")
    if injector is not None:
        server.log_fn(injector.summary_row())
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


def run_mqtt_federation(
    config: RunConfig, data: FederatedDataset, model: ModelDef, task: str = "classification",
    log_fn=None, host: Optional[str] = None, port: int = 1883, server_opt: bool = False,
    warmup: bool = False, **kw,
) -> FedAvgServerManager:
    """Federation over MQTT pub/sub: an in-process embedded broker by
    default, a broker over TCP at ``host:port`` when ``host`` is given."""
    from fedml_tpu_torch.core.mqtt_comm import EmbeddedBroker, MqttCommManager

    if host is None:
        broker = EmbeddedBroker()
        factory = lambda rank: MqttCommManager(rank, broker=broker)  # noqa: E731
    else:
        factory = lambda rank: MqttCommManager(rank, host=host, port=port)  # noqa: E731
    return run_federation(
        config, data, model, factory, task=task, log_fn=log_fn, server_opt=server_opt,
        warmup=warmup, **kw,
    )
