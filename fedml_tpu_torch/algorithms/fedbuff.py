"""Asynchronous buffered federated aggregation, FedBuff (port of
``fedml_tpu/algorithms/fedbuff.py``): the framework's barrier-free path,
where a slow device costs only its own throughput.

Protocol (the buffered-async scheme of Nguyen et al., AISTATS 2022):

- the server keeps a model VERSION counter ``t`` and a buffer of client
  deltas. There are no rounds and no barrier.
- every client upload is answered IMMEDIATELY with the current model and a
  fresh client assignment, so workers never idle waiting for each other.
- a client trains from the version-``b`` model and uploads
  ``delta = w_local - w_b`` tagged with ``b``; its staleness is
  ``tau = t - b``.
- when the buffer holds ``k = fed.async_buffer_k`` deltas the server
  applies one step (:func:`apply_buffered_update`)::

      w  <-  w + eta_g * sum_i s(tau_i) d_i / sum_i s(tau_i),
      s(tau) = (1 + tau) ** -async_staleness_exp

  and advances ``t``. ``fed.comm_round`` counts these server steps.

Assignments come from a stream pure in (seed, dispatch counter), each
tagged with a unique dispatch tag that is also the client's shuffle seed
(``ARG_ROUND_IDX``) and the key of at-least-once dedupe: a duplicate
upload or decline restates the worker's one outstanding assignment, and a
worker ignores a restated assignment it already handled. A fault plan's
dropped or crashed assignment is DECLINED (the worker stays in the
dispatch loop); a decline streak with no upload past
``max(100, 20·workers)`` shuts the federation down as ``fault_starved``.
A worker that hears nothing from the server for ``ORPHAN_DEADLINE_S``
after an upload exits as ``orphaned``.

**On the card.** The server step is one float32 weighted sum a leaf over
the stacked deltas on the server's device (no kernel of the reference's
is on this path: its step is a ``jnp.tensordot``). Actors are threads
sharing the card: each dispatch carries the model as wire bytes (the
version's host copy, encoded once), so no client reads a tensor the
server's flush replaces, and each client takes its delta on the host
after its local train's last kernel (the device-to-host copy waits for
it).

Degenerate-config oracle: with every delta at staleness 0, eta_g = 1 and k
uploads from equal-sized shards, one buffered step equals the synchronous
FedAvg average of the k local models."""

from __future__ import annotations

import logging
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg_transport import (
    LocalTrainer, _model_wire_cost, model_vars, wire_model,
)
from fedml_tpu_torch.config import RunConfig
from fedml_tpu_torch.core.comm import BaseCommManager
from fedml_tpu_torch.core.loopback import LoopbackCommManager, LoopbackHub
from fedml_tpu_torch.core.managers import ClientManager, ServerManager
from fedml_tpu_torch.core.message import Message, MessageType as MT
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.device import DeviceLike, fp32_math, resolve_device
from fedml_tpu_torch.models import ModelDef
from fedml_tpu_torch.scheduler import ClientScheduler, FaultInjector
from fedml_tpu_torch.telemetry import ClientHealthRegistry, get_comm_meter, get_tracer
from fedml_tpu_torch.train.evaluate import make_eval_fn, metrics_to_loss_acc, pad_to_batches

Variables = Dict[str, torch.Tensor]


def staleness_weight(tau, exp: float = 0.5, device: DeviceLike = "cpu") -> torch.Tensor:
    """Polynomial staleness discount s(tau) = (1 + tau)^-exp in float32;
    s(0) = 1."""
    return (1.0 + torch.as_tensor(tau, dtype=torch.float32, device=device)) ** (-exp)


def apply_buffered_update(global_vars: Variables, deltas: Sequence[Variables], taus,
                          eta_g: float, exp: float) -> Variables:
    """One buffered server step: the staleness-weighted mean of the client
    deltas applied to the global model. The k deltas are stacked leaf by
    leaf on the global model's device; the weights are float32, normalized
    by their sum; each leaf takes one float32 weighted sum over the stack,
    then ``g + eta_g·mean`` cast back to the leaf's dtype."""
    dev = next(iter(global_vars.values())).device
    w = staleness_weight(list(taus), exp, device=dev)
    w = w / w.sum()
    out = {}
    with fp32_math():
        for name, g in global_vars.items():
            stacked = torch.stack([d[name].to(dev, torch.float32) for d in deltas])
            mean = torch.tensordot(w, stacked, dims=1)
            out[name] = (g + eta_g * mean).to(g.dtype)
    return out


class FedBuffServerManager(ServerManager):
    """Barrier-free server: buffer deltas, flush every k, always answer an
    upload with the current model + a new client assignment.

    ``worker_num`` is the initial fleet (default ``client_num_per_round``;
    0 starts empty and admits every worker through ``C2S_JOIN``);
    ``max_workers`` caps the live fleet at a join (default: the initial
    fleet). ``init_vars`` (port variables) replaces the model's seeded
    init."""

    def __init__(
        self,
        config: RunConfig,
        comm: BaseCommManager,
        model: ModelDef,
        data: Optional[FederatedDataset] = None,
        task: str = "classification",
        worker_num: Optional[int] = None,
        log_fn: Optional[Callable[[dict], None]] = None,
        max_workers: Optional[int] = None,
        device: DeviceLike = None,
        init_vars: Optional[Variables] = None,
    ):
        super().__init__(comm, rank=0, config=config)
        if config.fed.async_buffer_k <= 0:
            raise ValueError("FedBuff requires FedConfig.async_buffer_k > 0")
        self.config = config
        self.model = model
        self.data = data
        self.task = task
        self.device = resolve_device(device)
        self.log_fn = log_fn or (lambda m: None)
        # None-check, not truthiness: worker_num=0 is a real fleet mode
        self.worker_num = worker_num if worker_num is not None else config.fed.client_num_per_round
        self.max_workers = int(max_workers) if max_workers is not None else self.worker_num
        self.joins_accepted = 0
        self.joins_refused = 0
        self.leaves = 0
        # graceful stop: the next upload path shuts the federation down,
        # after a final flush of the partial buffer when _drain_on_stop
        self._stop_requested = False
        self._drain_on_stop = True
        self.version = 0  # server model version t
        self.server_steps = 0  # buffer flushes so far
        self._dispatch_counter = 0
        self._buffer: List[Variables] = []
        self._buffer_taus: List[int] = []
        self._finished = False
        self._dead_workers: set = set()
        # ranks that have been part of the fleet: the FINISH broadcast
        # iterates this set, never phantom ranks that never joined
        self._joined: set = set(range(1, self.worker_num + 1))
        # declined assignments in a row with no upload (the starvation valve)
        self._decline_streak = 0
        self.fault_starved = False
        self.declines = 0  # declined assignments re-dispatched
        self.duplicates = 0  # duplicate uploads and declines dropped by their tag
        # at-least-once dedupe: the last dispatch tag buffered per sender
        self._last_upload_tag: Dict[int, int] = {}
        # worker -> (client_index, tag) of its one outstanding assignment
        self._outstanding: Dict[int, tuple] = {}
        self._lock = threading.Lock()
        self.staleness_seen: List[int] = []  # one entry per buffered delta
        if init_vars is None:
            init_vars = model.init(torch.Generator().manual_seed(config.seed))
        self.global_vars: Variables = {k: v.to(self.device) for k, v in init_vars.items()}
        self._wire = None  # (version, the model's wire tree, its wire cost)
        self.history: List[dict] = []
        self._eval_fn = make_eval_fn(model, task) if data is not None else None
        self._test_dev = None
        # health: per-client train time from the span stream (in-process
        # workers) or the dispatch→upload round trip; rounds are VERSIONS
        # here — the (client, dispatch tag) pair is the dedupe key
        self._tracer = get_tracer()
        self.health = ClientHealthRegistry.from_config(config).attach(self._tracer)
        self._dispatch_times: Dict[int, tuple] = {}  # worker -> (cid, tag, t)
        # non-uniform dispatch: each assignment through the scheduler, keyed
        # by the dispatch counter; "uniform" keeps the seeded stream
        self._scheduler = None
        if config.fed.selection != "uniform":
            self._scheduler = ClientScheduler.from_config(
                config, num_clients=config.fed.client_num_in_total, data=data,
                health=self.health, memoize=False,
            )

    # -- dispatch --
    def _next_client_index(self) -> int:
        """The seeded assignment stream ``default_rng(seed·1_000_003 +
        counter)``; policy-routed when ``fed.selection`` is not uniform."""
        if self._scheduler is not None:
            idx = int(self._scheduler.select(self._dispatch_counter, k=1)[0])
            self._dispatch_counter += 1
            return idx
        rng = np.random.default_rng(self.config.seed * 1_000_003 + self._dispatch_counter)
        self._dispatch_counter += 1
        return int(rng.integers(0, self.config.fed.client_num_in_total))

    def _wire_model(self):
        """The current version's model as host arrays, encoded once a
        version: every dispatch of it references the same copy, which no
        flush can touch."""
        if self._wire is None or self._wire[0] != self.version:
            host = wire_model(self.global_vars)
            self._wire = (self.version, host, _model_wire_cost(host))
        return self._wire[1], self._wire[2]

    def _dispatch(self, worker: int, msg_type: str = MT.S2C_SYNC_MODEL, reuse: bool = False):
        if worker in self._dead_workers:
            return
        if reuse and worker in self._outstanding:
            # a duplicate's reply restates the SAME outstanding assignment
            # (same tag and client) with the current model: outstanding
            # work per worker never grows
            client_index, tag = self._outstanding[worker]
        else:
            client_index = self._next_client_index()
            tag = self._dispatch_counter
            self._outstanding[worker] = (client_index, tag)
        host, (shipped, raw) = self._wire_model()
        msg = Message(msg_type, 0, worker)
        msg.add_params(MT.ARG_MODEL_PARAMS, host)
        msg.add_params(MT.ARG_CLIENT_INDEX, client_index)
        msg.add_params(MT.ARG_BASE_VERSION, self.version)
        # ARG_ROUND_IDX doubles as the client's shuffle seed
        msg.add_params(MT.ARG_ROUND_IDX, tag)
        self._dispatch_times[worker] = (client_index, tag, time.monotonic())
        try:
            self.send_message(msg)
            get_comm_meter().on_downlink(shipped, raw)
        except Exception as e:  # noqa: BLE001 — transport errors vary by backend
            self._dead_workers.add(worker)
            logging.warning("async dispatch to worker %d failed (%s)", worker, e)

    def send_init_msg(self):
        self._t0 = time.monotonic()
        # an early JOIN or upload on the comm thread must not race the
        # opening dispatches of the assignment stream
        with self._lock:
            for worker in range(1, self.worker_num + 1):
                self._dispatch(worker, MT.S2C_INIT_CONFIG)

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MT.C2S_SEND_MODEL, self._on_delta_from_client)
        self.register_message_receive_handler(MT.C2S_JOIN, self._on_join)
        self.register_message_receive_handler(MT.C2S_LEAVE, self._on_leave)

    def finish(self):
        self.health.detach()  # queries on self.health keep working
        super().finish()

    # -- elastic fleet membership --
    def _live_worker_count(self) -> int:
        """Caller holds _lock. Membership is the _joined SET, not the
        1..worker_num range."""
        return sum(1 for w in self._joined if w not in self._dead_workers)

    def _finish_peer(self, rank: int) -> None:
        try:
            self.send_message(Message(MT.FINISH, 0, rank))
        except Exception:  # noqa: BLE001 — dead peer
            pass

    def _on_join(self, msg: Message):
        with self._lock:
            sender = msg.get_sender_id()
            if self._finished:
                self._finish_peer(sender)  # a late joiner exits instead of parking
                return
            alive = sender in self._joined and sender not in self._dead_workers
            if not alive and self._live_worker_count() >= self.max_workers:
                # backpressure: refused at the door, recorded dead first so
                # a later admission never counts it live
                self._dead_workers.add(sender)
                self.joins_refused += 1
                logging.info("join from rank %d refused: fleet at max_workers=%d",
                             sender, self.max_workers)
                self._finish_peer(sender)
                return
            self._dead_workers.discard(sender)
            self.worker_num = max(self.worker_num, sender)
            self._joined.add(sender)
            self.joins_accepted += 1
            self._dispatch(sender)

    def _on_leave(self, msg: Message):
        with self._lock:
            sender = msg.get_sender_id()
            if sender in self._dead_workers:
                return  # a duplicate LEAVE is already counted
            # no more dispatches to this rank; its outstanding assignment
            # evaporates (there is no barrier to wait on it)
            self._dead_workers.add(sender)
            self._outstanding.pop(sender, None)
            self._dispatch_times.pop(sender, None)
            self.leaves += 1

    # -- graceful stop / checkpoint state --
    def _shutdown(self):
        """FINISH the fleet and stop this server's loop. Caller holds _lock."""
        self._finished = True
        for worker in sorted(self._joined):
            if worker in self._dead_workers:
                continue
            try:
                # one attempt: a dead rank at shutdown costs one bounded
                # timeout, not the retry schedule
                self.comm.send_message_nowait(Message(MT.FINISH, 0, worker))
            except Exception:  # noqa: BLE001 — dead peer at shutdown
                pass
        self.finish()

    def request_stop(self, drain: bool = True, defer: bool = False) -> None:
        """Stop the federation: ``drain=True`` flushes the buffered deltas
        as one final (partial) server step first, ``drain=False`` discards
        them. ``defer=True`` only sets the flags (safe from inside this
        server's handlers); the next upload applies them."""
        self._drain_on_stop = bool(drain)
        self._stop_requested = True
        if defer:
            return
        with self._lock:
            if self._finished:
                return
            if self._drain_on_stop and self._buffer:
                self._flush()
            if not self._finished:
                self._shutdown()

    def checkpoint_state(self) -> dict:
        """Model version, step count and dispatch counter (the checkpoint's
        ``algo`` slot). The dispatch stream is pure in (seed, counter), so
        a resumed server re-mints the in-flight assignments identically;
        checkpoints are taken at flush boundaries, with the buffer empty."""
        return {
            "version": np.asarray(self.version, np.int64),
            "server_steps": np.asarray(self.server_steps, np.int64),
            "dispatch_counter": np.asarray(self._dispatch_counter, np.int64),
        }

    def restore_state(self, state: dict) -> None:
        with self._lock:
            self.version = int(np.asarray(state["version"]))
            self.server_steps = int(np.asarray(state["server_steps"]))
            self._dispatch_counter = int(np.asarray(state["dispatch_counter"]))

    # -- aggregation --
    def _stop_now(self) -> None:
        """Apply a requested stop (caller holds _lock): drain flushes the
        partial buffer as one last step, hard stop discards it."""
        if self._drain_on_stop and self._buffer:
            self._flush()
        if not self._finished:
            self._shutdown()

    def _on_declined(self, sender: int, tag: int) -> None:
        if tag >= 0 and self._last_upload_tag.get(sender) == tag:
            # duplicate decline: restate the outstanding assignment, as
            # for a duplicate upload
            self.duplicates += 1
            self._dispatch(sender, reuse=True)
            return
        self._last_upload_tag[sender] = tag
        self.declines += 1
        self._decline_streak += 1
        if self._decline_streak > max(100, 20 * self.worker_num):
            logging.error(
                "fault plan starved the buffer: %d consecutive declined assignments with no "
                "upload — every client appears crashed/dropped; shutting down",
                self._decline_streak,
            )
            self.fault_starved = True
            self._shutdown()
            return
        if self._stop_requested:
            self._stop_now()
            return
        self._dispatch(sender)

    def _on_delta_from_client(self, msg: Message):
        with self._lock:
            if self._finished:
                return
            sender = msg.get_sender_id()
            self._dead_workers.discard(sender)
            tag = msg.get(MT.ARG_ROUND_IDX, -1)
            if msg.get(MT.ARG_DECLINED):
                self._on_declined(sender, tag)
                return
            delta = msg.get(MT.ARG_ASYNC_DELTA)
            base = msg.get(MT.ARG_BASE_VERSION, -1)
            if delta is None or base < 0:
                logging.warning(
                    "async server dropping malformed upload from sender %s (missing delta or "
                    "base version — sync-protocol client?)", sender,
                )
                return
            if tag >= 0 and self._last_upload_tag.get(sender) == tag:
                logging.info(
                    "async server dropping duplicate upload from rank %d (dispatch tag %d "
                    "already buffered)", sender, tag,
                )
                # the duplicate means the worker may never have seen our
                # reply: restate its outstanding assignment
                self.duplicates += 1
                self._dispatch(sender, reuse=True)
                return
            self._last_upload_tag[sender] = tag
            self._decline_streak = 0  # a real upload: the fleet is alive
            disp = self._dispatch_times.get(sender)
            if disp is not None and disp[1] == tag:
                self.health.observe_train(disp[0], tag, time.monotonic() - disp[2])
                if self._scheduler is not None:
                    loss = msg.get(MT.ARG_TRAIN_LOSS)
                    if loss is not None:
                        self._scheduler.report_loss(disp[0], float(loss))
            tau = self.version - int(base)
            self._buffer.append(model_vars(delta, self.device))
            self._buffer_taus.append(tau)
            self.staleness_seen.append(tau)
            if len(self._buffer) >= self.config.fed.async_buffer_k:
                self._flush()
            if self._stop_requested and not self._finished:
                self._stop_now()
                return
            if not self._finished:
                self._dispatch(sender)

    def _eval_batches(self):
        if self._test_dev is None:
            xb, yb, mb = pad_to_batches(np.asarray(self.data.test_x), np.asarray(self.data.test_y), 256)
            self._test_dev = tuple(torch.from_numpy(a).to(self.device) for a in (xb, yb, mb))
        return self._test_dev

    def _flush(self):
        """Apply one buffered server step; caller holds _lock."""
        fed = self.config.fed
        taus = list(self._buffer_taus)
        with self._tracer.span("server_step", version=self.version, n_deltas=len(self._buffer),
                               staleness_max=int(max(taus))):
            self.global_vars = apply_buffered_update(
                self.global_vars, self._buffer, taus, fed.async_server_lr, fed.async_staleness_exp
            )
        self._buffer, self._buffer_taus = [], []
        self.version += 1
        self.server_steps += 1
        row = {
            "server_step": self.server_steps,
            "version": self.version,
            "staleness_mean": float(np.mean(taus)),
            "staleness_max": int(np.max(taus)),
            # wall clock since w0 went out
            "t_s": round(time.monotonic() - getattr(self, "_t0", time.monotonic()), 3),
        }
        if self.data is not None and (
            self.server_steps % fed.frequency_of_the_test == 0 or self.server_steps == fed.comm_round
        ):
            with self._tracer.span("eval", round=self.version - 1), fp32_math():
                row["Test/Loss"], row["Test/Acc"] = metrics_to_loss_acc(
                    self._eval_fn(self.global_vars, *self._eval_batches())
                )
        self.history.append(row)
        self.log_fn(row)
        if self.server_steps >= fed.comm_round:
            hist: Dict[int, int] = {}
            for t in self.staleness_seen:
                hist[int(t)] = hist.get(int(t), 0) + 1
            self.log_fn({
                "async_final": True,
                "server_steps": self.server_steps,
                "wall_s": row["t_s"],
                "staleness_hist": {str(k): v for k, v in sorted(hist.items())},
            })
            self._shutdown()


class FedBuffClientManager(ClientManager):
    """Train-on-arrival worker: every received model is trained from and
    answered with a delta; FINISH ends the loop.

    ``ORPHAN_DEADLINE_S`` is how long a worker waits, after an upload, for
    the server's reply (a redispatch or FINISH) before it exits as
    ``orphaned``: a hang guard, not a latency bound. A worker waiting for
    its FIRST dispatch waits indefinitely. ``faults`` is the federation's
    one fault injector, keyed by the dispatch tag with the model version as
    the crash round."""

    ORPHAN_DEADLINE_S = 600.0

    def __init__(
        self,
        config: RunConfig,
        comm: BaseCommManager,
        rank: int,
        trainer: LocalTrainer,
        orphan_deadline_s: Optional[float] = None,
        faults: Optional[FaultInjector] = None,
    ):
        super().__init__(comm, rank, config=config)
        self.config = config
        self.trainer = trainer
        self._faults = faults
        if orphan_deadline_s is not None:
            self.ORPHAN_DEADLINE_S = float(orphan_deadline_s)
        self._got_finish = False
        # request_leave: the NEXT dispatch is answered with C2S_LEAVE
        self._leave_requested = False
        self.left = False
        # a restated assignment this worker already handled is ignored:
        # handling it again would echo a duplicate upload back and forth
        self._last_handled_tag: Optional[int] = None
        self._liveness_timer: Optional[threading.Timer] = None
        # arm/disarm/fire are serialized by this lock and a generation
        # counter: a timer callback already running at the deadline sees a
        # stale generation and does nothing
        self._live_lock = threading.Lock()
        self._live_gen = 0
        self.orphaned = False

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MT.S2C_INIT_CONFIG, self._on_model)
        self.register_message_receive_handler(MT.S2C_SYNC_MODEL, self._on_model)
        self.register_message_receive_handler(MT.FINISH, self._on_finish)

    def _on_finish(self, msg: Message):
        self._got_finish = True
        self.finish()

    def finish(self):
        # disarmed on every termination path, so a timer left armed can
        # never mark an exited worker orphaned
        self._disarm_liveness()
        super().finish()

    def _arm_liveness(self):
        with self._live_lock:
            self._live_gen += 1
            if self._liveness_timer is not None:
                self._liveness_timer.cancel()
            t = threading.Timer(self.ORPHAN_DEADLINE_S, self._deadman, args=(self._live_gen,))
            t.daemon = True
            t.start()
            self._liveness_timer = t

    def _disarm_liveness(self):
        with self._live_lock:
            self._live_gen += 1
            if self._liveness_timer is not None:
                self._liveness_timer.cancel()
                self._liveness_timer = None

    def _deadman(self, gen: int):
        with self._live_lock:
            if gen != self._live_gen or self._got_finish:
                return  # a reply or FINISH won the race
            self.orphaned = True
        logging.error(
            "async worker rank %d: no server reply within %.0fs of the last upload — server "
            "lost; exiting as ORPHANED", self.rank, self.ORPHAN_DEADLINE_S,
        )
        self.finish()

    def request_leave(self) -> None:
        """Leave the fleet at the next dispatch. Safe from any thread."""
        self._leave_requested = True

    def _send_then_arm(self, out: Message) -> None:
        try:
            self.send_message(out)
        finally:
            self._arm_liveness()

    def _on_model(self, msg: Message):
        self._disarm_liveness()
        tag = int(msg.get(MT.ARG_ROUND_IDX))
        if self._leave_requested:
            out = Message(MT.C2S_LEAVE, self.rank, 0)
            out.add_params(MT.ARG_ROUND_IDX, tag)
            try:
                self.send_message(out)
            except Exception:  # noqa: BLE001 — a dead server can't object
                pass
            self.left = True
            self.finish()
            return
        if tag == self._last_handled_tag:
            # a restated assignment already completed: keep waiting on the
            # server's NEXT dispatch, deadman armed
            self._arm_liveness()
            return
        self._last_handled_tag = tag
        trainer = self.trainer
        trainer.update_dataset(msg.get(MT.ARG_CLIENT_INDEX))
        cid = int(trainer.client_index)
        base_version = msg.get(MT.ARG_BASE_VERSION)
        fd = None
        if self._faults is not None:
            # coin flips keyed by the unique dispatch tag; crash_at_round
            # against the model VERSION (tags grow without bound)
            fd = self._faults.decide(cid, tag, crash_round=int(base_version or 0))
            if fd.crashed or fd.drop:
                # decline: this client gives no update, the worker stays in
                # the dispatch loop (going silent would starve the buffer)
                self._faults.record(cid, tag, "crash" if fd.crashed else "dropout")
                out = Message(MT.C2S_SEND_MODEL, self.rank, 0)
                out.add_params(MT.ARG_DECLINED, True)
                out.add_params(MT.ARG_ROUND_IDX, tag)
                self._send_then_arm(out)
                return
        w_base = msg.get(MT.ARG_MODEL_PARAMS)
        new_vars, n = trainer.train(tag, model_vars(w_base, trainer.device))
        if fd is not None and fd.slowdown_s:
            self._faults.record(cid, tag, "slowdown", detail=fd.slowdown_s)
            time.sleep(fd.slowdown_s)
        # on the host: the device-to-host copy waits for the train's last kernel
        new_wire = wire_model(new_vars)
        delta = _tree_sub(new_wire, w_base)
        out = Message(MT.C2S_SEND_MODEL, self.rank, 0)
        out.add_params(MT.ARG_ASYNC_DELTA, delta)
        out.add_params(MT.ARG_NUM_SAMPLES, n)
        out.add_params(MT.ARG_BASE_VERSION, base_version)
        # the dispatch tag: the server's duplicate filter keys on it
        out.add_params(MT.ARG_ROUND_IDX, tag)
        if trainer.last_loss is not None:
            out.add_params(MT.ARG_TRAIN_LOSS, float(trainer.last_loss))
        if fd is not None and fd.flaky:
            # at-least-once double delivery: the server's tag dedupe must
            # absorb exactly one of the two copies
            self._faults.record(cid, tag, "flaky")
            try:
                self.send_message(out)
            except Exception:  # noqa: BLE001 — best-effort duplicate
                pass
        try:
            for attempt in (1, 2):
                try:
                    self.send_message(out)
                    return
                except Exception as e:  # noqa: BLE001 — transport errors vary
                    if attempt == 1:
                        time.sleep(0.5)  # one retry past a transient blip
                        continue
                    # the end-of-run race (the server shut down while we
                    # trained; its FINISH is in our inbox) or a lost
                    # server: the deadman below tells them apart
                    logging.warning(
                        "async upload from rank %d undeliverable after retry (%s) — waiting "
                        "%.0fs for FINISH", self.rank, e, self.ORPHAN_DEADLINE_S,
                    )
        finally:
            self._arm_liveness()


def _tree_sub(a, b):
    """``a - b`` leaf by leaf over two nested trees of host arrays."""
    if hasattr(a, "items"):
        return {k: _tree_sub(a[k], b[k]) for k in a}
    return np.asarray(a) - np.asarray(b)


def run_fedbuff_federation(
    config: RunConfig,
    data: FederatedDataset,
    model: ModelDef,
    comm_factory: Callable[[int], BaseCommManager],
    task: str = "classification",
    log_fn: Optional[Callable[[dict], None]] = None,
    device: DeviceLike = None,
    trainer_factory: Optional[Callable[[int], LocalTrainer]] = None,
    init_vars: Optional[Variables] = None,
    orphan_deadline_s: Optional[float] = None,
) -> FedBuffServerManager:
    """One-process async federation: a server and ``client_num_per_round``
    worker actors in threads, each on ``comm_factory(rank)``. A
    ``fed.fault_plan`` is parsed once into one injector the workers share,
    recording into the server's health registry; its ``faults/*`` row goes
    to ``log_fn`` at the end. Blocks until the last server step, then
    re-raises a worker's error, joins the threads, and raises when the plan
    starved the buffer or a worker was orphaned before every step
    completed. Returns the server manager (``global_vars``, ``history``,
    ``staleness_seen``, ``health``). ``device=None`` runs on the card."""
    dev = resolve_device(device)
    server = FedBuffServerManager(
        config, comm_factory(0), model, data=data, task=task, log_fn=log_fn, device=dev,
        init_vars=init_vars,
    )
    injector = FaultInjector.from_config(config, health=server.health, tracer=get_tracer())
    make_trainer = trainer_factory or (lambda rank: LocalTrainer(config, data, model, task, device=dev))
    clients = [
        FedBuffClientManager(config, comm_factory(rank), rank, make_trainer(rank),
                             orphan_deadline_s=orphan_deadline_s, faults=injector)
        for rank in range(1, server.worker_num + 1)
    ]
    errors: List[BaseException] = []

    def guarded_run(c):
        # a dead worker would starve the buffer: stop the server
        try:
            c.run()
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
            server.finish()

    threads = [
        threading.Thread(target=guarded_run, args=(c,), daemon=True, name=f"fedbuff-client-{c.rank}")
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
        raise RuntimeError("async client actor failed") from errors[0]
    for c in clients:
        c.finish()  # idempotent: unblocks workers parked on their inboxes
    for t in threads:
        t.join(timeout=60)
        if t.is_alive():
            raise RuntimeError("async client thread failed to finish")
    if server.fault_starved:
        raise RuntimeError(
            "fedbuff fault plan starved the delta buffer: every client appears crashed/dropped, "
            "the run cannot reach its step count (fix the plan or lower async_buffer_k)"
        )
    orphans = [c.rank for c in clients if c.orphaned]
    if orphans and server.server_steps < config.fed.comm_round and not server._stop_requested:
        raise RuntimeError(
            f"async workers {orphans} were orphaned (server unreachable, no FINISH) — "
            "federation did not terminate cleanly"
        )
    if orphans:
        logging.warning(
            "async federation completed all %d steps but workers %s went orphaned along the way "
            "(transient upload failures)", server.server_steps, orphans,
        )
    if injector is not None:
        server.log_fn(injector.summary_row())
    return server


def run_fedbuff_loopback(config: RunConfig, data: FederatedDataset, model: ModelDef,
                         task: str = "classification", log_fn=None, **kw) -> FedBuffServerManager:
    """Async federation over the in-process loopback hub."""
    hub = LoopbackHub()
    return run_fedbuff_federation(
        config, data, model, lambda rank: LoopbackCommManager(hub, rank), task=task,
        log_fn=log_fn, **kw,
    )


def run_fedbuff_shm(config: RunConfig, data: FederatedDataset, model: ModelDef,
                    task: str = "classification", log_fn=None, sock_dir: Optional[str] = None,
                    namespace: str = "", **kw) -> FedBuffServerManager:
    """Async federation over the shared-memory transport. ``namespace``
    must be unique per federation when two runs share ``sock_dir``."""
    from fedml_tpu_torch.core.shm_comm import ShmCommManager

    with tempfile.TemporaryDirectory(prefix="fedml_shm_async_") as d:
        return run_fedbuff_federation(
            config, data, model,
            lambda rank: ShmCommManager(rank, sock_dir or d, namespace=namespace),
            task=task, log_fn=log_fn, **kw,
        )


def run_fedbuff_mqtt(config: RunConfig, data: FederatedDataset, model: ModelDef,
                     task: str = "classification", log_fn=None, host: Optional[str] = None,
                     port: int = 1883, **kw) -> FedBuffServerManager:
    """Async federation over MQTT: an in-process embedded broker by
    default, a broker over TCP at ``host:port`` when ``host`` is given."""
    from fedml_tpu_torch.core.mqtt_comm import EmbeddedBroker, MqttCommManager

    if host is None:
        broker = EmbeddedBroker()
        factory = lambda rank: MqttCommManager(rank, broker=broker)  # noqa: E731
    else:
        factory = lambda rank: MqttCommManager(rank, host=host, port=port)  # noqa: E731
    return run_fedbuff_federation(config, data, model, factory, task=task, log_fn=log_fn, **kw)
