"""Distributed split learning over the Message/Observer transport (port of
``fedml_tpu/splitfed/split_transport.py``).

The server owns the top half and the round's state machine; clients own
the bottom half and their shards. A relay turn (one active client at a
time) is:

1. server → client ``S2C_SPLIT_TURN``: the shared bottom params and the
   bottom optimizer state, the ring's hand-off, through the server so the
   scheduler's selection policy orders the ring and a dead client can be
   skipped;
2. per batch, client → server ``C2S_SPLIT_ACTS`` (the cut's activations,
   optionally int8/int4-quantized, ``splitfed/codec.py``) and server →
   client ``S2C_SPLIT_GRADS`` (∂L/∂acts) while the server updates the top;
3. client → server ``C2S_SPLIT_DONE``: the updated bottom params and
   optimizer state, or a ``skipped`` decline when the fault plan crashed
   or dropped the turn: the ring then relays the unchanged bottom state on
   (no quorum deadline would absorb a silent client here).

The numerics are ``splitfed/programs.py``'s boundary programs; over the
wire their composition equals the fused :class:`SplitNNAPI` step, bit for
bit (tests/test_torch_splitfed_transport.py). Params travel in the
reference's flax layout (``bridge.to_flax``) and optimizer states as
their flax-layout leaves, so the messages are the reference's. A manager
computes on its ``device``; the wire is host numpy."""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.bridge import flax_leaves, flax_unflatten, from_flax, to_flax
from fedml_tpu_torch.config import RunConfig
from fedml_tpu_torch.core import compression as CZ
from fedml_tpu_torch.core.comm import BaseCommManager
from fedml_tpu_torch.core.loopback import LoopbackCommManager, LoopbackHub
from fedml_tpu_torch.core.managers import ClientManager, ServerManager
from fedml_tpu_torch.core.message import Message, MessageType as MT
from fedml_tpu_torch.device import DeviceLike, resolve_device
from fedml_tpu_torch.models import ModelDef
from fedml_tpu_torch.splitfed.codec import BOUNDARY_CODECS, ActivationCodec
from fedml_tpu_torch.splitfed.programs import (
    make_split_optimizer,
    make_splitnn_client_backward,
    make_splitnn_client_forward,
    make_splitnn_eval,
    make_splitnn_server_step,
    merge_opt_state,
)
from fedml_tpu_torch.telemetry import (
    ClientHealthRegistry,
    get_comm_meter,
    get_tracer,
    wrap_in_current_scope,
)

JOIN_TIMEOUT_S = 60.0


def from_wire(tree, device) -> dict:
    """A message's flax-layout numpy tree → port params on ``device``."""
    return {k: v.to(device) for k, v in from_flax(tree).items()}


def _state_dicts(state) -> list:
    """The parameter dicts of an optimizer state, in its structure's order."""
    if isinstance(state, dict):
        return [state]
    if isinstance(state, tuple):
        return [d for part in state for d in _state_dicts(part)]
    return []


def opt_leaves(state) -> list:
    """An optimizer state as the reference's wire leaves: each parameter
    dict in flax layout, its leaves in ``jax.tree_util`` order."""
    return [np.ascontiguousarray(a) for d in _state_dicts(state) for a in flax_leaves(to_flax(d))]


def opt_unflatten(template, leaves, device):
    """The inverse of :func:`opt_leaves` on ``template``'s structure (an
    ``opt.init`` of the same params)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            tree = to_flax(node)
            n = len(flax_leaves(tree))
            return from_wire(flax_unflatten(tree, [next(it) for _ in range(n)]), device)
        if isinstance(node, tuple):
            parts = [build(p) for p in node]
            return type(node)(*parts) if hasattr(node, "_fields") else tuple(parts)
        return node

    return build(template)


def _acts_host(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy())


class SplitNNServerManager(ServerManager):
    """The top half's owner and the relay ring's state machine. Rank 0."""

    def __init__(self, config: RunConfig, comm: BaseCommManager, bottom: ModelDef, top: ModelDef,
                 data=None, worker_num: Optional[int] = None, log_fn=None, faults=None,
                 device: DeviceLike = None):
        from fedml_tpu_torch.algorithms.split_nn import init_split_vars
        from fedml_tpu_torch.scheduler import ClientScheduler

        super().__init__(comm, rank=0, config=config)
        self.config = config
        self.bottom, self.top = bottom, top
        self.data = data
        self.device = resolve_device(device)
        self.log_fn = log_fn or (lambda m: None)
        self.worker_num = worker_num or config.fed.client_num_per_round
        ac = getattr(config.comm, "activation_compression", "none")
        if ac not in BOUNDARY_CODECS:
            raise ValueError(f"activation_compression supports {BOUNDARY_CODECS}; got {ac!r}")
        self.faults = faults
        lr, mom, wd = config.train.lr, config.train.momentum, config.train.wd
        # both halves start as the fused simulator's (SplitNNAPI.__init__)
        b, t = init_split_vars(bottom, top, config.seed)
        self._bottom_params = {k: v.to(self.device) for k, v in b.items()}
        self._top_params = {k: v.to(self.device) for k, v in t.items()}
        self._opt = make_split_optimizer(lr, mom, wd)
        self._bottom_opt_state = self._opt.init(self._bottom_params)
        self._top_opt_state = self._opt.init(self._top_params)
        self._server_step = make_splitnn_server_step(top, lr, mom, wd)
        self._eval = make_splitnn_eval(bottom, top) if data is not None else None
        self._codec = ActivationCodec.from_config(config.comm)
        # the round/turn state: handlers run on the comm receive thread; the
        # lock serializes a round's completion against request_stop
        self.round_idx = 0
        self.history: List[dict] = []
        self._round_lock = threading.Lock()
        self._stop_requested = False
        self._federation_done = False
        self._dead_workers: set = set()
        self._cohort: List[int] = []
        self._turn_pos = 0
        self._next_batch = 0
        self._done_seen: set = set()
        self._loss_sum = 0.0
        self._batches = 0
        self.skipped_turns = 0
        self.dropped_boundary = 0  # stale or duplicate boundary messages discarded
        self._round_span = None
        self._tracer = get_tracer()
        self.health = ClientHealthRegistry.from_config(config).attach(self._tracer)
        # the ring's order is the selected cohort's, from the selection policy
        # the horizontal family uses
        self.scheduler = ClientScheduler.from_config(
            config, num_clients=config.fed.client_num_in_total, data=data, log_fn=self.log_fn,
            health=self.health,
        )

    @property
    def global_vars(self) -> dict:
        return {"params": {"bottom": self._bottom_params, "top": self._top_params}}

    @property
    def _server_opt_state(self):
        """Both halves' optimizer states as one fused state over the joint
        params (``programs.merge_opt_state``)."""
        return merge_opt_state(self._bottom_opt_state, self._top_opt_state)

    def finish(self):
        self.health.detach()
        super().finish()

    def request_stop(self, drain: bool = True) -> None:
        """Stop after the open round (``drain``), or close it now with the
        turns already completed."""
        self._stop_requested = True
        if drain:
            return
        with self._round_lock:
            if not self._federation_done:
                self._complete_round()

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MT.C2S_SPLIT_ACTS, self._on_acts)
        self.register_message_receive_handler(MT.C2S_SPLIT_DONE, self._on_done)

    def send_init_msg(self):
        self._t0 = time.monotonic()
        with self._round_lock:
            self._start_round()

    def _broadcast(self, msg: Message) -> bool:
        """Send, tolerating a dead peer: its turn is skipped and the relay
        advances."""
        worker = msg.get_receiver_id()
        if worker in self._dead_workers:
            return False
        try:
            self.send_message(msg)
            return True
        except Exception as e:  # noqa: BLE001 — transport errors vary by backend
            self._dead_workers.add(worker)
            logging.warning("split turn send to worker %d failed (%s) — skipping turn", worker, e)
            return False

    def _start_round(self):
        r = self.round_idx
        self._cohort = list(self.scheduler.select(r, k=self.worker_num))
        self._turn_pos = 0
        self._next_batch = 0
        self._loss_sum = 0.0
        self._batches = 0
        self._round_span = self._tracer.start_span("round", round=r)
        self._send_turn()

    def _send_turn(self):
        """Hand the relay baton (bottom params and optimizer state) to the
        next live client of the ring; a failed hand-off skips the turn."""
        r = self.round_idx
        while self._turn_pos < len(self._cohort):
            worker = self._turn_pos + 1
            msg = Message(MT.S2C_SPLIT_TURN, 0, worker)
            msg.add_params(MT.ARG_MODEL_PARAMS, to_flax(self._bottom_params))
            msg.add_params(MT.ARG_OPT_STATE, opt_leaves(self._bottom_opt_state))
            msg.add_params(MT.ARG_CLIENT_INDEX, int(self._cohort[self._turn_pos]))
            msg.add_params(MT.ARG_ROUND_IDX, r)
            self._next_batch = 0
            with self._tracer.span("broadcast", round=r):
                sent = self._broadcast(msg)
            if sent:
                return
            self.skipped_turns += 1
            self._turn_pos += 1
        self._finish_or_next_round()

    def _turn_is_current(self, msg: Message) -> bool:
        return (
            not self._federation_done
            and msg.get(MT.ARG_ROUND_IDX) == self.round_idx
            and msg.get_sender_id() == self._turn_pos + 1
        )

    def _on_acts(self, msg: Message):
        with self._round_lock:
            self._on_acts_locked(msg)

    def _on_acts_locked(self, msg: Message):
        if not self._turn_is_current(msg) or int(msg.get(MT.ARG_BATCH_IDX)) != self._next_batch:
            self.dropped_boundary += 1
            return
        r = self.round_idx
        worker = msg.get_sender_id()
        payload = msg.get(MT.ARG_ACT_PAYLOAD)
        if payload is not None:
            acts = ActivationCodec.decode(payload, msg.get(MT.ARG_ACT_CODEC))
        else:
            acts = msg.get(MT.ARG_ACTIVATIONS)
        y = msg.get(MT.ARG_BATCH_LABELS)
        with self._tracer.span("boundary", round=r):
            (self._top_params, self._top_opt_state, loss, _correct,
             acts_grad) = self._server_step(
                self._top_params, self._top_opt_state,
                torch.tensor(acts, device=self.device),
                torch.tensor(np.asarray(y), dtype=torch.long, device=self.device),
            )
        self._loss_sum += float(loss)
        self._batches += 1
        g = _acts_host(acts_grad)
        out = Message(MT.S2C_SPLIT_GRADS, 0, worker)
        out.add_params(MT.ARG_ROUND_IDX, r)
        out.add_params(MT.ARG_BATCH_IDX, int(msg.get(MT.ARG_BATCH_IDX)))
        if self._codec is not None:
            gp = self._codec.encode(f"down:{worker}", g)
            get_comm_meter().on_downlink(CZ.payload_bytes(gp), g.nbytes)
            out.add_params(MT.ARG_ACT_PAYLOAD, gp)
            out.add_params(MT.ARG_ACT_CODEC, self._codec.method)
        else:
            get_comm_meter().on_downlink(g.nbytes, g.nbytes)
            out.add_params(MT.ARG_ACT_GRADS, g)
        self._next_batch += 1
        if not self._broadcast(out):
            # the client died mid-turn: its bottom updates are lost with it,
            # and the previous bottom state relays on
            self.skipped_turns += 1
            self._turn_pos += 1
            self._send_turn()

    def _on_done(self, msg: Message):
        with self._round_lock:
            self._on_done_locked(msg)

    def _on_done_locked(self, msg: Message):
        if not self._turn_is_current(msg):
            self.dropped_boundary += 1
            return
        key = (self.round_idx, msg.get_sender_id())
        if key in self._done_seen:  # an at-least-once duplicate
            self.dropped_boundary += 1
            return
        self._done_seen.add(key)
        if msg.get(MT.ARG_SKIPPED):
            self.skipped_turns += 1  # a fault-plan decline: the bottom relays on unchanged
        else:
            self._bottom_params = from_wire(msg.get(MT.ARG_MODEL_PARAMS), self.device)
            self._bottom_opt_state = opt_unflatten(self._bottom_opt_state,
                                                   msg.get(MT.ARG_OPT_STATE), self.device)
        self._turn_pos += 1
        if self._turn_pos < len(self._cohort):
            self._send_turn()
        else:
            self._finish_or_next_round()

    def _finish_or_next_round(self):
        """Caller holds ``_round_lock``."""
        if self._federation_done:
            return
        self._complete_round()

    def _complete_round(self):
        """Close the open round: log the row, advance or finish. Caller
        holds ``_round_lock``."""
        r = self.round_idx
        row = {
            "round": r,
            "t_s": round(time.monotonic() - getattr(self, "_t0", time.monotonic()), 3),
            "Train/Loss": self._loss_sum / max(self._batches, 1),
            "split/skipped_turns": self.skipped_turns,
        }
        if self._eval is not None:
            with self._tracer.span("eval", round=r):
                x, y = self.data.test_x, self.data.test_y
                correct = 0
                for s in range(0, len(y), 128):
                    correct += int(self._eval(
                        self._bottom_params, self._top_params,
                        torch.tensor(np.asarray(x[s : s + 128]), dtype=torch.float32,
                                        device=self.device),
                        torch.tensor(np.asarray(y[s : s + 128]), dtype=torch.long,
                                        device=self.device),
                    ))
                row["Test/Acc"] = correct / max(len(y), 1)
        self.history.append(row)
        self.log_fn(row)
        if self._round_span is not None:
            self._round_span.end()
            self._round_span = None
        self.round_idx = r + 1
        if self.round_idx >= self.config.fed.comm_round or self._stop_requested:
            self._federation_done = True
            for worker in range(1, self.worker_num + 1):
                self._broadcast(Message(MT.FINISH, 0, worker))
            self.finish()
        else:
            self._start_round()


class SplitNNClientManager(ClientManager):
    """The bottom half's owner for one worker slot. It holds the whole
    dataset; a turn message names the client whose shard the slot plays
    this round."""

    def __init__(self, config: RunConfig, comm: BaseCommManager, rank: int, bottom: ModelDef,
                 data, faults=None, device: DeviceLike = None):
        super().__init__(comm, rank, config=config)
        self.config = config
        self.data = data
        self.device = resolve_device(device)
        self._faults = faults
        lr, mom, wd = config.train.lr, config.train.momentum, config.train.wd
        self._opt = make_split_optimizer(lr, mom, wd)
        self._forward = make_splitnn_client_forward(bottom)
        self._backward = make_splitnn_client_backward(bottom, lr, mom, wd)
        self._codec = ActivationCodec.from_config(config.comm)
        self._tracer = get_tracer()
        self._turn: Optional[Dict] = None

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MT.S2C_SPLIT_TURN, self._on_turn)
        self.register_message_receive_handler(MT.S2C_SPLIT_GRADS, self._on_grads)
        self.register_message_receive_handler(MT.FINISH, lambda m: self.finish())

    def _on_turn(self, msg: Message):
        self._turn = None  # a turn the server abandoned leaves no state
        r = int(msg.get(MT.ARG_ROUND_IDX))
        cid = int(msg.get(MT.ARG_CLIENT_INDEX))
        params = from_wire(msg.get(MT.ARG_MODEL_PARAMS), self.device)
        opt_state = opt_unflatten(self._opt.init(params), msg.get(MT.ARG_OPT_STATE), self.device)
        fd = self._faults.decide(cid, r) if self._faults is not None else None
        if fd is not None and (fd.crashed or fd.drop):
            # decline the turn instead of going silent: the server relays
            # the unchanged bottom state to the next client
            self._faults.record(cid, r, "crash" if fd.crashed else "dropout")
            self._send_done(r, cid, skipped=True)
            return
        if fd is not None and fd.slowdown_s:
            self._faults.record(cid, r, "slowdown", detail=fd.slowdown_s)
            time.sleep(fd.slowdown_s)
        x, y = self.data.client_x[cid], self.data.client_y[cid]
        bs = int(self.config.data.batch_size)
        n = len(y)
        # SplitNNAPI.train_ring's batch walk: no shuffle, a partial batch
        # dropped, `epochs` epochs
        starts = [s for _ in range(int(self.config.fed.epochs)) for s in range(0, n - bs + 1, bs)]
        self._turn = {"round": r, "cid": cid, "params": params, "opt_state": opt_state,
                      "starts": starts, "pos": 0,
                      "flaky": bool(fd.flaky) if fd is not None else False,
                      "x": x, "y": y, "bs": bs, "xb": None}
        if not starts:
            self._send_done(r, cid, skipped=False)
            return
        self._send_acts()

    def _send_acts(self):
        t = self._turn
        r, pos, bs = t["round"], t["pos"], t["bs"]
        s = t["starts"][pos]
        xb = torch.tensor(np.asarray(t["x"][s : s + bs]), dtype=torch.float32,
                             device=self.device)
        t["xb"] = xb
        with self._tracer.span("forward", round=r):
            acts = _acts_host(self._forward(t["params"], xb))
        out = Message(MT.C2S_SPLIT_ACTS, self.rank, 0)
        if self._codec is not None:
            payload = self._codec.encode(f"up:{self.rank}", acts)
            get_comm_meter().on_uplink(CZ.payload_bytes(payload), acts.nbytes)
            out.add_params(MT.ARG_ACT_PAYLOAD, payload)
            out.add_params(MT.ARG_ACT_CODEC, self._codec.method)
        else:
            get_comm_meter().on_uplink(acts.nbytes, acts.nbytes)
            out.add_params(MT.ARG_ACTIVATIONS, acts)
        out.add_params(MT.ARG_BATCH_LABELS, np.asarray(t["y"][s : s + bs]))
        out.add_params(MT.ARG_BATCH_IDX, pos)
        out.add_params(MT.ARG_ROUND_IDX, r)
        out.add_params(MT.ARG_CLIENT_INDEX, t["cid"])
        self.send_message(out)

    def _on_grads(self, msg: Message):
        t = self._turn
        if (t is None or int(msg.get(MT.ARG_ROUND_IDX)) != t["round"]
                or int(msg.get(MT.ARG_BATCH_IDX)) != t["pos"]):
            return  # a stale round or a duplicate batch reply
        payload = msg.get(MT.ARG_ACT_PAYLOAD)
        if payload is not None:
            g = ActivationCodec.decode(payload, msg.get(MT.ARG_ACT_CODEC))
        else:
            g = msg.get(MT.ARG_ACT_GRADS)
        with self._tracer.span("backward", round=t["round"]):
            t["params"], t["opt_state"] = self._backward(
                t["params"], t["opt_state"], t["xb"], torch.tensor(g, device=self.device))
        t["pos"] += 1
        if t["pos"] < len(t["starts"]):
            self._send_acts()
        else:
            self._send_done(t["round"], t["cid"], skipped=False)

    def _send_done(self, r: int, cid: int, skipped: bool):
        out = Message(MT.C2S_SPLIT_DONE, self.rank, 0)
        out.add_params(MT.ARG_ROUND_IDX, r)
        out.add_params(MT.ARG_CLIENT_INDEX, cid)
        if skipped:
            out.add_params(MT.ARG_SKIPPED, True)
        else:
            t = self._turn
            out.add_params(MT.ARG_MODEL_PARAMS, to_flax(t["params"]))
            out.add_params(MT.ARG_OPT_STATE, opt_leaves(t["opt_state"]))
        flaky = self._turn is not None and self._turn.get("flaky")
        self._turn = None
        self.send_message(out)
        if flaky:
            # at-least-once double delivery; the server's (round, worker)
            # dedupe absorbs the copy
            self._faults.record(cid, r, "flaky")
            try:
                self.send_message(out)
            except Exception:  # noqa: BLE001 — a best-effort duplicate
                pass


def run_loopback_splitnn(config: RunConfig, data, bottom: Optional[ModelDef] = None,
                         top: Optional[ModelDef] = None, log_fn=None, faults=None,
                         device: DeviceLike = None):
    """A one-process split federation over the loopback hub: the server and
    ``client_num_per_round`` client actors in threads. Returns the server
    (``global_vars``, ``history``, ``skipped_turns``); raises if a client
    thread outlives :data:`JOIN_TIMEOUT_S` after the server finished."""
    if bottom is None or top is None:
        from fedml_tpu_torch.algorithms.split_nn import default_split_models

        bottom, top = default_split_models(tuple(data.client_x[0].shape[1:]), data.num_classes)
    hub = LoopbackHub()
    k = config.fed.client_num_per_round
    server = SplitNNServerManager(config, LoopbackCommManager(hub, 0), bottom, top, data=data,
                                  worker_num=k, log_fn=log_fn, faults=faults, device=device)
    clients = [SplitNNClientManager(config, LoopbackCommManager(hub, rank), rank, bottom, data,
                                    faults=faults, device=device)
               for rank in range(1, k + 1)]
    threads = [threading.Thread(target=wrap_in_current_scope(c.run), daemon=True,
                                name=f"splitnn-client-{c.rank}") for c in clients]
    for t in threads:
        t.start()
    server.send_init_msg()
    server.run()
    for t in threads:
        t.join(timeout=JOIN_TIMEOUT_S)
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        raise RuntimeError(f"split federation: client threads {alive} did not finish")
    return server
