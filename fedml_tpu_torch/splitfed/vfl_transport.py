"""Distributed classical vertical FL over the Message/Observer transport
(port of ``fedml_tpu/splitfed/vfl_transport.py``).

The guest (rank 0) holds the labels and its own feature slice; host k
(rank k ≥ 1) holds party k's columns. Per batch:

1. guest → hosts ``S2C_VFL_BATCH``: the batch index (the parties walk the
   same drop-partial batch grid over their aligned samples, so the index
   is the whole message);
2. host → guest ``C2S_VFL_CONTRIB``: its logit contribution h_k,
   optionally int8/int4-quantized;
3. the guest sums the contributions with its own, takes the loss, updates
   its own stack and returns ``S2C_VFL_GRADS`` with ∂L/∂h_k to each host,
   which backpropagates through its stack.

The numerics are ``splitfed/programs.py``'s party programs; the wire
composition equals the fused :class:`VFLAPI` step bit for bit
(tests/test_torch_splitfed_transport.py). A host's FIFO inbox puts batch
t's gradients before batch t+1's announcement, so no barrier message is
needed."""

from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np
import torch

from fedml_tpu_torch.config import RunConfig
from fedml_tpu_torch.core import compression as CZ
from fedml_tpu_torch.core.comm import BaseCommManager
from fedml_tpu_torch.core.loopback import LoopbackCommManager, LoopbackHub
from fedml_tpu_torch.core.managers import ClientManager, ServerManager
from fedml_tpu_torch.core.message import Message, MessageType as MT
from fedml_tpu_torch.device import DeviceLike, resolve_device
from fedml_tpu_torch.splitfed.codec import ActivationCodec
from fedml_tpu_torch.splitfed.programs import (
    make_vfl_party_update,
    vfl_guest_grad,
    vfl_party_forward,
)
from fedml_tpu_torch.telemetry import get_comm_meter, get_tracer, wrap_in_current_scope
from fedml_tpu_torch.train import optim

JOIN_TIMEOUT_S = 60.0
MOMENTUM = 0.9


def _party_params(feature_splits, hidden_dim, out_dim, seed, party_idx, device):
    """Party ``party_idx``'s init, as ``VFLAPI.__init__`` draws it."""
    from fedml_tpu_torch.algorithms.vertical_fl import VFLParty, party_generator

    party = VFLParty(int(feature_splits[party_idx]), hidden_dim, out_dim,
                     party_generator(seed, party_idx), has_labels=(party_idx == 0))
    return {k: v.to(device) for k, v in party.params.items()}


def _batch_starts(n: int, bs: int) -> List[int]:
    return list(range(0, n - bs + 1, bs))


def _host(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy())


class VFLGuestManager(ServerManager):
    """The label holder and the per-batch state machine. Rank 0, party 0."""

    def __init__(self, config: RunConfig, comm: BaseCommManager, x_guest: np.ndarray,
                 y: np.ndarray, feature_splits, hidden_dim: int = 16, out_dim: int = 1,
                 log_fn=None, device: DeviceLike = None):
        super().__init__(comm, rank=0, config=config)
        self.config = config
        self.device = resolve_device(device)
        self.x = np.asarray(x_guest)
        self.y = np.asarray(y, np.float32)
        self.feature_splits = tuple(int(d) for d in feature_splits)
        self.n_parties = len(self.feature_splits)
        self.log_fn = log_fn or (lambda m: None)
        lr = config.train.lr
        self.params = _party_params(self.feature_splits, hidden_dim, out_dim, config.seed, 0,
                                    self.device)
        self.opt_state = optim.sgd(lr, momentum=MOMENTUM).init(self.params)
        self._update = make_vfl_party_update(lr=lr, momentum=MOMENTUM)
        self._codec = ActivationCodec.from_config(config.comm)
        self._tracer = get_tracer()
        self.round_idx = 0
        self.history: List[dict] = []
        self._starts = _batch_starts(len(self.y), int(config.data.batch_size))
        self._batch = 0
        self._contribs: Dict[int, np.ndarray] = {}
        self._loss_sum = 0.0
        self._correct = 0
        self._round_span = None
        self._federation_done = False

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MT.C2S_VFL_CONTRIB, self._on_contrib)

    def send_init_msg(self):
        self._t0 = time.monotonic()
        self._start_round()

    def _start_round(self):
        r = self.round_idx
        self._batch = 0
        self._loss_sum = 0.0
        self._correct = 0
        self._round_span = self._tracer.start_span("round", round=r)
        if not self._starts:
            self._complete_round()
            return
        self._announce_batch()

    def _announce_batch(self):
        r = self.round_idx
        self._contribs = {}
        with self._tracer.span("broadcast", round=r):
            for host in range(1, self.n_parties):
                msg = Message(MT.S2C_VFL_BATCH, 0, host)
                msg.add_params(MT.ARG_ROUND_IDX, r)
                msg.add_params(MT.ARG_BATCH_IDX, self._batch)
                self.send_message(msg)

    def _on_contrib(self, msg: Message):
        if (self._federation_done or int(msg.get(MT.ARG_ROUND_IDX)) != self.round_idx
                or int(msg.get(MT.ARG_BATCH_IDX)) != self._batch):
            return
        payload = msg.get(MT.ARG_ACT_PAYLOAD)
        if payload is not None:
            contrib = ActivationCodec.decode(payload, msg.get(MT.ARG_ACT_CODEC))
        else:
            contrib = msg.get(MT.ARG_CONTRIB)
        self._contribs[msg.get_sender_id()] = np.asarray(contrib)
        if len(self._contribs) == self.n_parties - 1:
            self._process_batch()

    def _process_batch(self):
        r = self.round_idx
        s = self._starts[self._batch]
        bs = int(self.config.data.batch_size)
        xb = torch.tensor(self.x[s : s + bs], dtype=torch.float32, device=self.device)
        yb = torch.tensor(self.y[s : s + bs], device=self.device)
        with self._tracer.span("boundary", round=r):
            own = vfl_party_forward(self.params, xb)
            ordered = [own] + [torch.tensor(self._contribs[h], device=self.device)
                               for h in range(1, self.n_parties)]
            loss, correct, grads = vfl_guest_grad(ordered, yb)
            self.params, self.opt_state = self._update(self.params, self.opt_state, xb, grads[0])
        self._loss_sum += float(loss)
        self._correct += int(correct)
        for host in range(1, self.n_parties):
            g = _host(grads[host])
            out = Message(MT.S2C_VFL_GRADS, 0, host)
            out.add_params(MT.ARG_ROUND_IDX, r)
            out.add_params(MT.ARG_BATCH_IDX, self._batch)
            if self._codec is not None:
                gp = self._codec.encode(f"down:{host}", g)
                get_comm_meter().on_downlink(CZ.payload_bytes(gp), g.nbytes)
                out.add_params(MT.ARG_ACT_PAYLOAD, gp)
                out.add_params(MT.ARG_ACT_CODEC, self._codec.method)
            else:
                get_comm_meter().on_downlink(g.nbytes, g.nbytes)
                out.add_params(MT.ARG_CONTRIB_GRAD, g)
            self.send_message(out)
        self._batch += 1
        if self._batch < len(self._starts):
            self._announce_batch()
        else:
            self._complete_round()

    def _complete_round(self):
        r = self.round_idx
        seen = len(self._starts) * int(self.config.data.batch_size)
        row = {
            "round": r,
            "t_s": round(time.monotonic() - getattr(self, "_t0", time.monotonic()), 3),
            "Train/Loss": self._loss_sum / max(len(self._starts), 1),
            "Train/Acc": self._correct / max(seen, 1),
        }
        self.history.append(row)
        self.log_fn(row)
        if self._round_span is not None:
            self._round_span.end()
            self._round_span = None
        self.round_idx = r + 1
        if self.round_idx >= self.config.fed.comm_round:
            self._federation_done = True
            for host in range(1, self.n_parties):
                self.send_message(Message(MT.FINISH, 0, host))
            self.finish()
        else:
            self._start_round()


class VFLHostManager(ClientManager):
    """Party ``rank``'s feature-slice holder."""

    def __init__(self, config: RunConfig, comm: BaseCommManager, rank: int, x_host: np.ndarray,
                 n_samples: int, feature_splits, hidden_dim: int = 16, out_dim: int = 1,
                 device: DeviceLike = None):
        super().__init__(comm, rank, config=config)
        self.config = config
        self.device = resolve_device(device)
        self.x = np.asarray(x_host)
        lr = config.train.lr
        self.params = _party_params(tuple(feature_splits), hidden_dim, out_dim, config.seed, rank,
                                    self.device)
        self.opt_state = optim.sgd(lr, momentum=MOMENTUM).init(self.params)
        self._update = make_vfl_party_update(lr=lr, momentum=MOMENTUM)
        self._codec = ActivationCodec.from_config(config.comm)
        self._tracer = get_tracer()
        self._starts = _batch_starts(n_samples, int(config.data.batch_size))
        self._xb = None
        self._pending = None  # (round, batch) awaiting its gradient

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MT.S2C_VFL_BATCH, self._on_batch)
        self.register_message_receive_handler(MT.S2C_VFL_GRADS, self._on_grads)
        self.register_message_receive_handler(MT.FINISH, lambda m: self.finish())

    def _on_batch(self, msg: Message):
        r = int(msg.get(MT.ARG_ROUND_IDX))
        bi = int(msg.get(MT.ARG_BATCH_IDX))
        s = self._starts[bi]
        bs = int(self.config.data.batch_size)
        self._xb = torch.tensor(self.x[s : s + bs], dtype=torch.float32, device=self.device)
        self._pending = (r, bi)
        with self._tracer.span("forward", round=r):
            contrib = _host(vfl_party_forward(self.params, self._xb))
        out = Message(MT.C2S_VFL_CONTRIB, self.rank, 0)
        out.add_params(MT.ARG_ROUND_IDX, r)
        out.add_params(MT.ARG_BATCH_IDX, bi)
        if self._codec is not None:
            payload = self._codec.encode(f"up:{self.rank}", contrib)
            get_comm_meter().on_uplink(CZ.payload_bytes(payload), contrib.nbytes)
            out.add_params(MT.ARG_ACT_PAYLOAD, payload)
            out.add_params(MT.ARG_ACT_CODEC, self._codec.method)
        else:
            get_comm_meter().on_uplink(contrib.nbytes, contrib.nbytes)
            out.add_params(MT.ARG_CONTRIB, contrib)
        self.send_message(out)

    def _on_grads(self, msg: Message):
        key = (int(msg.get(MT.ARG_ROUND_IDX)), int(msg.get(MT.ARG_BATCH_IDX)))
        if self._pending != key:
            return  # a stale or duplicate reply
        self._pending = None
        payload = msg.get(MT.ARG_ACT_PAYLOAD)
        if payload is not None:
            g = ActivationCodec.decode(payload, msg.get(MT.ARG_ACT_CODEC))
        else:
            g = msg.get(MT.ARG_CONTRIB_GRAD)
        with self._tracer.span("backward", round=key[0]):
            self.params, self.opt_state = self._update(
                self.params, self.opt_state, self._xb, torch.tensor(g, device=self.device))


def run_loopback_vfl(config: RunConfig, xs_parties, y, hidden_dim: int = 16, out_dim: int = 1,
                     log_fn=None, device: DeviceLike = None):
    """A one-process vertical federation over the loopback hub: the guest
    and ``len(xs_parties) - 1`` host actors in threads. Returns ``(guest,
    hosts)``; raises if a host thread outlives :data:`JOIN_TIMEOUT_S` after
    the guest finished."""
    feature_splits = [int(np.asarray(x).shape[1]) for x in xs_parties]
    hub = LoopbackHub()
    guest = VFLGuestManager(config, LoopbackCommManager(hub, 0), xs_parties[0], y,
                            feature_splits, hidden_dim=hidden_dim, out_dim=out_dim,
                            log_fn=log_fn, device=device)
    hosts = [VFLHostManager(config, LoopbackCommManager(hub, rank), rank, xs_parties[rank],
                            len(y), feature_splits, hidden_dim=hidden_dim, out_dim=out_dim,
                            device=device)
             for rank in range(1, len(xs_parties))]
    threads = [threading.Thread(target=wrap_in_current_scope(h.run), daemon=True,
                                name=f"vfl-host-{h.rank}") for h in hosts]
    for t in threads:
        t.start()
    guest.send_init_msg()
    guest.run()
    for t in threads:
        t.join(timeout=JOIN_TIMEOUT_S)
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        raise RuntimeError(f"vertical federation: host threads {alive} did not finish")
    return guest, hosts
