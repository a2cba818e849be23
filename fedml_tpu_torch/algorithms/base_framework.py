"""Minimal distributed-algorithm templates (port of
``fedml_tpu/algorithms/base_framework.py``): a central worker that sums one
scalar from every client, and a serverless gossip worker that mixes its
value with its topology in-neighbors' each round. They are the starting
points for a new algorithm (subclass, replace the payload and handlers, keep
the actor wiring) and run over any comm manager of ``fedml_tpu_torch.core``;
:func:`run_base_framework` drives the central one over loopback."""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from fedml_tpu_torch.core.comm import BaseCommManager
from fedml_tpu_torch.core.loopback import LoopbackCommManager, LoopbackHub
from fedml_tpu_torch.core.managers import ClientManager, ServerManager
from fedml_tpu_torch.core.message import Message

MSG_C2S_VALUE = "base_c2s_value"
MSG_S2C_START = "base_s2c_start"
MSG_FINISH = "base_finish"
MSG_GOSSIP = "gossip_result"


class BaseCentralWorker(ServerManager):
    """Sums one scalar from every client (ref central_worker.py:28-32)."""

    def __init__(self, comm: BaseCommManager, worker_num: int):
        super().__init__(comm, rank=0)
        self.worker_num = worker_num
        self.values: List[float] = []
        self.total: Optional[float] = None

    def start(self):
        for w in range(1, self.worker_num + 1):
            self.send_message(Message(MSG_S2C_START, 0, w))

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_C2S_VALUE, self._on_value)

    def _on_value(self, msg: Message):
        self.values.append(float(msg.get("value")))
        if len(self.values) == self.worker_num:
            self.total = sum(self.values)
            for w in range(1, self.worker_num + 1):
                self.send_message(Message(MSG_FINISH, 0, w))
            self.finish()


class BaseClientWorker(ClientManager):
    """Replies with its payload (ref client_worker.py:10-12 returns
    client_index)."""

    def __init__(self, comm: BaseCommManager, rank: int, value_fn: Callable[[], float]):
        super().__init__(comm, rank)
        self.value_fn = value_fn

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_S2C_START, self._on_start)
        self.register_message_receive_handler(MSG_FINISH, lambda m: self.finish())

    def _on_start(self, msg: Message):
        out = Message(MSG_C2S_VALUE, self.rank, 0)
        out.add_params("value", float(self.value_fn()))
        self.send_message(out)


def run_base_framework(worker_values: List[float]) -> float:
    """Loopback demo run (ref FedML_Base_distributed, algorithm_api.py:16-21).
    Returns the central sum."""
    hub = LoopbackHub()
    K = len(worker_values)
    server = BaseCentralWorker(LoopbackCommManager(hub, 0), K)
    clients = [
        BaseClientWorker(
            LoopbackCommManager(hub, r), r, (lambda v=v: v)
        )
        for r, v in enumerate(worker_values, start=1)
    ]
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    server.start()
    server.run()
    for t in threads:
        t.join(timeout=30)
    assert server.total is not None
    return server.total


class DecentralizedWorkerManager(ClientManager):
    """Serverless gossip template (ref decentralized_worker_manager.py:8-46:
    each worker trains, sends to topology out-neighbors, waits for all
    in-neighbors, then averages)."""

    def __init__(
        self,
        comm: BaseCommManager,
        rank: int,
        topology,
        value: np.ndarray,
        rounds: int = 1,
    ):
        super().__init__(comm, rank)
        self.topology = topology
        self.value = np.asarray(value, np.float64)
        self.rounds = rounds
        self.round_idx = 0
        # Keyed by (round, sender): a fast neighbor's round r+1 message must
        # not complete (or overwrite a value in) the round-r barrier (ref
        # decentralized_worker_manager.py:29-46 per-round barrier semantics).
        self._inbox: Dict[tuple, np.ndarray] = {}

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_GOSSIP, self._on_gossip)

    def run(self):
        # Round 0 is initiated from THIS thread, before the receive loop
        # starts: handlers also run on this thread, so every mutation of
        # (round_idx, value, inbox) is single-threaded. Starting gossip
        # from the launcher thread instead is a deadlock: a worker whose
        # in-neighbors all delivered can advance to round 1 in its receive
        # thread before the launcher sends its round-0 value, after which
        # the launcher's send carries a round-1 tag and the round-0 value
        # is never published — its neighbors wait on (0, rank) forever.
        self.start_gossip()
        super().run()

    def start_gossip(self):
        for j in self.topology.get_out_neighbor_idx_list(self.rank):
            m = Message(MSG_GOSSIP, self.rank, j)
            m.add_params("value", self.value)
            m.add_params("round", self.round_idx)
            self.send_message(m)

    def _on_gossip(self, msg: Message):
        self._inbox[(int(msg.get("round")), msg.get_sender_id())] = msg.get("value")
        in_neighbors = self.topology.get_in_neighbor_idx_list(self.rank)
        # Advance while the *current* round's barrier is complete; buffered
        # future-round values stay in the inbox until their round arrives.
        while all((self.round_idx, j) in self._inbox for j in in_neighbors):
            # weighted mix with the confusion-matrix row (ref __train:41-46;
            # the reference's symmetric manager returns the row for both
            # in/out, symmetric_topology_manager.py:55-61)
            w = self.topology.get_out_neighbor_weights(self.rank)
            mixed = self.value * w[self.rank]
            for j in in_neighbors:
                v = self._inbox.pop((self.round_idx, j))
                mixed = mixed + np.asarray(v) * w[j]
            self.value = mixed
            self.round_idx += 1
            if self.round_idx >= self.rounds:
                self.finish()
                return
            self.start_gossip()
