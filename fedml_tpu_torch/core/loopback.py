"""In-process loopback transport (port of ``fedml_tpu/core/loopback.py``).

One hub owns a queue per rank; managers run their receive loops in ordinary
threads. The hub carries the serialized FTM1 **bytes**, not Message
objects, so every message crosses the real wire format — and a manager of
either package can put and take bytes on the same queues (a mixed
federation). The encode and decode of each message are recorded as
``to_bytes`` / ``from_bytes`` spans on the process tracer, which is where a
run reads its serialization time."""

from __future__ import annotations

import queue
import threading
from typing import Dict

from fedml_tpu_torch.core.comm import BaseCommManager
from fedml_tpu_torch.core.message import Message
from fedml_tpu_torch.telemetry.spans import get_tracer

_STOP = object()


class LoopbackHub:
    """Shared router: rank -> inbox queue."""

    def __init__(self):
        self._inboxes: Dict[int, "queue.Queue"] = {}
        self._lock = threading.Lock()

    def inbox(self, rank: int) -> "queue.Queue":
        with self._lock:
            if rank not in self._inboxes:
                self._inboxes[rank] = queue.Queue()
            return self._inboxes[rank]

    def deliver(self, msg: Message) -> None:
        with get_tracer().span("to_bytes", msg_type=msg.get_type()):
            data = msg.to_bytes()
        self.inbox(msg.get_receiver_id()).put(data)


class LoopbackCommManager(BaseCommManager):
    def __init__(self, hub: LoopbackHub, rank: int):
        super().__init__()
        self.hub = hub
        self.rank = rank
        self._inbox = hub.inbox(rank)

    def _send(self, msg: Message) -> None:
        self.hub.deliver(msg)

    def handle_receive_message(self) -> None:
        while True:
            item = self._inbox.get()
            if item is _STOP:
                break
            with get_tracer().span("from_bytes", rank=self.rank):
                msg = Message.from_bytes(item)
            self.notify(msg)

    def stop_receive_message(self) -> None:
        self._inbox.put(_STOP)
