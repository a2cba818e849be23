"""Actor runtime: ClientManager/ServerManager (port of
``fedml_tpu/core/managers.py``).

A manager takes a comm manager, registers as its Observer, keeps a
msg_type → handler registry, and ``run()`` enters the receive loop;
``finish()`` stops it."""

from __future__ import annotations

from typing import Callable, Dict

from fedml_tpu_torch.core.comm import BaseCommManager, Observer
from fedml_tpu_torch.core.message import Message
from fedml_tpu_torch.core.retry import RetryPolicy


class _ManagerBase(Observer):
    def __init__(self, comm: BaseCommManager, rank: int, config=None):
        self.comm = comm
        self.rank = rank
        self._handlers: Dict[str, Callable[[Message], None]] = {}
        comm.add_observer(self)
        # transport retry (core/retry.py) from CommConfig.send_*, installed
        # once here for every manager on every backend
        if config is not None:
            comm.set_retry_policy(RetryPolicy.from_config(config.comm, seed=config.seed))

    def register_message_receive_handler(
        self, msg_type: str, handler: Callable[[Message], None]
    ) -> None:
        self._handlers[msg_type] = handler

    def register_message_receive_handlers(self) -> None:
        """Subclasses wire their handlers here."""

    def receive_message(self, msg_type: str, msg: Message) -> None:
        handler = self._handlers.get(msg_type)
        if handler is None:
            raise KeyError(f"rank {self.rank}: no handler for message type {msg_type!r}")
        handler(msg)

    def send_message(self, msg: Message) -> None:
        self.comm.send_message(msg)

    def run(self) -> None:
        self.register_message_receive_handlers()
        self.comm.handle_receive_message()

    def finish(self) -> None:
        self.comm.stop_receive_message()


class ClientManager(_ManagerBase):
    """A federation client's actor."""


class ServerManager(_ManagerBase):
    """A federation server's actor."""
