"""Shared-memory local transport (port of ``fedml_tpu/core/shm_comm.py``;
stdlib only).

- **bulk path**: the sender assembles the binary wire image (core/message.py)
  directly into a POSIX ``SharedMemory`` segment — one copy total; the
  receiver maps the segment and decodes a copy of it before the segment
  is unlinked.
- **control path**: a tiny pickled ``{"shm": name, "nbytes": n}`` record over
  a per-rank ``multiprocessing.connection`` UNIX socket.

Same Observer contract as the loopback backend, so it slots into
``run_federation`` unchanged. The encode and decode are recorded as
``to_bytes`` / ``from_bytes`` spans, as on the loopback hub. The
reference's ``zero_copy`` decode is not ported (ROADMAP.md)."""

from __future__ import annotations

import os
import threading
import traceback
from multiprocessing import connection, shared_memory

from fedml_tpu_torch.core.comm import BaseCommManager
from fedml_tpu_torch.core.message import Message, write_wire_parts
from fedml_tpu_torch.telemetry.spans import get_tracer

_FAMILY = "AF_UNIX"


def _addr(sock_dir: str, rank: int, namespace: str = "") -> str:
    ns = f"{namespace}_" if namespace else ""
    return os.path.join(sock_dir, f"fedml_shm_{ns}{rank}.sock")


class ShmCommManager(BaseCommManager):
    """One per participant; ``rank`` names this endpoint (server = 0).

    ``namespace`` prefixes every socket name so two concurrent federations
    sharing one ``sock_dir`` cannot collide: without it the second
    federation's rank-N constructor unlinks-and-rebinds the first one's
    live rank-N socket and the two fleets cross-deliver. All participants
    of one federation must use the SAME namespace. "" keeps the reference's
    socket names."""

    def __init__(
        self,
        rank: int,
        sock_dir: str,
        namespace: str = "",
    ):
        super().__init__()
        self.rank = int(rank)
        self.sock_dir = sock_dir
        self.namespace = str(namespace)
        addr = _addr(sock_dir, self.rank, self.namespace)
        if os.path.exists(addr):  # stale socket from a crashed run
            os.unlink(addr)
        # backlog: the default (1) makes a K-client broadcast race the
        # receive loop's accept — a sender connecting while the listener is
        # busy decoding gets BlockingIOError(EAGAIN) and takes the whole
        # federation down; size it to a realistic worker fan-in instead
        self._listener = connection.Listener(addr, family=_FAMILY, backlog=64)
        self._stopped = threading.Event()
        self._loop_running = False

    # -- send: one copy (wire image → shared pages) --
    def _send(self, msg: Message) -> None:
        # serialize exactly once: size and write come from the same parts
        tracer = get_tracer()
        t0_us = tracer.now_us()
        header, buffers = msg.to_wire_parts()
        size = len(header) + sum(int(b.nbytes) for b in buffers)
        seg = shared_memory.SharedMemory(create=True, size=max(size, 1))
        try:
            written = write_wire_parts(seg.buf, header, buffers)
            tracer.record_event("to_bytes", t0_us, tracer.now_us() - t0_us,
                                msg_type=msg.get_type())
            with connection.Client(
                _addr(self.sock_dir, msg.get_receiver_id(), self.namespace),
                family=_FAMILY,
            ) as conn:
                conn.send({"shm": seg.name, "nbytes": written})
        except BaseException:
            seg.unlink()  # nobody will ever map it
            raise
        finally:
            seg.close()  # receiver owns the segment now

    # -- receive loop: map, decode (optionally aliasing), notify, unlink --
    def handle_receive_message(self) -> None:
        self._loop_running = True
        self._loop_thread = threading.current_thread()
        try:
            while not self._stopped.is_set():
                try:
                    with self._listener.accept() as conn:
                        rec = conn.recv()
                except (OSError, EOFError):
                    if self._stopped.is_set():
                        break  # stop() closed the listener under accept()
                    raise
                if rec.get("stop"):
                    break
                self._consume(rec, notify=True)
        finally:
            self._loop_running = False
            self._drain_and_close()

    def _consume(self, rec: dict, notify: bool) -> None:
        seg = shared_memory.SharedMemory(name=rec["shm"])
        msg = view = None
        try:
            try:
                if notify:
                    view = seg.buf[: rec["nbytes"]]
                    with get_tracer().span("from_bytes", rank=self.rank):
                        msg = Message.from_bytes(view, copy=True)
                    self.notify(msg)
            except BaseException as e:
                # the in-flight traceback's frames (notify → observer) hold
                # ``msg`` and would keep the mapping exported, turning the
                # handler's exception into a masking BufferError at close();
                # clear frame locals, keep file/line info
                traceback.clear_frames(e.__traceback__)
                raise
            finally:
                del msg, view  # release buffer refs before close()
        finally:
            seg.close()
            try:
                seg.unlink()
            except FileNotFoundError:
                pass

    def _drain_and_close(self) -> None:
        """Unlink segments from sends that landed in the stop window, then
        close the listener (receive-loop thread owns this teardown)."""
        sock = getattr(getattr(self._listener, "_listener", None), "_socket", None)
        if sock is not None:
            try:
                sock.settimeout(0.05)
                while True:
                    with self._listener.accept() as conn:
                        rec = conn.recv()
                    if not rec.get("stop"):
                        self._consume(rec, notify=False)
            except (OSError, EOFError):
                pass
        try:
            self._listener.close()
        except OSError:
            pass
        addr = _addr(self.sock_dir, self.rank, self.namespace)
        try:
            os.unlink(addr)
        except OSError:
            pass

    def stop_receive_message(self) -> None:
        already = self._stopped.is_set()
        self._stopped.set()
        if (
            self._loop_running
            and threading.current_thread() is getattr(self, "_loop_thread", None)
        ):
            # Reentrant stop — called from inside a handler, i.e. ON the
            # receive-loop thread (a server finishing from its own upload
            # handler). The flag alone suffices: the
            # loop re-checks _stopped before its next accept(), and the
            # loop's finally owns teardown. The self-connect wake below
            # would DEADLOCK here: with peers still connecting, the
            # backlog-1 listener is full and the only accept()-er is this
            # very thread.
            return
        if not self._loop_running:
            # no receive loop to drain (never started, or already exited):
            # tear down here instead of queueing a stop record nobody reads
            if not already:
                self._drain_and_close()
            return
        try:
            with connection.Client(
                _addr(self.sock_dir, self.rank, self.namespace),
                family=_FAMILY,
            ) as conn:
                conn.send({"stop": True})
        except (ConnectionError, FileNotFoundError, OSError):
            pass  # loop exited between the check and the connect; it drains
