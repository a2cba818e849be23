"""Backend-agnostic communication interface (port of
``fedml_tpu/core/comm.py``): the same Observer contract, so loopback
(core/loopback.py), shared memory (core/shm_comm.py), MQTT (core/mqtt_comm.py)
and gRPC (core/grpc_comm.py) slot in identically.

``send_message`` is a template method: it stamps the ``_trace`` meta key
(telemetry/wire.py) exactly as the reference does, so the port's envelopes
are the reference's byte for byte; retries a failed ``_send`` under the
installed :class:`~fedml_tpu_torch.core.retry.RetryPolicy` (a
:class:`~fedml_tpu_torch.core.retry.RemoteRefusal` is metered apart as
``send_refused``); and meters
messages and wire bytes (telemetry/comm.py). ``send_message_nowait`` stamps
and meters one attempt and never retries (shutdown broadcasts). ``notify`` dispatches to the
observers and meters what arrived. Wire sizes come from the envelope itself:
``Message.to_wire_parts``/``from_bytes`` stamp the serialized size on the
message, so accounting costs no extra serialization pass."""

from __future__ import annotations

import abc
import itertools
import time
from typing import List, Optional

from fedml_tpu_torch.core.message import Message, MessageType
from fedml_tpu_torch.core.retry import InjectedSendFault, RemoteRefusal, RetryPolicy
from fedml_tpu_torch.telemetry.comm import get_comm_meter
from fedml_tpu_torch.telemetry.spans import get_tracer
from fedml_tpu_torch.telemetry.wire import TraceContext


def _wire_bytes(msg: Message) -> Optional[int]:
    """The envelope's serialized size — stamped by to_wire_parts/from_bytes
    when the message crossed a serialization boundary, computed lazily
    otherwise (in-process delivery that skipped serialization must not
    vanish from byte accounting; wire_size() stamps, so it runs once)."""
    nbytes = getattr(msg, "_wire_nbytes", None)
    if nbytes is None:
        try:
            nbytes = msg.wire_size()
        except Exception:  # noqa: BLE001 — accounting must never raise
            nbytes = None
    return nbytes


class Observer(abc.ABC):
    @abc.abstractmethod
    def receive_message(self, msg_type: str, msg: Message) -> None: ...


class BaseCommManager(abc.ABC):
    def __init__(self):
        self._observers: List[Observer] = []
        self._meter = get_comm_meter()
        # send retry policy (core/retry.py): installed once by the manager
        # base (_ManagerBase) from CommConfig.send_*; None = legacy
        # single-attempt sends. The per-manager send sequence keys the
        # deterministic jitter/chaos streams — each manager's sends are
        # issued in deterministic order (one actor thread per manager), so
        # the whole retry schedule replays run over run.
        self.retry_policy: Optional[RetryPolicy] = None
        self._send_seq = itertools.count()
        # federation trace id (telemetry/wire.py): minted by the first
        # sender, adopted from the first _trace-carrying receive — the
        # correlation key server and client spans share
        self._trace_ctx = TraceContext()
        self._trace_seq = itertools.count()

    def set_retry_policy(self, policy: Optional[RetryPolicy]) -> None:
        self.retry_policy = policy

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        self._observers.remove(observer)

    def notify(self, msg: Message) -> None:
        trace = getattr(msg, "trace", None)
        arrival_us = None
        if isinstance(trace, dict):
            # adopt the sender's federation trace id (first one wins) and
            # timestamp arrival on OUR clock
            self._trace_ctx.adopt(trace.get("id"))
            arrival_us = get_tracer().now_us()
        t0 = time.perf_counter()
        try:
            for obs in list(self._observers):
                obs.receive_message(msg.get_type(), msg)
        finally:
            # received accounting even when a handler raises — the bytes DID
            # arrive, and the latency of the failing handler is exactly the
            # kind of outlier the histogram exists to surface
            dt = time.perf_counter() - t0
            self._meter.on_received(msg.get_type(), _wire_bytes(msg), dt)
            if arrival_us is not None:
                attrs = {
                    "src": trace.get("src"),
                    "dst": msg.get_receiver_id(),
                    "seq": trace.get("seq"),
                    "send_ts_us": trace.get("ts"),
                    "msg_type": msg.get_type(),
                }
                if "r" in trace:
                    attrs["round"] = trace["r"]
                get_tracer().record_event(
                    "wire_recv", arrival_us, dt * 1e6, **attrs
                )

    def send_message(self, msg: Message, **kwargs) -> None:
        """Template method: delegate to the backend ``_send``, then account
        (messages/bytes sent + send-call latency) — a send that (finally)
        failed raises through and is NOT counted as sent.

        With a retry policy installed, a failed attempt is retried under
        jittered exponential backoff up to ``max_attempts``/``deadline_s``
        (core/retry.py); retries are at-least-once — safe because the sync
        server dedupes on (worker, round). Retry/give-up counts land in the
        comm meter."""
        self._stamp_trace(msg)
        policy = self.retry_policy
        if policy is None:
            t0 = time.perf_counter()
            self._send(msg, **kwargs)
            wire_s = time.perf_counter() - t0
        else:
            start = time.perf_counter()
            seq = next(self._send_seq)
            mt = msg.get_type()
            attempt = 0
            while True:
                try:
                    if policy.injects(seq, attempt):
                        raise InjectedSendFault(
                            f"chaos: injected transient send failure "
                            f"(msg_type={mt}, seq={seq}, attempt={attempt})"
                        )
                    t0 = time.perf_counter()
                    self._send(msg, **kwargs)
                    # the histogram records the SUCCESSFUL attempt's wire
                    # time only — backoff sleeps and failed attempts would
                    # otherwise drown real transport latency in the
                    # injected sleep schedule
                    wire_s = time.perf_counter() - t0
                    break
                # Exception, not BaseException: KeyboardInterrupt/
                # SystemExit must abort the send, not be retried N times
                # under backoff
                except Exception as e:  # noqa: BLE001 — transport boundary
                    if isinstance(e, RemoteRefusal):
                        # the remote end shed this attempt at its budget:
                        # metered apart from transport faults, then the
                        # backoff schedule owns the redial
                        self._meter.on_send_refused(mt)
                    attempt += 1
                    delay = policy.backoff_s(seq, attempt)
                    out_of_attempts = attempt >= policy.max_attempts
                    out_of_time = bool(policy.deadline_s) and (
                        time.perf_counter() - start + delay > policy.deadline_s
                    )
                    if out_of_attempts or out_of_time:
                        self._meter.on_send_gave_up(mt)
                        raise
                    self._meter.on_send_retry(mt)
                    time.sleep(delay)
        self._meter.on_sent(msg.get_type(), _wire_bytes(msg), wire_s)

    def send_message_nowait(self, msg: Message, **kwargs) -> None:
        """Single-attempt send (stamped + metered, NEVER retried): for
        shutdown/FINISH broadcasts, where a dead peer must cost at most one
        bounded timeout rather than the retry schedule's backoff × attempts
        per dead rank."""
        self._stamp_trace(msg)
        t0 = time.perf_counter()
        self._send(msg, **kwargs)
        self._meter.on_sent(msg.get_type(), _wire_bytes(msg), time.perf_counter() - t0)

    def _stamp_trace(self, msg: Message) -> None:
        """Stamp the compact ``_trace`` context onto the envelope (carried
        in the meta JSON by ``to_wire_parts`` — every transport gets it
        from this one wiring point). Keys: ``id`` federation trace id,
        ``src`` sender, ``seq`` per-manager send sequence, ``ts``
        epoch-anchored send timestamp (us, sender's clock), plus ``r``
        round and ``par`` enclosing span name when known. Retried sends
        restate the SAME dict (stamped once per send_message call), so a
        duplicate delivery is identifiable by (src, seq)."""
        try:
            tracer = get_tracer()
            trace: dict = {
                "id": self._trace_ctx.ensure(),
                "src": int(msg.get_sender_id()),
                "seq": next(self._trace_seq),
                "ts": round(tracer.now_us(), 1),
            }
            rnd = msg.get(MessageType.ARG_ROUND_IDX)
            if rnd is not None:
                trace["r"] = int(rnd)
            cur = tracer.current_span()
            if cur is not None:
                trace["par"] = cur.name
            msg.trace = trace
        except Exception:  # noqa: BLE001 — telemetry must never block a send
            pass

    @abc.abstractmethod
    def _send(self, msg: Message, **kwargs) -> None:
        """Backend send path (serialize + put on the wire)."""

    @abc.abstractmethod
    def handle_receive_message(self) -> None:
        """Enter the receive loop (blocks until stopped)."""

    @abc.abstractmethod
    def stop_receive_message(self) -> None: ...
