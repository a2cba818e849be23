"""gRPC cross-host transport (a copy of ``fedml_tpu/core/grpc_comm.py``).

Every participant runs a gRPC server on ``base_port + rank``; a send dials
``ip_config[receiver]``. Messages are the binary Message wire format (the
same FTM1 bytes as on loopback) through a generic bytes-in/bytes-out unary
method, ``/fedml_tpu.Comm/SendMessage`` (the reference's method name, so a
port peer and a reference peer talk to each other); the receive path
notifies observers from a single drain thread. ``grpc`` (grpcio) is
imported inside the functions that use it, so this module imports without
it.

The 1 GB max-message options mirror the reference's; ``ip_config`` is a
rank → IP table. The encode and decode of each message are recorded as
``to_bytes`` / ``from_bytes`` spans on the process tracer, as on the
loopback hub."""

from __future__ import annotations

import queue
from concurrent import futures
from typing import Dict, Optional

from fedml_tpu_torch.core.comm import BaseCommManager
from fedml_tpu_torch.core.message import Message
from fedml_tpu_torch.telemetry.spans import get_tracer
from fedml_tpu_torch.core.retry import RemoteRefusal

_METHOD = "/fedml_tpu.Comm/SendMessage"
_STOP = object()

# Executor sizing bounds for the auto path (grpc_max_workers=0): enough
# threads that a wave of concurrent uploads doesn't serialize behind the
# enqueue handler, capped so a 1000-client fleet cannot ask one process
# for 1000 OS threads — the handler only does Queue.put, so threads above
# the cap buy nothing but stack memory.
_AUTO_WORKERS_MIN = 8
_AUTO_WORKERS_CAP = 64


def _grpc_options(max_message_mb: int = 1000, keepalive_s: float = 0.0):
    """Channel/server options (ref grpc_comm_manager.py:35-39) — message
    caps + keepalive now come from CommConfig instead of module constants."""
    opts = [
        ("grpc.max_send_message_length", int(max_message_mb) * 1024 * 1024),
        ("grpc.max_receive_message_length", int(max_message_mb) * 1024 * 1024),
        ("grpc.enable_http_proxy", 0),
    ]
    if keepalive_s and keepalive_s > 0:
        ka_ms = int(float(keepalive_s) * 1000)
        opts += [
            ("grpc.keepalive_time_ms", ka_ms),
            ("grpc.keepalive_timeout_ms", max(1000, ka_ms // 2)),
            ("grpc.keepalive_permit_without_calls", 1),
            ("grpc.http2.max_pings_without_data", 0),
        ]
    return opts


def executor_workers_for(max_workers: int, expected_peers: int) -> int:
    """Resolve the server executor size: explicit ``grpc_max_workers`` wins;
    0 = auto-size from the expected cohort (~1 thread per 8 peers, floored
    at 8, capped at 64 — see _AUTO_WORKERS_*)."""
    if max_workers and max_workers > 0:
        return int(max_workers)
    peers = max(int(expected_peers), 1)
    return min(_AUTO_WORKERS_CAP, max(_AUTO_WORKERS_MIN, (peers + 7) // 8))



def read_ip_config(path: str) -> Dict[int, str]:
    """CSV 'receiver_id,ip' table (ref grpc_ipconfig.csv + _build_ip_table)."""
    table: Dict[int, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("receiver_id"):
                continue
            rid, ip = line.split(",")[:2]
            table[int(rid)] = ip.strip()
    return table


class GrpcCommManager(BaseCommManager):
    def __init__(
        self,
        rank: int,
        ip_config: Dict[int, str],
        base_port: int = 8890,
        bind_host: str = "0.0.0.0",
        send_timeout_s: float = 30.0,
        handshake_timeout_s: float = 120.0,
        max_workers: int = 0,
        stream_budget: int = 0,
        max_message_mb: int = 1000,
        keepalive_s: float = 0.0,
        expected_peers: Optional[int] = None,
    ):
        import grpc

        super().__init__()
        self.rank = rank
        self.ip_config = ip_config
        self.base_port = base_port
        # per-send RPC deadline (was a hard-coded 30.0 in _send; now
        # CommConfig.send_timeout_s via the CLI's --send_timeout_s) and the
        # one-time first-contact allowance the no-retry path still uses
        self.send_timeout_s = float(send_timeout_s)
        self.handshake_timeout_s = float(handshake_timeout_s)
        self._q: "queue.Queue" = queue.Queue()
        self._channels: Dict[int, object] = {}
        self._handshaken: set = set()
        # retry-path bookkeeping: peers we already spent the one
        # wait-for-bind window on (see _send) — later attempts fail fast
        self._hs_waited: set = set()
        self._grpc = grpc
        self._options = _grpc_options(max_message_mb, keepalive_s)
        # Inbound stream budget: while more than this many messages sit
        # undrained in the receive queue, new RPCs are shed with
        # RESOURCE_EXHAUSTED instead of piling onto an unbounded queue.
        # The sender's retry layer owns the redial (RemoteRefusal below),
        # so shedding is backpressure, not message loss. 0 = off.
        self.stream_budget = int(stream_budget)
        # Executor size: from config, or from the expected cohort.
        self.executor_workers = executor_workers_for(
            max_workers,
            expected_peers if expected_peers is not None else len(ip_config),
        )

        def handle(request: bytes, context) -> bytes:
            if self.stream_budget > 0 and self._q.qsize() >= self.stream_budget:
                self._meter.on_refused("grpc_stream")
                context.abort(
                    grpc.StatusCode.RESOURCE_EXHAUSTED,
                    f"receive queue over stream budget "
                    f"({self.stream_budget}); redial under backoff",
                )
            self._q.put(request)
            return b"ok"

        handler = grpc.method_handlers_generic_handler(
            "fedml_tpu.Comm",
            {
                "SendMessage": grpc.unary_unary_rpc_method_handler(
                    handle,
                    request_deserializer=None,
                    response_serializer=None,
                )
            },
        )
        self._server = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=self.executor_workers,
                thread_name_prefix=f"grpc-comm-{rank}",
            ),
            options=self._options,
        )
        self._server.add_generic_rpc_handlers((handler,))
        self.port = base_port + rank
        bound = self._server.add_insecure_port(f"{bind_host}:{self.port}")
        if bound == 0:  # grpc signals bind failure by returning port 0
            raise RuntimeError(
                f"failed to bind gRPC server to {bind_host}:{self.port} "
                "(port in use?)"
            )
        self._server.start()

    def _stub(self, receiver: int):
        if receiver not in self._channels:
            target = f"{self.ip_config[receiver]}:{self.base_port + receiver}"
            self._channels[receiver] = self._grpc.insecure_channel(
                target, options=self._options
            )
        ch = self._channels[receiver]
        return ch.unary_unary(
            _METHOD, request_serializer=None, response_deserializer=None
        )

    def _send(self, msg: Message, timeout: Optional[float] = None) -> None:
        receiver = msg.get_receiver_id()
        with get_tracer().span("to_bytes", msg_type=msg.get_type()):
            data = msg.to_bytes()
        if self.retry_policy is not None:
            # The retry layer (core/retry.py, via the send_message
            # template) owns reconnects: every attempt is bounded by
            # send_timeout_s and failures are retried under backoff. A
            # peer that has never answered gets exactly ONE
            # wait_for_ready=True window (capped at send_timeout_s) so the
            # multi-process startup race waits for the peer's server to
            # BIND instead of burning the retry budget on instant
            # connection-refused errors — but only one: at fleet scale a
            # JOIN reply can target a client that died in the queue, and
            # waiting a full window on EVERY retry (attempts ×
            # send_timeout_s, minutes) starves the server's single drain
            # thread and parks the whole fleet. After the one window (or
            # after first contact) a dead peer fails fast and the backoff
            # schedule owns the redials.
            first = (
                receiver not in self._handshaken
                and receiver not in self._hs_waited
            )
            if first:
                self._hs_waited.add(receiver)
            try:
                self._stub(receiver)(
                    data,
                    wait_for_ready=first,
                    timeout=(
                        timeout if timeout is not None else self.send_timeout_s
                    ),
                )
            except self._grpc.RpcError as e:
                if e.code() == self._grpc.StatusCode.RESOURCE_EXHAUSTED:
                    # the receiver SHED us at its stream budget — reclassify
                    # so the send template meters a refusal (not a fault)
                    # and the backoff schedule redials
                    raise RemoteRefusal(str(e.details())) from e
                raise
            self._handshaken.add(receiver)  # on SUCCESS only (vs legacy)
            return
        # Legacy single-attempt path: wait_for_ready on the FIRST send per
        # peer only — multi-process federation has no startup-order
        # guarantee (ref run_*.sh scripts just background processes), so
        # the handshake send blocks until the peer's server is up. After
        # that a dead peer must fail FAST — _complete_round broadcasts
        # while holding the round lock, and a 10-minute stall there would
        # freeze every live client too.
        first = receiver not in self._handshaken
        try:
            self._stub(receiver)(
                data,
                wait_for_ready=first,
                timeout=self.handshake_timeout_s if first else (
                    timeout if timeout is not None else self.send_timeout_s
                ),
            )
        finally:
            # handshake is attempted-once, not succeeded-once: a peer that
            # died before its server came up must fail FAST on later sends
            # (retrying the long wait_for_ready every round would stall
            # the whole federation on one dead process)
            self._handshaken.add(receiver)

    def handle_receive_message(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                break
            with get_tracer().span("from_bytes", rank=self.rank):
                msg = Message.from_bytes(item)
            self.notify(msg)

    def stop_receive_message(self) -> None:
        self._q.put(_STOP)
        self._server.stop(grace=0.5)
        for ch in self._channels.values():
            ch.close()
