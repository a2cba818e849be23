"""Minimal MQTT 3.1.1 broker and client over real TCP sockets (a copy of
``fedml_tpu/core/mqtt_broker.py``; stdlib only).

The QoS-0 subset of MQTT 3.1.1 (CONNECT/CONNACK, SUBSCRIBE/SUBACK, PUBLISH,
PINGREQ/PINGRESP, DISCONNECT), so the MQTT backend (core/mqtt_comm.py) runs
over an actual TCP socket where ``paho`` is not installed. The broker speaks
standard MQTT, so a paho client, the reference's client and this one
interoperate.

Wire format (MQTT 3.1.1 spec §2): fixed header = packet-type byte +
variable-length remaining-length varint; strings are big-endian
length-prefixed UTF-8. Remaining length caps at 256 MB — model-weight
payloads ride well under it.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, Dict, Set

# packet types (spec §2.2.1)
CONNECT, CONNACK, PUBLISH, SUBSCRIBE, SUBACK = 1, 2, 3, 8, 9
UNSUBSCRIBE, UNSUBACK, PINGREQ, PINGRESP, DISCONNECT = 10, 11, 12, 13, 14


def _encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        d = n % 128
        n //= 128
        out.append(d | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed")
        buf.extend(chunk)
    return bytes(buf)


def _read_packet(sock: socket.socket):
    """-> (type, flags, body bytes)."""
    h = _read_exact(sock, 1)[0]
    mult, length = 1, 0
    for _ in range(4):
        d = _read_exact(sock, 1)[0]
        length += (d & 0x7F) * mult
        if not d & 0x80:
            break
        mult *= 128
    else:
        raise ValueError("malformed remaining length")
    return h >> 4, h & 0x0F, _read_exact(sock, length) if length else b""


def _packet(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + _encode_varint(len(body)) + body


def _mqtt_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">H", len(b)) + b


def _read_mqtt_str(body: bytes, off: int):
    (n,) = struct.unpack_from(">H", body, off)
    off += 2
    return body[off:off + n].decode("utf-8"), off + n


class MiniMqttBroker:
    """Threaded QoS-0 broker: one reader thread per connection, exact-topic
    routing, per-connection write lock (PUBLISH fan-out and PINGRESP can
    race on the same socket).

    ``max_connections`` bounds reader-thread growth for fleet scale: past
    the cap a dialer gets a clean CONNACK return code 0x03 ("server
    unavailable", spec §3.2.2.3) and the socket closes — MiniMqttClient
    raises :class:`~fedml_tpu_torch.core.retry.RemoteRefusal` on that code, so
    a capped client redials under the retry layer's backoff instead of
    holding a reader thread. 0 = unbounded (legacy behavior). Refusals
    are counted on ``self.refused`` and metered on the comm meter
    (``refused["mqtt_conn"]``)."""

    def __init__(
        self, host: str = "127.0.0.1", port: int = 0,
        max_connections: int = 0,
    ):
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self.max_connections = int(max_connections)
        self.refused = 0
        self._live = 0
        self._subs: Dict[str, Set[socket.socket]] = {}
        self._locks: Dict[socket.socket, threading.Lock] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._accept_thread = threading.Thread(target=self._accept, daemon=True)
        self._accept_thread.start()

    def _accept(self):
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            if self.max_connections > 0:
                with self._lock:
                    at_cap = self._live >= self.max_connections
                    if not at_cap:
                        self._live += 1
                if at_cap:
                    self.refused += 1
                    try:
                        from fedml_tpu_torch.telemetry.comm import get_comm_meter

                        get_comm_meter().on_refused("mqtt_conn")
                    except Exception:  # noqa: BLE001 — metering best-effort
                        pass
                    # refusal must not block the accept loop: a short-lived
                    # thread reads the CONNECT (bounded) and answers
                    # CONNACK 0x03 so the client sees a deliberate refusal,
                    # not a hung dial
                    threading.Thread(
                        target=self._refuse, args=(conn,), daemon=True
                    ).start()
                    continue
            else:
                with self._lock:
                    self._live += 1
            self._locks[conn] = threading.Lock()
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    def _refuse(self, conn):
        try:
            conn.settimeout(5.0)
            ptype, _, _ = _read_packet(conn)
            if ptype == CONNECT:
                # CONNACK: session-present 0, return code 3 = server
                # unavailable (spec §3.2.2.3)
                conn.sendall(_packet(CONNACK, 0, b"\x00\x03"))
        except (ConnectionError, ValueError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _send(self, conn, data: bytes):
        lock = self._locks.get(conn)
        if lock is None:
            return
        try:
            with lock:
                conn.sendall(data)
        except OSError:
            self._drop(conn)

    def _drop(self, conn):
        with self._lock:
            for subs in self._subs.values():
                subs.discard(conn)
            # _drop can race from _send and _serve for the same socket:
            # the lock-table pop is the idempotency token, so the live
            # count (what the connection cap admits against) decrements
            # exactly once per admitted connection
            if self._locks.pop(conn, None) is not None:
                self._live -= 1
        try:
            conn.close()
        except OSError:
            pass

    def _serve(self, conn):
        try:
            ptype, _, _ = _read_packet(conn)
            if ptype != CONNECT:
                return
            # CONNACK: session-present 0, return code 0
            self._send(conn, _packet(CONNACK, 0, b"\x00\x00"))
            while True:
                ptype, flags, body = _read_packet(conn)
                if ptype == SUBSCRIBE:
                    pid = body[:2]
                    off, codes = 2, bytearray()
                    while off < len(body):
                        topic, off = _read_mqtt_str(body, off)
                        off += 1  # requested qos
                        with self._lock:
                            self._subs.setdefault(topic, set()).add(conn)
                        codes.append(0)  # granted QoS 0
                    self._send(conn, _packet(SUBACK, 0, pid + bytes(codes)))
                elif ptype == UNSUBSCRIBE:
                    pid = body[:2]
                    off = 2
                    while off < len(body):
                        topic, off = _read_mqtt_str(body, off)
                        with self._lock:
                            self._subs.get(topic, set()).discard(conn)
                    self._send(conn, _packet(UNSUBACK, 0, pid))
                elif ptype == PUBLISH:
                    topic, off = _read_mqtt_str(body, 0)
                    payload = body[off:]  # QoS 0: no packet id
                    with self._lock:
                        targets = list(self._subs.get(topic, ()))
                    pkt = _packet(PUBLISH, 0, _mqtt_str(topic) + payload)
                    for t in targets:
                        self._send(t, pkt)
                elif ptype == PINGREQ:
                    self._send(conn, _packet(PINGRESP, 0, b""))
                elif ptype == DISCONNECT:
                    return
        except (ConnectionError, ValueError, OSError):
            pass
        finally:
            self._drop(conn)

    def close(self):
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass


class MiniMqttClient:
    """QoS-0 client with the paho surface MqttCommManager uses:
    subscribe/publish/close + an on_message callback from a reader
    thread."""

    def __init__(
        self,
        host: str,
        port: int,
        client_id: str,
        on_message: Callable[[str, bytes], None],
        keepalive: int = 0,
    ):
        self._sock = socket.create_connection((host, port), timeout=10)
        self._on_message = on_message
        self._wlock = threading.Lock()
        self._pid = 0
        body = (
            _mqtt_str("MQTT")
            + bytes([4])          # protocol level 3.1.1
            + bytes([0x02])       # clean session
            # keepalive 0 = disabled (spec 3.1.2.10): this client runs no
            # PINGREQ loop, and advertising a nonzero value would make a
            # spec-compliant broker drop it after 1.5x the interval idle
            + struct.pack(">H", keepalive)
            + _mqtt_str(client_id)
        )
        self._sock.sendall(_packet(CONNECT, 0, body))
        ptype, _, ack = _read_packet(self._sock)
        if ptype != CONNACK or ack[1] != 0:
            self._sock.close()
            if ptype == CONNACK and len(ack) >= 2 and ack[1] == 3:
                # return code 3 = server unavailable: the broker's
                # connection cap shed us deliberately — raise the refusal
                # subclass so callers redial under backoff
                from fedml_tpu_torch.core.retry import RemoteRefusal

                raise RemoteRefusal(
                    "MQTT connect refused at broker connection cap "
                    f"(CONNACK rc=3): {ack!r}"
                )
            raise ConnectionError(f"MQTT connect refused: {ack!r}")
        self._sock.settimeout(None)
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _read_loop(self):
        try:
            while True:
                ptype, flags, body = _read_packet(self._sock)
                if ptype == PUBLISH:
                    topic, off = _read_mqtt_str(body, 0)
                    self._on_message(topic, body[off:])
                # SUBACK/PINGRESP need no action at QoS 0
        except (ConnectionError, OSError, ValueError):
            pass

    def _next_pid(self) -> bytes:
        self._pid = (self._pid % 0xFFFF) + 1
        return struct.pack(">H", self._pid)

    def subscribe(self, topic: str, qos: int = 0):
        body = self._next_pid() + _mqtt_str(topic) + bytes([qos])
        with self._wlock:
            self._sock.sendall(_packet(SUBSCRIBE, 0x02, body))

    def publish(self, topic: str, payload: bytes, qos: int = 0):
        with self._wlock:
            self._sock.sendall(
                _packet(PUBLISH, 0, _mqtt_str(topic) + bytes(payload))
            )

    def close(self):
        try:
            with self._wlock:
                self._sock.sendall(_packet(DISCONNECT, 0, b""))
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
