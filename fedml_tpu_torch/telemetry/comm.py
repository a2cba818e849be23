"""Comm-layer traffic accounting (port of ``fedml_tpu/telemetry/comm.py``).

Wired ONCE into the ``BaseCommManager`` send/notify template (core/comm.py),
so every transport backend gets per-message-type counters for free:
messages and serialized wire bytes sent and received, send retries and
give-ups, connections and streams shed at a budget (``refused``, by kind, on
the end that sheds; ``send_refused``, by message type, on the sender), and
the model payload bytes of each upload and broadcast as
shipped against their float32-equivalent size (``comm/uplink_*`` and
``comm/downlink_*``). The reference also feeds these observations into a
Prometheus registry; the port keeps the plain totals only (``snapshot``),
which is what the transport and its tests read."""

from __future__ import annotations

import threading
from typing import Dict, Optional

_TRAFFIC = ("messages_sent", "messages_received", "bytes_sent", "bytes_received",
            "send_retries", "send_gave_up")
_TOTALS = ("uplink_payload_bytes", "uplink_raw_bytes", "uplink_updates",
           "downlink_payload_bytes", "downlink_raw_bytes", "downlink_updates",
           "beacons", "beacon_bytes")
_REFUSALS = ("refused", "send_refused")
_PER_TYPE = _TRAFFIC + _REFUSALS


class CommMeter:
    """Per-message-type traffic counters, safe across threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def _add(self, counter: str, msg_type: str, n: int = 1) -> None:
        with self._lock:
            d = self._per_type[counter]
            d[msg_type] = d.get(msg_type, 0) + int(n)

    # -- hot path (called from BaseCommManager) --
    def on_sent(self, msg_type: str, nbytes: Optional[int], seconds: float) -> None:
        self._add("messages_sent", msg_type)
        if nbytes:
            self._add("bytes_sent", msg_type, nbytes)

    def on_received(self, msg_type: str, nbytes: Optional[int], seconds: float) -> None:
        self._add("messages_received", msg_type)
        if nbytes:
            self._add("bytes_received", msg_type, nbytes)

    def on_send_retry(self, msg_type: str) -> None:
        self._add("send_retries", msg_type)

    def on_send_gave_up(self, msg_type: str) -> None:
        self._add("send_gave_up", msg_type)

    def on_refused(self, kind: str) -> None:
        """One inbound connection or stream shed at a server-side budget
        (``grpc_stream`` queue budget, ``mqtt_conn`` connection cap),
        metered where the refusal is decided."""
        self._add("refused", kind)

    def on_send_refused(self, msg_type: str) -> None:
        """One send attempt the remote end refused at its budget (the
        sender's mirror of :meth:`on_refused`)."""
        self._add("send_refused", msg_type)

    def _add_totals(self, prefix: str, payload_bytes: int, raw_bytes: int) -> None:
        with self._lock:
            self._totals[f"{prefix}_payload_bytes"] += int(payload_bytes)
            self._totals[f"{prefix}_raw_bytes"] += int(raw_bytes)
            self._totals[f"{prefix}_updates"] += 1

    def on_uplink(self, payload_bytes: int, raw_bytes: int) -> None:
        """One client model-update upload: its as-shipped payload bytes and
        the float32-equivalent bytes of the same update uncompressed."""
        self._add_totals("uplink", payload_bytes, raw_bytes)

    def on_downlink(self, payload_bytes: int, raw_bytes: int) -> None:
        """One server model broadcast to one worker: as-shipped payload
        bytes against float32-equivalent bytes."""
        self._add_totals("downlink", payload_bytes, raw_bytes)

    def on_beacon(self, nbytes: int) -> None:
        """One client telemetry beacon attached to an upload."""
        with self._lock:
            self._totals["beacons"] += 1
            self._totals["beacon_bytes"] += int(nbytes)

    # -- queries --
    def snapshot(self) -> dict:
        """Plain-dict totals, keyed as the reference's ``snapshot``:
        ``{counter: {msg_type: value}}`` and the payload totals."""
        with self._lock:
            out = {k: dict(self._per_type[k]) for k in _TRAFFIC}
            out.update(self._totals)
            out.update({k: dict(self._per_type[k]) for k in _REFUSALS})
            return out

    def reset(self) -> None:
        with self._lock:
            self._per_type: Dict[str, Dict[str, int]] = {k: {} for k in _PER_TYPE}
            self._totals: Dict[str, int] = {k: 0 for k in _TOTALS}


_GLOBAL = CommMeter()


def get_comm_meter() -> CommMeter:
    """The process-wide meter every comm manager reports into."""
    return _GLOBAL
