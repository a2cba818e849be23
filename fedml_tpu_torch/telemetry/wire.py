"""Wire telemetry (port of part of ``fedml_tpu/telemetry/wire.py``).

- :class:`TraceContext`: the federation trace id a comm manager stamps into
  the ``_trace`` meta key of every envelope it sends (core/comm.py), minted
  by the first sender and adopted from the first ``_trace``-carrying
  receive, so the whole fleet converges on the server's id.
- :func:`build_beacon`: the bounded (~200 B) client telemetry summary
  piggybacked on every model upload as ``MessageType.ARG_TELEMETRY`` — the
  same schema as the reference's, so a port client's uploads carry the
  keys a ``fedml_tpu`` server reads.

The fleet aggregation and the offline trace merge are not ported."""

from __future__ import annotations

import json
import threading
import uuid
from typing import Any, Dict, Optional

# the beacon's byte budget: build_beacon drops optional fields to stay under
BEACON_MAX_BYTES = 256


class TraceContext:
    """The federation trace id for one comm manager."""

    __slots__ = ("_lock", "_id")

    def __init__(self):
        self._lock = threading.Lock()
        self._id: Optional[str] = None

    def ensure(self) -> str:
        """The trace id, minting one if this manager has none yet."""
        with self._lock:
            if self._id is None:
                self._id = uuid.uuid4().hex[:12]
            return self._id

    def adopt(self, trace_id: Optional[str]) -> None:
        """Adopt a peer's id — first writer wins."""
        if not trace_id:
            return
        with self._lock:
            if self._id is None:
                self._id = str(trace_id)


def _rss_mb() -> Optional[float]:
    """Resident set size in MB, best effort (Linux /proc, else rusage)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024.0, 1)
    except Exception:  # noqa: BLE001 — not Linux / procfs unavailable
        pass
    try:
        import resource

        return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1)
    except Exception:  # noqa: BLE001 — telemetry never raises
        return None


def beacon_nbytes(beacon: dict) -> int:
    """The beacon's compact-JSON wire footprint (what ``on_beacon`` meters)."""
    return len(json.dumps(beacon, separators=(",", ":")).encode("utf-8"))


def build_beacon(
    *,
    train_s: float,
    encode_s: float = 0.0,
    retries: int = 0,
    codec: Optional[str] = None,
    tier: Optional[str] = None,
    rss_mb: Optional[float] = None,
    sample_rss: bool = True,
) -> dict:
    """A bounded client telemetry summary (schema v1). Optional fields are
    dropped — in fixed priority order — until the compact JSON fits
    ``BEACON_MAX_BYTES``; never raises, never exceeds the budget."""
    beacon: Dict[str, Any] = {
        "v": 1,
        "train_s": round(float(train_s), 4),
        "encode_s": round(float(encode_s), 4),
    }
    if retries:
        beacon["retries"] = int(retries)
    if codec and codec != "none":
        beacon["codec"] = str(codec)[:16]
    if tier:
        beacon["tier"] = str(tier)[:24]
    if rss_mb is None and sample_rss:
        rss_mb = _rss_mb()
    if rss_mb:
        beacon["rss_mb"] = round(float(rss_mb), 1)
    for key in ("rss_mb", "codec", "retries", "tier"):
        if beacon_nbytes(beacon) <= BEACON_MAX_BYTES:
            break
        beacon.pop(key, None)
    return beacon
