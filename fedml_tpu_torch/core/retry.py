"""Transport send retry — seed-deterministic jittered exponential backoff
(a copy of ``fedml_tpu/core/retry.py``).

The mechanism lives once in the ``BaseCommManager.send_message`` template
(core/comm.py), so every transport backend gets retries for free; this
module is the policy. Retries are at-least-once: an attempt that timed out
after the receiver got the bytes re-delivers on the next attempt, which the
sync server absorbs (it dedupes on the worker slot and the round tag).

Everything is deterministic in ``(seed, send seq, attempt)``: the jitter
and the chaos-injection coin flips replay identically run over run. Chaos
injection (``send_fault_p``) fails an attempt BEFORE the backend ``_send``
runs — the eventual successful attempt delivers exactly once, so a chaos
run's numerics are identical to a fault-free run.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional


class InjectedSendFault(ConnectionError):
    """A chaos-injected transient transport failure (``send_fault_p``)."""


class RemoteRefusal(ConnectionError):
    """The remote end shed this attempt at a connection or stream budget
    (gRPC RESOURCE_EXHAUSTED from the receive-queue budget, MQTT CONNACK
    0x03 from the broker's connection cap): deliberate backpressure, not a
    dead peer. Transports raise this subclass so the send template
    (core/comm.py) can meter refusals apart from transport faults; the
    attempt still re-enters the normal backoff and retry schedule, which
    is the redial the shedding end wants."""


def _mix(*parts: int) -> int:
    """Order-sensitive integer mix — a stable stream key (int hashing is
    deterministic across processes, unlike str hashing)."""
    h = 0x345678
    for p in parts:
        h = (h * 1_000_003 + int(p)) & 0x7FFFFFFFFFFFFFFF
    return h


def jittered_backoff_s(
    base_s: float, max_s: float, attempt: int, key: int
) -> float:
    """THE backoff formula — ``base * 2^(attempt-1)`` scaled by a
    deterministic jitter in [0.5, 1.5) drawn from ``key``, capped at
    ``max_s``."""
    raw = base_s * (2.0 ** (max(int(attempt), 1) - 1))
    rng = random.Random(key)
    return min(max_s, raw * (0.5 + rng.random()))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Send-retry knobs (CommConfig.send_* + the run seed).

    ``max_attempts`` counts the first try: 1 = no retries (but chaos
    injection still applies). ``deadline_s`` caps the TOTAL time one
    logical send may spend across attempts and backoff sleeps — when the
    next backoff would cross it, the send gives up early."""

    max_attempts: int = 1
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    deadline_s: float = 0.0
    seed: int = 0
    fault_p: float = 0.0

    @classmethod
    def from_config(cls, comm_cfg, seed: int = 0) -> Optional["RetryPolicy"]:
        """Build from a CommConfig; None when retries AND chaos are both
        off (the byte-compatible legacy send path)."""
        retries = int(getattr(comm_cfg, "send_retries", 0) or 0)
        fault_p = float(getattr(comm_cfg, "send_fault_p", 0.0) or 0.0)
        if retries <= 0 and fault_p <= 0.0:
            return None
        return cls(
            max_attempts=retries + 1,
            backoff_base_s=float(getattr(comm_cfg, "send_backoff_s", 0.05)),
            backoff_max_s=float(getattr(comm_cfg, "send_backoff_max_s", 2.0)),
            deadline_s=float(getattr(comm_cfg, "send_retry_deadline_s", 0.0)),
            seed=int(seed),
            fault_p=fault_p,
        )

    def backoff_s(self, seq: int, attempt: int) -> float:
        """Jittered exponential backoff before retry ``attempt`` (1-based)
        of send ``seq`` — pure in (seed, seq, attempt)."""
        return jittered_backoff_s(
            self.backoff_base_s, self.backoff_max_s, attempt,
            _mix(self.seed, seq, attempt, 0xB0FF),
        )

    def injects(self, seq: int, attempt: int) -> bool:
        """Chaos coin flip for (send seq, attempt) — pure in (seed, seq,
        attempt), so the same run injects the same transient failures."""
        if self.fault_p <= 0.0:
            return False
        rng = random.Random(_mix(self.seed, seq, attempt, 0xFA17))
        return rng.random() < self.fault_p
