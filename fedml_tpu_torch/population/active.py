"""Bounded per-client bookkeeping (a copy of
``fedml_tpu/population/active.py``) — the O(cohort)-per-round structures
behind the scheduler's loss map and the telemetry health registry.

Both consumers share one failure mode at population scale: a dict keyed
by client id that only ever grows. At 10 clients it is invisible; at a
million clients × serve-layer tenants it is the memory bound. The fix is
the same shape in both places:

- a **bounded map** with insertion-order eviction for values that are
  only ever read opportunistically (power_of_choice's last-known
  losses: a missing entry means "cold client, rank +inf" — already the
  defined semantics, so eviction degrades to exploration, never error);
- a **bounded LRU active set + compact spill** for records that carry
  exact counters (health participation/fault tallies): the full-
  fidelity record (timing window, dedupe memory) lives only for the
  most recently seen clients, and eviction folds the exact counters
  into a ~3-slot aggregate that is restored seamlessly if the client
  reappears — totals stay exact, memory per client drops from KBs to
  ~100 bytes, and per-round work never scans beyond the active set.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple


class BoundedLossMap:
    """Insertion-ordered dict bounded at ``capacity`` entries: setting a
    key refreshes its position; past capacity the STALEST entry (least
    recently written) is dropped. Exactly the dict surface the selection
    policies read (``get``/``items``/iteration/len/contains), so it
    drops in for the scheduler's ``ctx.losses``."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError("BoundedLossMap capacity must be >= 1")
        self.capacity = int(capacity)
        self._d: Dict[int, float] = {}

    def __setitem__(self, key: int, value: float) -> None:
        k = int(key)
        if k in self._d:
            del self._d[k]  # re-insert at the fresh end
        self._d[k] = float(value)
        while len(self._d) > self.capacity:
            self._d.pop(next(iter(self._d)))

    def get(self, key: int, default=None):
        return self._d.get(int(key), default)

    def __contains__(self, key: int) -> bool:
        return int(key) in self._d

    def __len__(self) -> int:
        return len(self._d)

    def __iter__(self) -> Iterator[int]:
        return iter(self._d)

    def __bool__(self) -> bool:
        return bool(self._d)

    def items(self):
        return self._d.items()

    def keys(self):
        return self._d.keys()

    def values(self):
        return self._d.values()

    def clear(self) -> None:
        self._d.clear()


class SpilledRecord:
    """Compact aggregate of an evicted full-fidelity client record —
    exactly the counters that must stay EXACT across eviction (sliding-
    window timing stats are definitionally lossy and are dropped)."""

    __slots__ = ("last_seen_round", "rounds_participated", "faults")

    def __init__(
        self,
        last_seen_round: int = -1,
        rounds_participated: int = 0,
        faults: Optional[Dict[str, int]] = None,
    ):
        self.last_seen_round = int(last_seen_round)
        self.rounds_participated = int(rounds_participated)
        self.faults = dict(faults) if faults else {}


class ActiveSet:
    """LRU-bounded map of full-fidelity records with compact spill.

    ``touch(cid, factory)`` returns the live record, creating it (seeded
    from any spilled aggregate via ``factory(spilled_or_None)``) and
    evicting the least-recently-touched record past ``capacity``;
    eviction calls ``spill_fn(record) -> SpilledRecord`` and files the
    aggregate. Iteration/len cover the ACTIVE set only — per-round scans
    (straggler quantiles) are bounded by construction; full-history
    queries merge :attr:`spilled` explicitly."""

    def __init__(self, capacity: int, spill_fn):
        if capacity < 1:
            raise ValueError("ActiveSet capacity must be >= 1")
        self.capacity = int(capacity)
        self._spill_fn = spill_fn
        self._live: Dict[int, object] = {}
        self.spilled: Dict[int, SpilledRecord] = {}

    def get(self, cid: int):
        """Live record or None — does NOT refresh recency."""
        return self._live.get(int(cid))

    def touch(self, cid: int, factory):
        cid = int(cid)
        rec = self._live.get(cid)
        if rec is not None:
            del self._live[cid]  # refresh: re-insert at the fresh end
            self._live[cid] = rec
            return rec
        rec = factory(self.spilled.pop(cid, None))
        self._live[cid] = rec
        while len(self._live) > self.capacity:
            old_cid = next(iter(self._live))
            old = self._live.pop(old_cid)
            self.spilled[old_cid] = self._spill_fn(old)
        return rec

    def __len__(self) -> int:
        return len(self._live)

    def __contains__(self, cid: int) -> bool:
        return int(cid) in self._live

    def items(self) -> Iterator[Tuple[int, object]]:
        return iter(list(self._live.items()))

    def known_ids(self):
        """Every client id with live OR spilled history (query-time
        only — O(participants), never on the round path)."""
        return set(self._live) | set(self.spilled)
