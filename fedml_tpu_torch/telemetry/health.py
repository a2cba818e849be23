"""Server-side client health registry (port of
``fedml_tpu/telemetry/health.py``) — per-client participation and
local-train wall-time statistics, with a straggler flag.

The registry answers the operational questions the reference never could
(it has no straggler mitigation): which clients has the server heard
from, how slow is each one lately, and who sits in the slowest decile.
It is fed two ways:

- **span stream** (in-process runtimes): ``attach(tracer)`` subscribes to
  finished ``local_train`` spans (``client=``/``round=`` attrs) — the
  loopback/shm federations record true on-client train wall time.
- **explicit observations** (cross-process runtimes): the server manager
  calls ``observe_train(cid, round, wall_s)`` with its broadcast→upload
  round-trip, the only timing a gRPC server can see.

Both paths dedupe on (client, round): when the span stream already
recorded a round, the transport-side round-trip observation is ignored
(the span is the truer number — it excludes transit).

Straggler flag: a client is a straggler when its sliding-window mean train
time sits in the slowest decile across clients (>= 0.9 quantile of means)
AND is materially slower than the fleet (> 1.2 × the median mean) — so a
homogeneous fleet has no stragglers. This is the hook FedBuff needs for
staleness-aware scheduling (a straggler's next assignment can be
discounted up front).

Population bounds (``population/active.py``): a
million-client × serve-tenants deployment cannot carry a dict of
per-client deques, so full-fidelity records (timing window + dedupe
memory, ~KBs each) live in an LRU **active set** of at most
``max_active_clients`` recently-seen clients; eviction folds the exact
counters (participation, last-seen, fault tallies) into a ~100-byte
compact spill record that is restored seamlessly if the client
reappears — totals stay exact, timing windows (definitionally lossy
sliding stats) restart. The straggler scan is bounded by the active set.
The full-fidelity fault-event log behind :meth:`export_trace` is
registry-wide and append-only under a **byte budget**
(``trace_budget_bytes``): past it, fault TALLIES stay exact but events
stop recording and every affected client is loudly marked
``trace_incomplete`` — ``FaultPlan.from_trace`` keeps refusing such
clients rather than replaying a partial fleet.

Prometheus exposure stays aggregate on purpose (client cardinality can be
millions): clients-seen gauge, straggler-count gauge, and one train-time
histogram across all clients."""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

from fedml_tpu_torch.population import ActiveSet, SpilledRecord
from fedml_tpu_torch.telemetry.metrics import MetricsRegistry, get_registry
from fedml_tpu_torch.telemetry.spans import SpanEvent, Tracer

_TRAIN_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0, 300.0, 1800.0,
)

# Estimated footprint of one fault-log event (cid, round, kind, detail)
# against the registry-wide trace budget — a small tuple of scalars; the
# estimate errs high so the budget binds before RSS does.
_EVENT_BYTES = 96


class _ClientRecord:
    __slots__ = (
        "last_seen_round",
        "rounds_participated",
        "times",
        "seen_rounds",
        "faults",
        "tier",
    )

    def __init__(self, window: int, spilled: Optional[SpilledRecord] = None):
        # a client returning from the compact spill resumes its EXACT
        # counters; the timing window restarts (sliding stats are lossy
        # by definition — that is why they spill to nothing)
        self.last_seen_round = spilled.last_seen_round if spilled else -1
        self.rounds_participated = (
            spilled.rounds_participated if spilled else 0
        )
        self.faults: Dict[str, int] = dict(spilled.faults) if spilled else {}
        self.times: deque = deque(maxlen=window)
        # bounded dedupe memory: only the most recent window of round ids
        self.seen_rounds: deque = deque(maxlen=window)
        # DeviceProfile tier from telemetry beacons (telemetry/wire.py);
        # None until a beacon names one. Not spilled — attribution, not
        # an exact counter.
        self.tier: Optional[str] = None

    def mean(self) -> Optional[float]:
        if not self.times:
            return None
        return sum(self.times) / len(self.times)

    def percentile(self, q: float) -> Optional[float]:
        if not self.times:
            return None
        xs = sorted(self.times)
        idx = min(int(q * len(xs)), len(xs) - 1)
        return xs[idx]


def _spill(rec: _ClientRecord) -> SpilledRecord:
    return SpilledRecord(
        last_seen_round=rec.last_seen_round,
        rounds_participated=rec.rounds_participated,
        faults=rec.faults,
    )


class ClientHealthRegistry:
    def __init__(
        self,
        window: int = 64,
        straggler_quantile: float = 0.9,
        straggler_margin: float = 1.2,
        registry: Optional[MetricsRegistry] = None,
        span_name: str = "local_train",
        max_active_clients: int = 65536,
        trace_budget_bytes: int = 16 << 20,
    ):
        self.window = int(window)
        self.straggler_quantile = float(straggler_quantile)
        self.straggler_margin = float(straggler_margin)
        self.span_name = span_name
        self.trace_budget_bytes = int(trace_budget_bytes)
        self._clients: ActiveSet = ActiveSet(
            capacity=max_active_clients, spill_fn=_spill
        )
        # registry-wide append-only fault-event log (cid, round, kind,
        # detail) — full fidelity for trace replay, bounded in BYTES
        # across all clients (the per-client cap it replaces was
        # unbounded in aggregate at 1M clients × tenants)
        self._fault_log: List[tuple] = []
        self._trace_bytes = 0
        self._trace_dropped: set = set()  # cids with dropped events
        self._lock = threading.Lock()
        self._observations = 0
        self._tracer: Optional[Tracer] = None
        r = registry or get_registry()
        self._g_seen = r.gauge(
            "fedml_clients_seen", "Distinct clients the server has heard from"
        )
        self._g_stragglers = r.gauge(
            "fedml_clients_straggler_count",
            "Clients currently flagged slowest-decile",
        )
        self._h_train = r.histogram(
            "fedml_client_train_seconds",
            "Observed local-train wall time across all clients",
            buckets=_TRAIN_BUCKETS,
        )
        self._c_faults = r.counter(
            "fedml_client_faults_total",
            "Client faults observed/injected, by kind",
            labelnames=("kind",),
        )

    def _touch(self, cid: int) -> _ClientRecord:
        return self._clients.touch(
            cid, lambda spilled: _ClientRecord(self.window, spilled)
        )

    def _known_count(self) -> int:
        # active + spilled are disjoint (touch revives a spilled record)
        return len(self._clients) + len(self._clients.spilled)

    # -- feeding --
    def observe_train(
        self,
        client_id: int,
        round_idx: int,
        wall_s: float,
        tier: Optional[str] = None,
    ) -> bool:
        """Record one local-train observation. Returns False when the
        (client, round) pair was already recorded (span-stream dedupe).
        ``tier`` (from a telemetry beacon) updates the client's
        DeviceProfile attribution even when the timing is deduped."""
        cid = int(client_id)
        r = int(round_idx)
        with self._lock:
            rec = self._touch(cid)
            if tier:
                rec.tier = str(tier)
            if r in rec.seen_rounds:
                return False
            rec.seen_rounds.append(r)
            rec.last_seen_round = max(rec.last_seen_round, r)
            rec.rounds_participated += 1
            rec.times.append(float(wall_s))
            n_clients = self._known_count()
            self._observations += 1
            n_obs = self._observations
        self._g_seen.set(n_clients)
        self._h_train.observe(float(wall_s))
        # the straggler set costs a sort over the ACTIVE clients' means —
        # refresh the gauge on a throttle, not per observation (hot round
        # loops would otherwise pay O(active log active) per client);
        # straggler_ids()/snapshot() always recompute fresh
        if n_obs % 32 == 0 or n_clients <= 32:
            self.straggler_ids()
        return True

    def observe_fault(
        self, client_id: int, round_idx: int, kind: str, detail: float = 0.0
    ) -> None:
        """Record a client fault (scheduler fault injection, or a real
        failure the runtime observed). Faults are NOT train observations:
        they never touch the timing stats or the straggler flag, only the
        per-client fault tally surfaced in snapshot() and the event log
        behind export_trace(). ``detail`` is the event's magnitude where
        one exists (slowdown seconds) so a replayed trace reproduces it."""
        cid = int(client_id)
        with self._lock:
            rec = self._touch(cid)
            rec.faults[kind] = rec.faults.get(kind, 0) + 1
            if self._trace_bytes + _EVENT_BYTES <= self.trace_budget_bytes:
                self._fault_log.append(
                    (cid, int(round_idx), kind, float(detail))
                )
                self._trace_bytes += _EVENT_BYTES
            else:
                # budget exhausted: tallies stay exact, the trace does
                # not — mark THIS client incomplete (loudly, in
                # export_trace and snapshot) so replay refuses it
                self._trace_dropped.add(cid)
            rec.last_seen_round = max(rec.last_seen_round, int(round_idx))
            n_clients = self._known_count()
        self._g_seen.set(n_clients)
        self._c_faults.inc(kind=kind)

    def faults(self, client_id: int) -> Dict[str, int]:
        with self._lock:
            rec = self._clients.get(int(client_id))
            if rec is not None:
                return dict(rec.faults)
            spilled = self._clients.spilled.get(int(client_id))
            return dict(spilled.faults) if spilled else {}

    def _on_span(self, ev: SpanEvent) -> None:
        if ev.name != self.span_name:
            return
        cid = ev.attrs.get("client")
        rnd = ev.attrs.get("round")
        if cid is None or rnd is None:
            return
        self.observe_train(int(cid), int(rnd), ev.dur_us / 1e6)

    def attach(self, tracer: Tracer) -> "ClientHealthRegistry":
        """Feed from the span stream. Idempotent per tracer; switching
        tracers detaches from the previous one first (a listener left on
        the old tracer would keep feeding this registry forever)."""
        if self._tracer is tracer:
            return self
        self.detach()
        tracer.add_listener(self._on_span)
        self._tracer = tracer
        return self

    def detach(self) -> None:
        if self._tracer is not None:
            self._tracer.remove_listener(self._on_span)
            self._tracer = None

    # -- queries (the aggregator-facing API) --
    @property
    def trace_incomplete(self) -> bool:
        """True when the registry-wide trace budget has dropped events —
        the loud marker that export_trace's fleet is partial."""
        with self._lock:
            return bool(self._trace_dropped)

    def clients_seen(self) -> List[int]:
        with self._lock:
            return sorted(self._clients.known_ids())

    def known_client_count(self) -> int:
        """Distinct clients observed (active + spilled) — the cheap
        counterpart of ``len(clients_seen())`` for per-round callers
        (the flight recorder's fold path must not sort the active set)."""
        with self._lock:
            return self._known_count()

    def last_seen_round(self, client_id: int) -> int:
        with self._lock:
            rec = self._clients.get(int(client_id))
            if rec is not None:
                return rec.last_seen_round
            spilled = self._clients.spilled.get(int(client_id))
            return spilled.last_seen_round if spilled else -1

    def rounds_participated(self, client_id: int) -> int:
        with self._lock:
            rec = self._clients.get(int(client_id))
            if rec is not None:
                return rec.rounds_participated
            spilled = self._clients.spilled.get(int(client_id))
            return spilled.rounds_participated if spilled else 0

    def mean_train_s(self, client_id: int) -> Optional[float]:
        with self._lock:
            rec = self._clients.get(int(client_id))
            return rec.mean() if rec else None

    def percentile_train_s(self, client_id: int, q: float = 0.5) -> Optional[float]:
        with self._lock:
            rec = self._clients.get(int(client_id))
            return rec.percentile(q) if rec else None

    def straggler_ids(self) -> List[int]:
        """Clients whose sliding-window mean is in the slowest decile
        (>= the straggler_quantile of all means) AND materially slower
        than the fleet (> straggler_margin × the median mean). The margin
        keeps a homogeneous fleet straggler-free: without it, scheduler
        noise would always flag SOMEONE as "slowest decile". The scan is
        bounded by the ACTIVE set — an evicted client has no current
        timing window, so it cannot be flagged (recently-seen clients
        are exactly the ones a scheduler could select around)."""
        with self._lock:
            means = {
                cid: rec.mean()
                for cid, rec in self._clients.items()
                if rec.times
            }
        if len(means) < 2:
            self._g_stragglers.set(0)
            return []
        xs = sorted(means.values())
        cut = xs[min(int(self.straggler_quantile * len(xs)), len(xs) - 1)]
        median = xs[len(xs) // 2]
        floor = self.straggler_margin * median
        out = sorted(
            cid for cid, m in means.items() if m >= cut and m > floor
        )
        self._g_stragglers.set(len(out))
        return out

    def is_straggler(self, client_id: int) -> bool:
        return int(client_id) in self.straggler_ids()

    def export_trace(self, rounds: Optional[int] = None):
        """Export the observed fleet as a
        :class:`~fedml_tpu_torch.scheduler.faults.FaultTrace` — per-client fault
        events (round + magnitude) and train-time stats.
        ``FaultPlan.from_trace`` replays it byte-identically against the
        same run config (CI replays observed fleets, not hand-written
        JSON). ``rounds`` is the run's round horizon; default
        = last observed round + 1. Only meaningful for ROUND-keyed
        runtimes: a FedBuff server feeds this registry with events keyed
        by dispatch tag, which cannot replay (the CLI skips the export
        there). Clients whose events fell past the registry-wide trace
        budget export ``trace_complete: false`` — replay refuses them."""
        from fedml_tpu_torch.scheduler.faults import FaultTrace

        with self._lock:
            active = {
                cid: (
                    rec.last_seen_round,
                    rec.rounds_participated,
                    rec.mean(),
                    rec.percentile(0.9),
                )
                for cid, rec in self._clients.items()
            }
            spilled = {
                cid: (sp.last_seen_round, sp.rounds_participated, None, None)
                for cid, sp in self._clients.spilled.items()
            }
            events = list(self._fault_log)
            dropped = set(self._trace_dropped)
        stats = {**spilled, **active}
        per_client: Dict[int, Dict[str, list]] = {}
        horizon = 0
        for cid, r, kind, detail in events:
            per_client.setdefault(cid, {}).setdefault(kind, []).append(
                [int(r), float(detail)]
            )
            horizon = max(horizon, int(r) + 1)
        clients = {}
        for cid, (last_seen, participated, mean_s, p90_s) in stats.items():
            horizon = max(horizon, last_seen + 1)
            clients[int(cid)] = {
                "last_seen_round": last_seen,
                "rounds_participated": participated,
                "mean_train_s": mean_s,
                "p90_train_s": p90_s,
                "faults": per_client.get(cid, {}),
                "trace_complete": cid not in dropped,
            }
        return FaultTrace(
            rounds=int(rounds) if rounds is not None else horizon,
            clients=clients,
        )

    def snapshot(self) -> dict:
        """JSON-ready view: {client_id: {last_seen_round, rounds_participated,
        mean_train_s, p50_train_s, p90_train_s, straggler}}. Spilled
        (LRU-evicted) clients appear with their exact counters and null
        timing stats."""
        stragglers = set(self.straggler_ids())
        out = {}
        with self._lock:
            items = list(self._clients.items())
            spilled = list(self._clients.spilled.items())
            dropped = set(self._trace_dropped)
        for cid, rec in items:
            out[str(cid)] = {
                "last_seen_round": rec.last_seen_round,
                "rounds_participated": rec.rounds_participated,
                "mean_train_s": rec.mean(),
                "p50_train_s": rec.percentile(0.5),
                "p90_train_s": rec.percentile(0.9),
                "straggler": cid in stragglers,
                "faults": dict(rec.faults),
            }
            if rec.tier:
                out[str(cid)]["tier"] = rec.tier
            if cid in dropped:
                out[str(cid)]["trace_incomplete"] = True
        for cid, sp in spilled:
            out[str(cid)] = {
                "last_seen_round": sp.last_seen_round,
                "rounds_participated": sp.rounds_participated,
                "mean_train_s": None,
                "p50_train_s": None,
                "p90_train_s": None,
                "straggler": False,
                "faults": dict(sp.faults),
            }
            if cid in dropped:
                out[str(cid)]["trace_incomplete"] = True
        return out

    @classmethod
    def from_config(cls, config, **kw) -> "ClientHealthRegistry":
        """Build with the run's population bounds
        (PopulationConfig.health_active_clients /
        .health_trace_budget_bytes) — ONE definition, shared by every
        runtime that owns a registry (the simulator, sync transports,
        fedbuff), so the serve layer's per-tenant registries are all
        bounded the same way."""
        pop = getattr(config, "population", None)
        if pop is not None:
            kw.setdefault("max_active_clients", pop.health_active_clients)
            kw.setdefault("trace_budget_bytes", pop.health_trace_budget_bytes)
        return cls(**kw)
