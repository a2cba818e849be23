"""Deterministic fault injection for federated runs (a copy of
``fedml_tpu/scheduler/faults.py``; numpy and the stdlib only).

The deadline/quorum recovery paths (fedavg_transport.py), the FedBuff
staleness machinery, and the loopback/shm/gRPC transports all exist to
tolerate clients that are slow, flaky, or gone — but until now the only
way to exercise them was wall-clock luck (a sleep in a test, a real
straggler in production). A :class:`FaultPlan` makes client misbehavior a
config input: per-client dropout probability, a fixed slowdown, a
crash-at-round, and a flaky (duplicated) upload, every decision a pure
function of ``(plan seed, client id, round)`` so the same plan injects
the same faults in every run, process, and resumed continuation.

JSON schema (CLI ``--fault_plan`` accepts the inline document or a path
to a file containing it)::

    {
      "seed": 0,                      # fault RNG seed (default 0)
      "default": {                    # spec applied to unlisted clients
        "dropout_p": 0.0,             # P(skip this round's upload)
        "slowdown_s": 0.0,            # sleep this long around training
        "crash_at_round": null,       # from this round on: silent forever
        "flaky_upload_p": 0.0         # P(upload delivered twice)
      },
      "clients": {"3": {"dropout_p": 0.5}, ...}   # per-client overrides
    }

Semantics by runtime:

- **sync transports** (loopback/shm/grpc/mqtt): ``dropout`` — the client
  skips training and never uploads that round (the server's
  deadline/quorum path absorbs it; sync runs therefore REQUIRE
  ``deadline_s > 0`` when the plan can drop). ``crash_at_round`` — the
  CLIENT is silent in every round that samples it from that round on
  (the worker slot stays alive: the sampler re-assigns clients to
  workers each round, and faults follow the client). ``slowdown_s`` —
  sleep around local training (drives the straggler detector and
  deadline races). ``flaky_upload`` — the upload is sent twice
  (at-least-once retry double-delivery; exercises the sync server's
  same-slot overwrite).
- **FedBuff**: faults are per assignment (dispatch tag). A dropped or
  crashed assignment is DECLINED (an empty ``ARG_DECLINED`` reply) and
  the server immediately re-dispatches, so the worker fleet never
  shrinks and the delta buffer keeps filling; ``flaky_upload``
  double-sends the delta, exercising the at-least-once dedupe.
- **vmap/mesh simulators**: the cohort trains as one jitted program, so
  only participation faults apply — ``dropout``/``crash`` remove the
  client from the round's cohort before batching (at least one survivor
  is kept so the round stays well-formed); timing faults are ignored.

Beyond the probabilistic specs, three ways to describe a fleet once and
replay it forever (the record → replay → survive loop):

- **Device profiles** (``DeviceProfile`` / ``DEVICE_PROFILES``): named
  speed/memory tiers whose characteristics drive the fault spec — a slow
  tier adds per-round latency (``slowdown_s``), a memory-starved tier
  drops more often (background OOM kills). A client spec may be a
  profile NAME, the plan may define custom ``"profiles"``, and a
  ``"fleet"`` shorthand assigns tiers to a whole population
  deterministically by the plan seed.
- **Scripted events** (``"scripted"``): exact per-(client, round) fault
  events instead of coin flips — what :meth:`FaultPlan.from_trace`
  emits, so a recorded fleet replays byte-identically.
- **Fault traces** (:class:`FaultTrace`): the observed record the
  server-side client health registry (``telemetry/health.py``)
  exports (per-client fault events with rounds + magnitudes, train-time
  stats). ``--fault_plan trace:<path>`` replays one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClientFaultSpec:
    dropout_p: float = 0.0
    slowdown_s: float = 0.0
    crash_at_round: Optional[int] = None
    flaky_upload_p: float = 0.0

    def validate(self, who: str) -> None:
        if not 0.0 <= self.dropout_p <= 1.0:
            raise ValueError(f"{who}: dropout_p must be in [0, 1]")
        if not 0.0 <= self.flaky_upload_p <= 1.0:
            raise ValueError(f"{who}: flaky_upload_p must be in [0, 1]")
        if self.slowdown_s < 0:
            raise ValueError(f"{who}: slowdown_s must be >= 0")
        if self.crash_at_round is not None and self.crash_at_round < 0:
            raise ValueError(f"{who}: crash_at_round must be >= 0")


@dataclasses.dataclass(frozen=True)
class FaultDecision:
    """What happens to (client, round): at most one participation fault
    (crashed wins over drop) plus independent timing faults."""

    crashed: bool = False
    drop: bool = False
    slowdown_s: float = 0.0
    flaky: bool = False

    @property
    def participates(self) -> bool:
        return not (self.crashed or self.drop)


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """One heterogeneous device class — speed/memory tiers described once
    and reused across plans. The tier's characteristics map onto the
    fault spec: a slow compute tier contributes per-round latency
    (``slowdown_s``, driving the straggler detector and deadline races),
    a memory-starved tier gets background-killed more often (higher
    ``dropout_p``) and re-sends more (``flaky_upload_p``)."""

    name: str
    slowdown_s: float = 0.0
    dropout_p: float = 0.0
    flaky_upload_p: float = 0.0
    crash_at_round: Optional[int] = None

    def spec(self) -> ClientFaultSpec:
        return ClientFaultSpec(
            dropout_p=self.dropout_p,
            slowdown_s=self.slowdown_s,
            crash_at_round=self.crash_at_round,
            flaky_upload_p=self.flaky_upload_p,
        )


# Built-in tiers (overridable / extendable via a plan's "profiles" key).
# Magnitudes are sized for CI-scale rounds (sub-second local training);
# scale slowdown_s up for real workloads.
DEVICE_PROFILES: Dict[str, DeviceProfile] = {
    p.name: p
    for p in (
        DeviceProfile("server_grade"),
        DeviceProfile("highend_phone", slowdown_s=0.02, dropout_p=0.01),
        DeviceProfile("midrange_phone", slowdown_s=0.08, dropout_p=0.05),
        DeviceProfile(
            "lowend_phone",
            slowdown_s=0.25, dropout_p=0.12, flaky_upload_p=0.05,
        ),
    )
}


_SPEC_KEYS = {f.name for f in dataclasses.fields(ClientFaultSpec)}


def _parse_spec(doc, who: str, profiles=None) -> ClientFaultSpec:
    """Parse one client spec: a plain field dict, a profile NAME, or
    ``{"profile": name, <field overrides>}``."""
    profiles = profiles or DEVICE_PROFILES
    if isinstance(doc, str):
        doc = {"profile": doc}
    if not isinstance(doc, dict):
        raise ValueError(
            f"{who}: a fault spec is a dict of fields or a profile name, "
            f"got {doc!r}"
        )
    doc = dict(doc)
    base: Dict[str, object] = {}
    prof_name = doc.pop("profile", None)
    if prof_name is not None:
        prof = profiles.get(str(prof_name))
        if prof is None:
            raise ValueError(
                f"{who}: unknown device profile {prof_name!r} "
                f"(known: {sorted(profiles)})"
            )
        base = dataclasses.asdict(prof.spec())
    unknown = set(doc) - _SPEC_KEYS
    if unknown:
        raise ValueError(
            f"{who}: unknown fault spec keys {sorted(unknown)} "
            f"(known: {sorted(_SPEC_KEYS)}, plus 'profile')"
        )
    base.update(doc)
    spec = ClientFaultSpec(**base)
    spec.validate(who)
    return spec


def _parse_profiles(doc: dict) -> Dict[str, DeviceProfile]:
    """The plan's custom tier definitions, layered over the built-ins."""
    out = dict(DEVICE_PROFILES)
    for name, fields in (doc or {}).items():
        # fields may be a dict, a built-in profile NAME (alias), or
        # {"profile": base, overrides} — _parse_spec handles all three
        spec = _parse_spec(fields, f"device profile {name!r}")
        out[str(name)] = DeviceProfile(
            name=str(name),
            slowdown_s=spec.slowdown_s,
            dropout_p=spec.dropout_p,
            flaky_upload_p=spec.flaky_upload_p,
            crash_at_round=spec.crash_at_round,
        )
    return out


def _assign_fleet(
    fleet: Dict[str, float],
    num_clients: int,
    seed: int,
    profiles: Dict[str, DeviceProfile],
) -> Dict[int, str]:
    """Deterministically assign every client id a profile name from
    ``{profile: weight}`` (weights are fractions or counts — normalized,
    apportioned by largest remainder). Pure in (fleet, num_clients,
    seed): the same fleet description always materializes the same
    per-client tiers, so a fleet is described once and replayed forever."""
    if num_clients <= 0:
        raise ValueError("fleet plans need a positive num_clients")
    names = sorted(fleet)
    for n in names:
        if n not in profiles:
            raise ValueError(
                f"fleet references unknown profile {n!r} "
                f"(known: {sorted(profiles)})"
            )
    weights = np.asarray([float(fleet[n]) for n in names], dtype=np.float64)
    if (weights < 0).any() or weights.sum() <= 0:
        raise ValueError("fleet weights must be non-negative and sum > 0")
    exact = weights / weights.sum() * num_clients
    counts = np.floor(exact).astype(int)
    # largest remainder fills the shortfall; ties break by name order
    for i in np.argsort(-(exact - counts), kind="stable")[: num_clients - counts.sum()]:
        counts[i] += 1
    ids = np.arange(num_clients)
    rng = np.random.default_rng([int(seed) & 0x7FFFFFFF, 0xF1EE7])
    rng.shuffle(ids)
    out: Dict[int, str] = {}
    pos = 0
    for name, c in zip(names, counts):
        for cid in ids[pos : pos + c]:
            out[int(cid)] = name
        pos += c
    return out


_SCRIPT_EVENT_KEYS = {"drop", "flaky", "slowdown_s"}


class FaultPlan:
    """Per-client fault specs + the deterministic per-round coin flips.

    ``scripted`` replaces the coin flips for the clients it names with
    exact per-round events — ``{client: {round: {"drop": bool, "flaky":
    bool, "slowdown_s": float}}}`` — which is how a recorded
    :class:`FaultTrace` replays byte-identically (crash stays on the
    spec's ``crash_at_round``: it is already deterministic)."""

    def __init__(
        self,
        clients: Optional[Dict[int, ClientFaultSpec]] = None,
        default: Optional[ClientFaultSpec] = None,
        seed: int = 0,
        scripted: Optional[Dict[int, Dict[int, dict]]] = None,
        tiers: Optional[Dict[int, str]] = None,
    ):
        self.clients = {int(c): s for c, s in (clients or {}).items()}
        self.default = default or ClientFaultSpec()
        self.seed = int(seed)
        self.scripted = {
            int(c): {int(r): dict(ev) for r, ev in rounds.items()}
            for c, rounds in (scripted or {}).items()
        }
        # client -> DeviceProfile tier NAME: the attribution key the
        # telemetry beacons carry (telemetry/wire.py) and the fleet
        # aggregator groups by. Populated by from_json from fleet
        # assignments and named-profile client entries; spec parsing used
        # to discard the names.
        self.tiers = {int(c): str(t) for c, t in (tiers or {}).items()}

    # -- construction --
    @classmethod
    def from_json(cls, doc: dict) -> "FaultPlan":
        unknown = set(doc) - {
            "seed", "default", "clients", "profiles", "fleet",
            "num_clients", "scripted", "tiers",
        }
        if unknown:
            raise ValueError(
                f"fault plan: unknown top-level keys {sorted(unknown)} "
                "(known: seed, default, clients, profiles, fleet, "
                "num_clients, scripted, tiers)"
            )
        seed = doc.get("seed", 0)
        profiles = _parse_profiles(doc.get("profiles"))
        clients = {}
        tiers: Dict[int, str] = {}
        if doc.get("fleet"):
            # the whole-population shorthand: {"fleet": {tier: weight},
            # "num_clients": N} — per-client tiers derive deterministically
            # from the plan seed, then explicit "clients" entries override
            assignment = _assign_fleet(
                doc["fleet"], int(doc.get("num_clients", 0)), seed, profiles
            )
            clients = {
                cid: profiles[name].spec() for cid, name in assignment.items()
            }
            tiers.update(assignment)
        elif "num_clients" in doc:
            raise ValueError("fault plan: num_clients only makes sense with fleet")
        for cid, spec in (doc.get("clients") or {}).items():
            clients[int(cid)] = _parse_spec(
                spec, f"fault plan client {cid}", profiles=profiles
            )
            # keep the tier NAME when the entry references a profile
            # (a plain string alias or {"profile": name, ...overrides})
            name = (
                spec if isinstance(spec, str)
                else spec.get("profile") if isinstance(spec, dict)
                else None
            )
            if name is not None:
                tiers[int(cid)] = str(name)
        # explicit tiers (e.g. a to_json round-trip) take precedence
        for cid, name in (doc.get("tiers") or {}).items():
            tiers[int(cid)] = str(name)
        default = _parse_spec(
            doc.get("default", {}), "fault plan default", profiles=profiles
        )
        scripted = {}
        for cid, rounds in (doc.get("scripted") or {}).items():
            per = {}
            for r, ev in rounds.items():
                unknown_ev = set(ev) - _SCRIPT_EVENT_KEYS
                if unknown_ev:
                    raise ValueError(
                        f"fault plan scripted[{cid}][{r}]: unknown keys "
                        f"{sorted(unknown_ev)} (known: {sorted(_SCRIPT_EVENT_KEYS)})"
                    )
                per[int(r)] = {
                    "drop": bool(ev.get("drop", False)),
                    "flaky": bool(ev.get("flaky", False)),
                    "slowdown_s": float(ev.get("slowdown_s", 0.0)),
                }
            scripted[int(cid)] = per
        return cls(
            clients=clients, default=default, seed=seed, scripted=scripted,
            tiers=tiers,
        )

    @classmethod
    def from_spec(cls, spec: str) -> Optional["FaultPlan"]:
        """Parse the CLI/config string: inline JSON (starts with '{'),
        ``trace:<path>`` (replay a recorded :class:`FaultTrace`
        byte-identically), or a path to a JSON plan file; ''/None means
        no faults."""
        if not spec:
            return None
        text = spec.strip()
        if text.startswith("trace:"):
            return cls.from_trace(FaultTrace.load(text[len("trace:"):]))
        if not text.startswith("{"):
            if not os.path.exists(text):
                raise ValueError(
                    f"fault plan {text!r} is neither inline JSON, a "
                    "trace:<path> reference, nor an existing file"
                )
            with open(text) as f:
                text = f.read()
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"fault plan is not valid JSON: {e}") from e
        return cls.from_json(doc)

    @classmethod
    def from_config(cls, config) -> Optional["FaultPlan"]:
        return cls.from_spec(getattr(config.fed, "fault_plan", ""))

    @classmethod
    def from_trace(cls, trace: "FaultTrace", seed: int = 0) -> "FaultPlan":
        """A plan that REPLAYS an observed trace exactly: every recorded
        (client, round) dropout/flaky/slowdown event becomes a scripted
        event (slowdowns at their recorded magnitude), a recorded crash
        becomes ``crash_at_round`` at its first observed round. Replayed
        against the same run config (same selection seed → same cohorts)
        the injected ``faults/*`` summary rows are byte-identical to the
        recorded run's — the ci.sh chaos gate."""
        clients: Dict[int, ClientFaultSpec] = {}
        scripted: Dict[int, Dict[int, dict]] = {}
        for cid, rec in trace.clients.items():
            if not rec.get("trace_complete", True):
                raise ValueError(
                    f"fault trace for client {cid} is truncated "
                    "(recorder event cap exceeded) — an incomplete trace "
                    "cannot replay faithfully"
                )
            faults = rec.get("faults", {})
            crash_rounds = [int(r) for r, _ in faults.get("crash", [])]
            if crash_rounds:
                clients[int(cid)] = ClientFaultSpec(
                    crash_at_round=min(crash_rounds)
                )
            script: Dict[int, dict] = {}
            for r, _ in faults.get("dropout", []):
                script.setdefault(int(r), {})["drop"] = True
            for r, _ in faults.get("flaky", []):
                script.setdefault(int(r), {})["flaky"] = True
            for r, detail in faults.get("slowdown", []):
                # the recorded magnitude, floored so the replayed decision
                # still REGISTERS as a slowdown when the original detail
                # was not captured (older traces)
                script.setdefault(int(r), {})["slowdown_s"] = max(
                    float(detail or 0.0), 1e-3
                )
            if script:
                scripted[int(cid)] = script
        return cls(clients=clients, seed=seed, scripted=scripted)

    # -- queries --
    def spec_for(self, client_id: int) -> ClientFaultSpec:
        return self.clients.get(int(client_id), self.default)

    def tier_of(self, client_id: int) -> Optional[str]:
        """The client's DeviceProfile tier name (None when the plan never
        assigned one) — what a client stamps into its telemetry beacon."""
        return self.tiers.get(int(client_id))

    def has_participation_faults(self) -> bool:
        """True when the plan can remove an upload (dropout or crash) —
        sync transport runs then need deadline/quorum rounds to not hang."""
        if any(
            s.dropout_p > 0 or s.crash_at_round is not None
            for s in list(self.clients.values()) + [self.default]
        ):
            return True
        return any(
            ev.get("drop")
            for rounds in self.scripted.values()
            for ev in rounds.values()
        )

    def decide(
        self, client_id: int, round_idx: int, crash_round: Optional[int] = None
    ) -> FaultDecision:
        """The (client, round) fault decision — pure in (seed, client,
        round): one SeedSequence draw stream per pair, probabilities in a
        fixed order, so every process and every re-run agrees. A client
        with a scripted schedule skips the coin flips entirely — its
        decision IS the recorded event for that round (none recorded =
        no fault), which is what makes trace replay byte-identical.

        ``crash_round`` overrides the value ``crash_at_round`` is compared
        against: FedBuff keys its probabilistic draws by the per-assignment
        dispatch tag (unique, unbounded), which would cross any
        ``crash_at_round`` threshold within a few dozen dispatches — it
        passes the server MODEL VERSION here instead (the async analog of
        a training round)."""
        spec = self.spec_for(client_id)
        cr = int(round_idx) if crash_round is None else int(crash_round)
        crashed = spec.crash_at_round is not None and cr >= spec.crash_at_round
        script = self.scripted.get(int(client_id))
        if script is not None:
            ev = script.get(int(round_idx), {})
            return FaultDecision(
                crashed=crashed,
                drop=bool(ev.get("drop")) and not crashed,
                slowdown_s=float(ev.get("slowdown_s", 0.0)),
                flaky=bool(ev.get("flaky")) and not crashed,
            )
        drop = flaky = False
        if spec.dropout_p > 0 or spec.flaky_upload_p > 0:
            rng = np.random.default_rng(
                [self.seed & 0x7FFFFFFF, int(client_id), int(round_idx) & 0x7FFFFFFF]
            )
            drop = bool(rng.random() < spec.dropout_p)
            flaky = bool(rng.random() < spec.flaky_upload_p)
        return FaultDecision(
            crashed=crashed,
            drop=drop and not crashed,
            slowdown_s=spec.slowdown_s,
            flaky=flaky and not crashed,
        )

    def to_json(self) -> dict:
        """Canonical (materialized) JSON: profile/fleet sugar is resolved
        to per-client specs at parse time, so ``from_json(to_json())``
        round-trips to identical decisions."""
        doc = {
            "seed": self.seed,
            "default": dataclasses.asdict(self.default),
            "clients": {
                str(c): dataclasses.asdict(s) for c, s in sorted(self.clients.items())
            },
        }
        if self.scripted:
            doc["scripted"] = {
                str(c): {str(r): dict(ev) for r, ev in sorted(rounds.items())}
                for c, rounds in sorted(self.scripted.items())
            }
        if self.tiers:
            doc["tiers"] = {
                str(c): t for c, t in sorted(self.tiers.items())
            }
        return doc


class FaultTrace:
    """An OBSERVED fleet: per-client fault events (round + magnitude) and
    train-time statistics, exported by the server-side
    client health registry of ``telemetry/health.py`` (``export_trace()``;
    the reference's CLI writes ``fault_trace.json`` next to ``health.json``
    under ``--telemetry_dir``, ROADMAP.md §1 item 1).

    ``clients[cid]`` carries ``{"faults": {kind: [[round, detail], ...]},
    "rounds_participated", "last_seen_round", "mean_train_s",
    "p90_train_s", "trace_complete"}``. :meth:`FaultPlan.from_trace`
    turns it back into an injectable plan — record once, replay forever."""

    VERSION = 1

    def __init__(self, rounds: int, clients: Optional[Dict[int, dict]] = None):
        self.rounds = int(rounds)
        self.clients: Dict[int, dict] = {
            int(c): dict(rec) for c, rec in (clients or {}).items()
        }

    def to_json(self) -> dict:
        return {
            "version": self.VERSION,
            "rounds": self.rounds,
            "clients": {
                str(c): rec for c, rec in sorted(self.clients.items())
            },
        }

    @classmethod
    def from_json(cls, doc: dict) -> "FaultTrace":
        if doc.get("version", 1) != cls.VERSION:
            raise ValueError(
                f"unsupported fault trace version {doc.get('version')!r}"
            )
        return cls(rounds=doc.get("rounds", 0), clients={
            int(c): dict(rec) for c, rec in (doc.get("clients") or {}).items()
        })

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "FaultTrace":
        if not os.path.exists(path):
            raise ValueError(f"fault trace file {path!r} does not exist")
        with open(path) as f:
            try:
                doc = json.load(f)
            except json.JSONDecodeError as e:
                raise ValueError(f"fault trace is not valid JSON: {e}") from e
        return cls.from_json(doc)


_FAULT_KINDS = ("dropout", "crash", "slowdown", "flaky")
# MetricsLogger key per kind (summary.json schema, asserted by CI)
_FAULT_ROW_KEYS = {
    "dropout": "faults/dropouts",
    "crash": "faults/crashes",
    "slowdown": "faults/slowdowns",
    "flaky": "faults/flaky_uploads",
}


class FaultInjector:
    """The runtime half: applies a plan's decisions and accounts for every
    injected fault (thread-safe — transport clients run in threads).

    One injector is shared across a federation's client actors so the
    counters describe the RUN; ``summary_row()`` is forwarded into
    MetricsLogger at the end (summary.json records the injected faults —
    the CI oracle contract), each event is emitted as a ``fault``
    telemetry span, and — when the server's health registry is reachable
    (in-process federations) — recorded per client via
    ``ClientHealthRegistry.observe_fault``."""

    def __init__(
        self,
        plan: FaultPlan,
        health: Optional[object] = None,
        tracer: Optional[object] = None,
    ):
        self.plan = plan
        self.health = health
        self._tracer = tracer
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {k: 0 for k in _FAULT_KINDS}
        self._crash_logged: set = set()

    @classmethod
    def from_config(
        cls, config, health=None, tracer=None
    ) -> Optional["FaultInjector"]:
        plan = FaultPlan.from_config(config)
        if plan is None:
            return None
        return cls(plan, health=health, tracer=tracer)

    def decide(
        self, client_id: int, round_idx: int, crash_round: Optional[int] = None
    ) -> FaultDecision:
        return self.plan.decide(client_id, round_idx, crash_round=crash_round)

    def record(
        self, client_id: int, round_idx: int, kind: str, detail: float = 0.0
    ) -> None:
        """Account one injected fault. ``detail`` carries the event's
        magnitude where one exists (slowdown seconds) so the health
        registry's fault trace can replay it exactly."""
        assert kind in _FAULT_KINDS, kind
        with self._lock:
            if kind == "crash":
                # a crash is one event per client, not one per ignored round
                if client_id in self._crash_logged:
                    return
                self._crash_logged.add(client_id)
            self.counters[kind] += 1
        if self._tracer is not None:
            with self._tracer.span(
                "fault", client=int(client_id), round=int(round_idx), kind=kind
            ):
                pass
        if self.health is not None and hasattr(self.health, "observe_fault"):
            self.health.observe_fault(client_id, round_idx, kind, detail=detail)

    def total(self) -> int:
        with self._lock:
            return sum(self.counters.values())

    def summary_row(self) -> dict:
        """Flat MetricsLogger row of the run's injected-fault counts."""
        with self._lock:
            row = {
                _FAULT_ROW_KEYS[k]: int(v) for k, v in self.counters.items()
            }
            row["faults/total"] = sum(self.counters.values())
        return row
