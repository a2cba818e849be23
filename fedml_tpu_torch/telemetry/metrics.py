"""Counter/gauge/histogram primitives + a registry that renders Prometheus
text exposition format (version 0.0.4) — a copy of
``fedml_tpu/telemetry/metrics.py``, stdlib only, no prometheus_client
dependency; its rendered text is the reference's byte for byte.

Semantics follow the Prometheus data model:

- ``Counter``: monotonically increasing float, per label-set.
- ``Gauge``: settable float, per label-set.
- ``Histogram``: cumulative buckets + ``_sum``/``_count``, per label-set.

All instruments are thread-safe (one lock per instrument — the comm hot
path touches at most two instruments per message) and registered in a
:class:`MetricsRegistry`; ``registry.render()`` is what the Prometheus
exporter serves and what tests parse."""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Default latency buckets (seconds): federated rounds span sub-ms loopback
# handling to minutes-long stragglers.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labelnames: Sequence[str], labelvalues: Sequence[str], extra: str = "") -> str:
    parts = [
        f'{n}="{_escape_label(v)}"' for n, v in zip(labelnames, labelvalues)
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{tuple(labels)}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def samples(self, extra: str = "") -> List[str]:
        """Sample lines only (no HELP/TYPE header). ``extra`` is a
        pre-formatted label fragment (e.g. ``tenant="a"``) appended to
        every sample's label set — the multi-tenant exporter's injection
        point (:class:`TenantedRegistryView`)."""
        raise NotImplementedError

    def render(self) -> List[str]:
        return [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ] + self.samples()


class Counter(_Instrument):
    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def per_label(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._values)

    def samples(self, extra: str = "") -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [
            f"{self.name}{_fmt_labels(self.labelnames, key, extra)} "
            f"{_fmt_value(v)}"
            for key, v in items
        ]


class Gauge(_Instrument):
    kind = "gauge"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def samples(self, extra: str = "") -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [
            f"{self.name}{_fmt_labels(self.labelnames, key, extra)} "
            f"{_fmt_value(v)}"
            for key, v in items
        ]


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help, labelnames)
        b = sorted(float(x) for x in buckets)
        if not b or b[-1] != math.inf:
            b.append(math.inf)
        self.buckets = tuple(b)
        # per label-set: [bucket counts...], sum, count
        self._counts: Dict[Tuple[str, ...], List[float]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._totals: Dict[Tuple[str, ...], float] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0.0] * len(self.buckets)
                self._sums[key] = 0.0
                self._totals[key] = 0.0
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
                    break
            self._sums[key] += float(value)
            self._totals[key] += 1

    def count(self, **labels) -> float:
        with self._lock:
            return self._totals.get(self._key(labels), 0.0)

    def sum(self, **labels) -> float:
        with self._lock:
            return self._sums.get(self._key(labels), 0.0)

    def samples(self, extra: str = "") -> List[str]:
        out: List[str] = []
        with self._lock:
            items = sorted(self._counts.items())
            sums = dict(self._sums)
            totals = dict(self._totals)
        for key, counts in items:
            cum = 0.0
            for ub, c in zip(self.buckets, counts):
                cum += c
                le = "+Inf" if math.isinf(ub) else repr(ub)
                le_label = 'le="%s"' % le
                if extra:
                    le_label = f"{extra},{le_label}"
                out.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(self.labelnames, key, le_label)} "
                    f"{_fmt_value(cum)}"
                )
            out.append(
                f"{self.name}_sum{_fmt_labels(self.labelnames, key, extra)} "
                f"{_fmt_value(sums[key])}"
            )
            out.append(
                f"{self.name}_count{_fmt_labels(self.labelnames, key, extra)} "
                f"{_fmt_value(totals[key])}"
            )
        return out


class MetricsRegistry:
    """Name → instrument registry. ``counter/gauge/histogram`` are
    idempotent by name (re-registration returns the existing instrument —
    module-level meters and tests can both ask for the same metric)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Instrument:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls) or inst.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{inst.kind}{inst.labelnames}"
                    )
                return inst
            inst = cls(name, help, labelnames, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(name)

    def instruments(self) -> Iterable[_Instrument]:
        with self._lock:
            return list(self._instruments.values())

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4 (trailing newline
        included, as the spec requires)."""
        lines: List[str] = []
        for inst in sorted(self.instruments(), key=lambda i: i.name):
            lines.extend(inst.render())
        return "\n".join(lines) + "\n"

    def unregister(self, name: str) -> None:
        with self._lock:
            self._instruments.pop(name, None)


_GLOBAL = MetricsRegistry()

from fedml_tpu_torch.telemetry.scope import current_scope  # noqa: E402 — after
# MetricsRegistry so scope.py's lazy constructor can import it (no cycle)


def get_registry() -> MetricsRegistry:
    """The registry for the calling thread: the active
    :class:`fedml_tpu_torch.telemetry.scope.TelemetryScope`'s registry when one
    is installed (per-tenant instruments in multi-tenant serving), else
    the process-wide registry the single-run Prometheus exporter serves."""
    sc = current_scope()
    return sc.registry if sc is not None else _GLOBAL


def get_global_registry() -> MetricsRegistry:
    """The process-wide registry, regardless of any active scope —
    process-wide facts must publish here so a tenant registry never carries a process total under
    a tenant label."""
    return _GLOBAL


class TenantedRegistryView:
    """Composite render view over the global registry plus N per-tenant
    registries — what ONE Prometheus exporter serves for a multi-tenant
    federation service (the serve layer, ROADMAP.md §1 item 10).

    Tenant registries' samples get a ``tenant="<name>"`` label injected
    (plus any per-tenant ``extra`` labels — the serve layer attaches
    ``device="gpu|cpu|..."`` for multi-device placement); the base registry's samples stay unlabeled. The exposition format
    requires each metric name to appear in exactly one HELP/TYPE block,
    so rendering groups samples across registries by metric name (N
    tenants recording ``fedml_comm_bytes_sent_total`` yield one block
    with N × label-set sample lines). Duck-typed against
    :class:`PrometheusExporter`'s ``registry`` slot (it only calls
    ``render()``)."""

    def __init__(
        self,
        base: Optional[MetricsRegistry] = None,
        label: str = "tenant",
    ):
        self._lock = threading.Lock()
        self._base = base
        self._label = label
        self._tenants: Dict[str, Tuple[MetricsRegistry, Dict[str, str]]] = {}

    def add_tenant(
        self,
        name: str,
        registry: MetricsRegistry,
        extra: Optional[Dict[str, str]] = None,
    ) -> None:
        """Register a tenant registry; ``extra`` label pairs (e.g.
        ``{"device": "gpu"}``) ride alongside the tenant label on every
        sample."""
        with self._lock:
            self._tenants[str(name)] = (registry, dict(extra or {}))

    def remove_tenant(self, name: str) -> None:
        with self._lock:
            self._tenants.pop(str(name), None)

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    @staticmethod
    def _fragment(label: str, name: str, extra: Dict[str, str]) -> str:
        parts = [f'{label}="{_escape_label(name)}"'] + [
            f'{k}="{_escape_label(v)}"' for k, v in sorted(extra.items())
        ]
        return ",".join(parts)

    def render(self) -> str:
        with self._lock:
            sources = [("", self._base)] if self._base is not None else []
            sources += [
                (self._fragment(self._label, name, extra), reg)
                for name, (reg, extra) in sorted(self._tenants.items())
            ]
        groups: Dict[str, tuple] = {}
        for extra, reg in sources:
            for inst in reg.instruments():
                g = groups.get(inst.name)
                if g is None:
                    groups[inst.name] = g = (inst.kind, inst.help, [])
                elif g[0] != inst.kind:
                    # name registered with different kinds across tenants:
                    # keep the first block valid, skip the clashing samples
                    continue
                g[2].extend(inst.samples(extra))
        lines: List[str] = []
        for name in sorted(groups):
            kind, help, samples = groups[name]
            lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")
            lines.extend(samples)
        return "\n".join(lines) + "\n"
