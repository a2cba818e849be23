"""Thread-scoped telemetry (a copy of ``fedml_tpu/telemetry/scope.py``) —
the instance isolation layer a multi-tenant federation service needs (the
serve layer, ROADMAP.md §1 item 10).

Every telemetry entry point is a process singleton by default: ONE tracer
(``spans._GLOBAL``), ONE metrics registry. That is exactly right for the
single-run CLI (one federation per process, summary.json as the oracle)
and exactly wrong for a federation SERVICE, where N co-tenant federations
share one process and one card: their round spans would interleave in one
trace and their health gauges would overwrite each other.

A :class:`TelemetryScope` bundles one tenant's telemetry instances —
tracer, metrics registry and comm meter — and installs them on a
per-THREAD stack. ``get_tracer()`` / ``get_registry()`` consult
:func:`current_scope` first and fall back to the process globals, so:

- code that never activates a scope (the whole single-run path, every
  test) behaves identically — the globals are still the globals;
- a federation session that wraps its server/client/worker threads in
  ``scope.activate()`` gets instance-scoped telemetry without any call
  site changing: the managers, trainers and health registries it
  constructs on those threads all land in the scope.

Threads do NOT inherit the scope automatically (thread-locals don't
propagate); whoever spawns a thread for a scoped workload must wrap the
thread body (``scope.wrap(fn)`` or ``with activate_scope(scope):``).

The reference's per-scope XLA compile attribution counters have no
counterpart here: the port compiles no programs."""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

_TLS = threading.local()


def _stack():
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def current_scope() -> Optional["TelemetryScope"]:
    """The innermost scope activated on THIS thread, or None (globals)."""
    st = getattr(_TLS, "stack", None)
    return st[-1] if st else None


class TelemetryScope:
    """One tenant's telemetry instances."""

    def __init__(self, tenant: Optional[str] = None, tracer=None, registry=None, comm_meter=None):
        # lazy imports: scope.py must be importable from spans/metrics
        # without a cycle (they import current_scope at module level)
        from fedml_tpu_torch.telemetry.comm import CommMeter
        from fedml_tpu_torch.telemetry.metrics import MetricsRegistry
        from fedml_tpu_torch.telemetry.spans import Tracer

        self.tenant = tenant
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        self.comm_meter = comm_meter if comm_meter is not None else CommMeter()

    @contextlib.contextmanager
    def activate(self):
        """Install this scope on the calling thread for the duration."""
        st = _stack()
        st.append(self)
        try:
            yield self
        finally:
            # remove THIS scope specifically: a mis-nested exit must not
            # pop someone else's scope off the stack
            if st and st[-1] is self:
                st.pop()
            elif self in st:
                st.remove(self)

    def wrap(self, fn):
        """A callable that runs ``fn`` under this scope — the thread-body
        propagation helper (thread-locals don't cross Thread boundaries)."""

        def _scoped(*args, **kwargs):
            with self.activate():
                return fn(*args, **kwargs)

        return _scoped

    def __repr__(self):
        return f"TelemetryScope(tenant={self.tenant!r})"


def activate_scope(scope: Optional[TelemetryScope]):
    """None-tolerant ``scope.activate()``: a no-op context manager when
    ``scope`` is None, so ambient-scope code paths need no branching."""
    if scope is None:
        return contextlib.nullcontext()
    return scope.activate()


def wrap_in_current_scope(fn):
    """``fn`` bound to the CALLING thread's active scope — the way to hand
    a callable to ``threading.Thread`` without dropping the spawner's
    tenant attribution. Identity when no scope is active."""
    scope = current_scope()
    if scope is None:
        return fn
    return scope.wrap(fn)
