"""Zero-dependency structured tracer (port of ``fedml_tpu/telemetry/spans.py``:
recording, listeners and the scope-aware accessor; the Chrome-trace export
is not ported, ROADMAP.md §1 item 1).

A span is a named wall-clock interval with attributes::

    tracer = get_tracer()
    with tracer.span("round", round=3):
        with tracer.span("broadcast", round=3):
            ...

Spans are thread-safe and nestable; each thread keeps its own nesting stack
(parent attribution), and the recording buffer is shared, so one trace
covers the server thread and the client actor threads. Intervals that begin
on one thread and end on another (a federated round begins at broadcast and
ends in a receive handler) use the explicit handle API::

    s = tracer.start_span("round", round=r)   # on the broadcast thread
    ...
    s.end()                                   # on the handler thread

Timestamps are epoch-anchored microseconds: wall clock at the tracer's
creation plus the monotonic time since, so they compare across processes
but never jump with clock adjustments mid-run.

Listeners (``add_listener``) receive every finished :class:`SpanEvent`,
outside the tracer's lock; a failing listener is logged and never breaks
the span — the client health registry feeds on ``local_train`` spans this
way."""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

# Bounded recording: past the cap, new events are dropped and counted.
DEFAULT_MAX_EVENTS = 1_000_000


class SpanEvent:
    """One finished span: name, epoch-anchored start (us), duration (us),
    recording thread id, and user attributes."""

    __slots__ = ("name", "ts_us", "dur_us", "pid", "tid", "attrs")

    def __init__(self, name: str, ts_us: float, dur_us: float, pid: int, tid: int,
                 attrs: Dict[str, Any]):
        self.name = name
        self.ts_us = ts_us
        self.dur_us = dur_us
        self.pid = pid
        self.tid = tid
        self.attrs = attrs


class Span:
    """A live span handle; ``end()`` is idempotent and may be called from
    any thread."""

    __slots__ = ("_tracer", "name", "attrs", "_t0_perf", "_ts_us", "_done", "_end_lock")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._ts_us = tracer.now_us()
        self._t0_perf = time.perf_counter_ns()
        self._done = False
        self._end_lock = threading.Lock()

    def end(self) -> Optional[SpanEvent]:
        # atomic test-and-set: end() may race from two threads and must
        # record exactly once
        with self._end_lock:
            if self._done:
                return None
            self._done = True
        dur_us = (time.perf_counter_ns() - self._t0_perf) / 1e3
        ev = SpanEvent(self.name, self._ts_us, dur_us, os.getpid(), threading.get_ident(),
                       self.attrs)
        self._tracer._record(ev)
        return ev

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        return self

    def __exit__(self, *exc) -> None:
        self._tracer._pop(self)
        self.end()


class Tracer:
    """Thread-safe span recorder with a bounded buffer."""

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS):
        self._events: List[SpanEvent] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self.max_events = int(max_events)
        self.dropped = 0
        self._epoch_us = time.time() * 1e6
        self._anchor_ns = time.perf_counter_ns()
        self._listeners: List[Callable[[SpanEvent], None]] = []

    def now_us(self) -> float:
        """This tracer's epoch-anchored clock (us) — the timebase of every
        recorded event and of the trace context stamped into messages."""
        return self._epoch_us + (time.perf_counter_ns() - self._anchor_ns) / 1e3

    # -- nesting stack (per thread, parent attribution) --
    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, s: Span) -> None:
        st = self._stack()
        if st:
            s.attrs.setdefault("parent", st[-1].name)
        s.attrs.setdefault("depth", len(st))
        st.append(s)

    def _pop(self, s: Span) -> None:
        st = self._stack()
        if st and st[-1] is s:
            st.pop()
        elif s in st:  # mis-nested exit — drop it and everything above
            del st[st.index(s):]

    def current_span(self) -> Optional[Span]:
        """The innermost open context-manager span on the calling thread."""
        st = getattr(self._local, "stack", None)
        return st[-1] if st else None

    # -- recording --
    def record_event(self, name: str, ts_us: float, dur_us: float = 0.0, **attrs) -> SpanEvent:
        """Record a pre-timed event directly (no Span handle)."""
        ev = SpanEvent(str(name), float(ts_us), float(dur_us), os.getpid(),
                       threading.get_ident(), attrs)
        self._record(ev)
        return ev

    def _record(self, ev: SpanEvent) -> None:
        with self._lock:
            if len(self._events) < self.max_events:
                self._events.append(ev)
            else:
                self.dropped += 1
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(ev)
            except Exception:  # noqa: BLE001 — a listener must never break training
                logging.exception("telemetry span listener failed")

    # -- public API --
    def span(self, name: str, **attrs) -> Span:
        """Context-manager span (nested via the calling thread's stack)."""
        return Span(self, name, attrs)

    def start_span(self, name: str, **attrs) -> Span:
        """Explicit-handle span for intervals that end on another thread."""
        return Span(self, name, attrs)

    def add_listener(self, fn: Callable[[SpanEvent], None]) -> None:
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[SpanEvent], None]) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def listeners(self) -> List[Callable[[SpanEvent], None]]:
        """Snapshot of the subscribed listeners."""
        with self._lock:
            return list(self._listeners)

    def events(self) -> List[SpanEvent]:
        with self._lock:
            return list(self._events)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0


_GLOBAL = Tracer()

from fedml_tpu_torch.telemetry.scope import current_scope  # noqa: E402 — after
# Tracer so scope.py's lazy constructor can import it (no cycle)


def get_tracer() -> Tracer:
    """The tracer for the calling thread: the active
    :class:`~fedml_tpu_torch.telemetry.scope.TelemetryScope`'s tracer when
    one is installed, else the process-wide tracer every single-run path
    records into."""
    sc = current_scope()
    return sc.tracer if sc is not None else _GLOBAL


def get_global_tracer() -> Tracer:
    """The process-wide tracer, regardless of any active scope."""
    return _GLOBAL
