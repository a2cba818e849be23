"""The client health registry, the metrics registry, the tracer's listeners
and the telemetry scope of the port against ``fedml_tpu``'s: both
registries are fed one replayed stream of train observations, fault events
and ``local_train`` spans (never a live run's wall-clock timings) and must
agree on every query, on the LRU spill and on the trace byte budget; the
Prometheus text of equal metric operations must be equal byte for byte.
The registries do their arithmetic in Python floats on both sides, so the
comparisons are exact."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import fedml_tpu.config as jcfg  # noqa: E402
from fedml_tpu.population import ActiveSet as JaxActiveSet  # noqa: E402
from fedml_tpu.population import BoundedLossMap as JaxBoundedLossMap  # noqa: E402
from fedml_tpu.population import SpilledRecord as JaxSpilledRecord  # noqa: E402
from fedml_tpu.telemetry import spans as jax_spans  # noqa: E402
from fedml_tpu.telemetry.health import ClientHealthRegistry as JaxHealth  # noqa: E402
from fedml_tpu.telemetry.metrics import MetricsRegistry as JaxMetrics  # noqa: E402
from fedml_tpu.telemetry.metrics import TenantedRegistryView as JaxTenanted  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.population import ActiveSet, BoundedLossMap, SpilledRecord  # noqa: E402
from fedml_tpu_torch.telemetry import (  # noqa: E402
    ClientHealthRegistry, MetricsRegistry, TelemetryScope, TenantedRegistryView, Tracer,
    get_global_registry, get_global_tracer, get_registry, get_tracer,
)

KINDS = ("dropout", "crash", "slowdown", "flaky")


def replay_stream(seed: int, clients: int = 14, events: int = 400, slow=(3, 7)):
    """A seeded stream of ("train", cid, round, wall_s), ("fault", cid,
    round, kind, detail) and ("span", cid, round, dur_us) events. Clients
    in ``slow`` train ~4× slower; some (client, round) pairs repeat (the
    span stream and the round trip seeing one train), and some spans carry
    no client (ignored by the registry)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(events):
        cid = int(rng.integers(0, clients))
        rnd = int(i // 6)
        base = 4.0 if cid in slow else 1.0
        wall = float(base * rng.uniform(0.05, 0.15))
        u = rng.uniform()
        if u < 0.45:
            out.append(("train", cid, rnd, wall))
        elif u < 0.8:
            out.append(("span", cid, rnd, wall * 1e6))
        elif u < 0.95:
            kind = KINDS[int(rng.integers(0, len(KINDS)))]
            out.append(("fault", cid, rnd, kind, float(rng.uniform(0, 2)) if kind == "slowdown" else 0.0))
        else:
            out.append(("span_no_client", cid, rnd, wall * 1e6))
        if rng.uniform() < 0.1:  # the same train seen twice
            out.append(("train", cid, rnd, wall * 1.5))
    return out


def feed(registry, tracer, stream):
    for ev in stream:
        kind = ev[0]
        if kind == "train":
            registry.observe_train(ev[1], ev[2], ev[3])
        elif kind == "fault":
            registry.observe_fault(ev[1], ev[2], ev[3], detail=ev[4])
        elif kind == "span":
            tracer.record_event("local_train", 0.0, ev[3], client=ev[1], round=ev[2])
        else:
            tracer.record_event("local_train", 0.0, ev[3], round=ev[2])
            tracer.record_event("aggregate", 0.0, ev[3], client=ev[1], round=ev[2])


def pair(seed=0, stream_kw=None, **kw):
    """(reference registry, port registry, reference metrics, port
    metrics) after the same replayed stream."""
    jm, tm = JaxMetrics(), MetricsRegistry()
    jr = JaxHealth(registry=jm, **kw).attach(jax_spans.Tracer())
    tr = ClientHealthRegistry(registry=tm, **kw).attach(Tracer())
    stream = replay_stream(seed, **(stream_kw or {}))
    feed(jr, jr._tracer, stream)
    feed(tr, tr._tracer, stream)
    return jr, tr, jm, tm


def assert_same_queries(jr, tr, clients=range(16)):
    assert tr.snapshot() == jr.snapshot()
    assert tr.straggler_ids() == jr.straggler_ids()
    assert tr.clients_seen() == jr.clients_seen()
    assert tr.known_client_count() == jr.known_client_count()
    assert tr.trace_incomplete == jr.trace_incomplete
    for c in clients:
        assert tr.mean_train_s(c) == jr.mean_train_s(c), c
        for q in (0.1, 0.5, 0.9, 1.0):
            assert tr.percentile_train_s(c, q) == jr.percentile_train_s(c, q), (c, q)
        assert tr.last_seen_round(c) == jr.last_seen_round(c), c
        assert tr.rounds_participated(c) == jr.rounds_participated(c), c
        assert tr.faults(c) == jr.faults(c), c
        assert tr.is_straggler(c) == jr.is_straggler(c), c
    for rounds in (None, 200):
        assert tr.export_trace(rounds).to_json() == jr.export_trace(rounds).to_json()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registries_agree_on_a_replayed_stream(seed):
    jr, tr, jm, tm = pair(seed)
    assert tr.straggler_ids(), "the stream's slow clients should be flagged"
    assert_same_queries(jr, tr)
    assert tm.render() == jm.render()


def test_spill_at_four_active_clients():
    """max_active_clients = 4: the LRU spill keeps the exact counters of
    the evicted clients and forgets their timing windows, as the
    reference's does."""
    jr, tr, jm, tm = pair(3, max_active_clients=4)
    assert len(tr._clients) == 4 and len(tr._clients.spilled) > 0
    assert sorted(tr._clients.spilled) == sorted(jr._clients.spilled)
    assert_same_queries(jr, tr)
    assert tm.render() == jm.render()


def test_trace_budget_marks_the_trace_incomplete():
    """A budget of 5 events: the fault tallies stay exact, the events past
    the budget are dropped and their clients exported trace_complete
    false."""
    jr, tr, jm, tm = pair(4, trace_budget_bytes=5 * 96)
    assert tr.trace_incomplete and jr.trace_incomplete
    assert len(tr._fault_log) == 5
    trace = tr.export_trace().to_json()
    assert any(not c["trace_complete"] for c in trace["clients"].values())
    assert_same_queries(jr, tr)
    assert tm.render() == jm.render()


def test_a_homogeneous_fleet_has_no_straggler():
    jr, tr, _, _ = pair(5, stream_kw={"slow": ()})
    assert tr.straggler_ids() == jr.straggler_ids() == []


def test_from_config_reads_the_population_bounds():
    import dataclasses

    pop = {"health_active_clients": 3, "health_trace_budget_bytes": 960}
    tconf = tcfg.RunConfig(population=dataclasses.replace(tcfg.RunConfig().population, **pop))
    jconf = jcfg.RunConfig(population=dataclasses.replace(jcfg.RunConfig().population, **pop))
    t, j = ClientHealthRegistry.from_config(tconf), JaxHealth.from_config(jconf)
    assert (t._clients.capacity, t.trace_budget_bytes) == (j._clients.capacity, j.trace_budget_bytes)
    assert (t._clients.capacity, t.trace_budget_bytes) == (3, 960)


def test_attach_is_idempotent_and_detach_stops_the_feed():
    tracer, other = Tracer(), Tracer()
    reg = ClientHealthRegistry(registry=MetricsRegistry())
    reg.attach(tracer).attach(tracer)
    assert len(tracer.listeners()) == 1
    reg.attach(other)  # switching tracers detaches from the first
    assert tracer.listeners() == [] and len(other.listeners()) == 1
    other.record_event("local_train", 0.0, 2e5, client=1, round=0)
    reg.detach()
    other.record_event("local_train", 0.0, 2e5, client=1, round=1)
    assert reg.rounds_participated(1) == 1 and other.listeners() == []


def test_a_failing_listener_never_breaks_the_span():
    tracer, seen = Tracer(), []

    def bad(ev):
        raise RuntimeError("listener bug")

    tracer.add_listener(bad)
    tracer.add_listener(seen.append)
    with tracer.span("local_train", client=0, round=0):
        pass
    assert [e.name for e in tracer.events()] == ["local_train"]
    assert [e.name for e in seen] == ["local_train"]
    tracer.remove_listener(bad)
    assert tracer.listeners() == [seen.append]


def test_metrics_render_equals_the_reference_byte_for_byte():
    def drive(reg):
        c = reg.counter("fedml_x_total", "a counter", labelnames=("kind",))
        c.inc(kind="a")
        c.inc(2.5, kind='b"q\\n')
        g = reg.gauge("fedml_g", "a gauge")
        g.set(3.25)
        g.inc(-1.0)
        h = reg.histogram("fedml_h_seconds", "a histogram", labelnames=("op",),
                          buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.5, 5.0, 0.1):
            h.observe(v, op="send")
        h.observe(float("inf"), op="recv")
        assert reg.counter("fedml_x_total", "a counter", labelnames=("kind",)) is c
        with pytest.raises(ValueError):
            reg.gauge("fedml_x_total")
        return reg

    t, j = drive(MetricsRegistry()), drive(JaxMetrics())
    assert t.render() == j.render()
    tv, jv = TenantedRegistryView(base=t), JaxTenanted(base=j)
    for view, mk in ((tv, MetricsRegistry), (jv, JaxMetrics)):
        for name in ("b", "a"):
            view.add_tenant(name, drive(mk()), extra={"device": "gpu"})
    assert tv.render() == jv.render()
    assert tv.tenants() == ["a", "b"]


def test_active_set_and_loss_map_evict_as_the_reference():
    ops = np.random.default_rng(7).integers(0, 9, size=60)
    t = ActiveSet(3, spill_fn=lambda r: SpilledRecord(rounds_participated=r))
    j = JaxActiveSet(3, spill_fn=lambda r: JaxSpilledRecord(rounds_participated=r))
    tl, jl = BoundedLossMap(4), JaxBoundedLossMap(4)
    for i, cid in enumerate(ops):
        t.touch(int(cid), lambda sp: (sp.rounds_participated if sp else 0) + 1)
        j.touch(int(cid), lambda sp: (sp.rounds_participated if sp else 0) + 1)
        tl[int(cid)], jl[int(cid)] = float(i), float(i)
    assert list(t.items()) == list(j.items())
    assert {k: v.rounds_participated for k, v in t.spilled.items()} == \
           {k: v.rounds_participated for k, v in j.spilled.items()}
    assert list(tl.items()) == list(jl.items())


def test_scope_routes_the_tracer_and_registry_per_thread():
    import threading

    scope = TelemetryScope(tenant="a")
    assert get_tracer() is get_global_tracer() and get_registry() is get_global_registry()
    with scope.activate():
        assert get_tracer() is scope.tracer and get_registry() is scope.registry
        seen = []
        t = threading.Thread(target=lambda: seen.append(get_tracer()))
        t.start()
        t.join()
        assert seen == [get_global_tracer()]  # threads do not inherit a scope
        seen.clear()
        t = threading.Thread(target=scope.wrap(lambda: seen.append(get_tracer())))
        t.start()
        t.join()
        assert seen == [scope.tracer]
    assert get_tracer() is get_global_tracer()
