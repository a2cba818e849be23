"""The straggler-aware policy and the health registries that feed it, against
``fedml_tpu``: over one replayed registry the policy picks the reference's
cohorts round for round, with and without the top-up from the flagged set;
the simulator's ``FedAvgAPI.health`` and the sync server's
``FedAvgServerManager.health`` are reachable and fed once per (client,
round)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import fedml_tpu.config as jcfg  # noqa: E402
from fedml_tpu.algorithms import FedAvgAPI as JaxFedAvg  # noqa: E402
from fedml_tpu.data.synthetic import synthetic_classification as jax_synthetic  # noqa: E402
from fedml_tpu.scheduler import ClientScheduler as JaxScheduler  # noqa: E402
from fedml_tpu.scheduler.policies import SelectionContext as JaxContext  # noqa: E402
from fedml_tpu.scheduler.policies import StragglerAwarePolicy as JaxPolicy  # noqa: E402
from fedml_tpu.telemetry.health import ClientHealthRegistry as JaxHealth  # noqa: E402
from fedml_tpu.telemetry.metrics import MetricsRegistry as JaxMetrics  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.algorithms import FedAvgAPI  # noqa: E402
from fedml_tpu_torch.algorithms.fedavg_transport import run_loopback_federation  # noqa: E402
from fedml_tpu_torch.data.synthetic import synthetic_classification  # noqa: E402
from fedml_tpu_torch.scheduler import ClientScheduler, StragglerAwarePolicy  # noqa: E402
from fedml_tpu_torch.scheduler.policies import SelectionContext  # noqa: E402
from fedml_tpu_torch.telemetry import ClientHealthRegistry, MetricsRegistry  # noqa: E402

from torch_parity import (  # noqa: E402
    LR, jax_lr_model, lr_config, lr_data, private_reference_programs, time_limit, torch_lr_model,
)

N = 20
SLOW = (2, 5, 11, 17)


def _registries():
    return (JaxHealth(registry=JaxMetrics(), window=8),
            ClientHealthRegistry(registry=MetricsRegistry(), window=8))


def _observe(regs, rng, round_idx, clients):
    """One round's train times: the SLOW clients ~5× the rest; a second
    client of the slow set joins them from round 8 on (the flagged set
    changes over the run)."""
    slow = SLOW + ((8,) if round_idx >= 8 else ())
    for c in clients:
        wall = float((5.0 if c in slow else 1.0) * rng.uniform(0.8, 1.2))
        for reg in regs:
            reg.observe_train(int(c), round_idx, wall)


@pytest.mark.parametrize("k", [6, 19], ids=["fast_only", "topped_up"])
def test_cohorts_match_the_reference_over_a_replayed_registry(k):
    """20 rounds: each round both policies select from registries fed the
    same observations of the clients selected so far (plus a warm-up of
    every client); k = 19 leaves fewer fast clients than k once two are
    flagged (the slowest decile of 20), so the cohort tops up from the
    flagged set, slowest last."""
    jreg, treg = _registries()
    rng = np.random.default_rng(11)
    _observe((jreg, treg), rng, -1, range(N))
    jctx = JaxContext(seed=5, num_clients=N, health=jreg)
    tctx = SelectionContext(seed=5, num_clients=N, health=treg)
    topped = flagged_rounds = 0
    for r in range(20):
        want = JaxPolicy().select(r, k, jctx)
        got = StragglerAwarePolicy().select(r, k, tctx)
        assert got.tolist() == np.asarray(want).tolist(), r
        flagged = treg.straggler_ids()
        assert flagged == jreg.straggler_ids()
        flagged_rounds += bool(flagged)
        if N - len(flagged) >= k:
            assert not set(got.tolist()) & set(flagged), r
        else:
            topped += 1
            assert set(range(N)) - set(flagged) <= set(got.tolist()), r
            assert len(got) == k
        _observe((jreg, treg), rng, r, got.tolist())
    assert flagged_rounds == 20 and (topped > 0) == (k == 19)


def test_the_schedulers_draw_the_reference_cohorts():
    """ClientScheduler.from_config with selection straggler_aware, each
    over its package's registry fed one stream, memoized per round."""
    jreg, treg = _registries()
    rng = np.random.default_rng(3)
    _observe((jreg, treg), rng, -1, range(N))
    fed = dict(selection="straggler_aware", client_num_in_total=N, client_num_per_round=7)
    jconf = jcfg.RunConfig(fed=dataclasses.replace(jcfg.RunConfig().fed, **fed), seed=9)
    tconf = tcfg.RunConfig(fed=dataclasses.replace(tcfg.RunConfig().fed, **fed), seed=9)
    js = JaxScheduler.from_config(jconf, num_clients=N, health=jreg)
    ts = ClientScheduler.from_config(tconf, num_clients=N, health=treg)
    for r in range(10):
        got, want = ts.select(r), js.select(r)
        assert got.tolist() == np.asarray(want).tolist()
        assert ts.select(r) is got  # memoized
        _observe((jreg, treg), rng, r, got.tolist())
    assert ts.selections() == js.selections()
    # explicit k past the memo (FedBuff's one-client dispatches)
    ts1 = ClientScheduler.from_config(tconf, num_clients=N, health=treg, memoize=False)
    js1 = JaxScheduler.from_config(jconf, num_clients=N, health=jreg, memoize=False)
    assert [ts1.select(c, k=1).tolist() for c in range(6)] == \
           [np.asarray(js1.select(c, k=1)).tolist() for c in range(6)]


def test_no_registry_is_a_seeded_uniform_draw():
    jctx, tctx = JaxContext(seed=1, num_clients=N), SelectionContext(seed=1, num_clients=N)
    for r in range(5):
        assert StragglerAwarePolicy().select(r, 5, tctx).tolist() == \
               np.asarray(JaxPolicy().select(r, 5, jctx)).tolist()


def test_simulator_health_is_fed_as_the_reference_s(tmp_path):
    """FedAvgAPI on the logistic-regression fixture (every client every
    round) under straggler_aware: the cohorts and each client's
    participation and last-seen round equal the reference simulator's."""
    fed = {"selection": "straggler_aware"}
    jconf = lr_config(jcfg, {"lr": 0.1})
    tconf = lr_config(tcfg, {"lr": 0.1})
    jconf = jconf.replace(fed=dataclasses.replace(jconf.fed, **fed))
    tconf = tconf.replace(fed=dataclasses.replace(tconf.fed, **fed))
    with private_reference_programs(tmp_path):
        japi = JaxFedAvg(jconf, lr_data(jax_synthetic), jax_lr_model())
        japi.train()
    tapi = FedAvgAPI(tconf, lr_data(synthetic_classification), torch_lr_model(), device="cpu")
    tapi.train()
    assert tapi.scheduler.selections() == japi.scheduler.selections()
    for c in range(LR["num_clients"]):
        assert tapi.health.rounds_participated(c) == japi.health.rounds_participated(c) == LR["rounds"]
        assert tapi.health.last_seen_round(c) == japi.health.last_seen_round(c) == LR["rounds"] - 1
    assert tapi.health.known_client_count() == LR["num_clients"]


@time_limit(60)
def test_sync_server_health_is_reachable_and_fed_once_per_round():
    """The loopback federation's server registry: each upload is seen by
    the client's local_train span AND the server's round trip, and the
    (client, round) dedupe counts it once. A fault plan's events land in
    the same registry."""
    plan = '{"seed": 2, "default": {"slowdown_s": 0.01}}'
    tconf = lr_config(tcfg, {"lr": 0.1})
    tconf = tconf.replace(fed=dataclasses.replace(tconf.fed, selection="straggler_aware",
                                                  fault_plan=plan))
    rows = []
    server = run_loopback_federation(tconf, lr_data(synthetic_classification), torch_lr_model(),
                                     device="cpu", log_fn=rows.append)
    health = server.health
    assert health.known_client_count() == LR["num_clients"]
    for c in range(LR["num_clients"]):
        assert health.rounds_participated(c) == LR["rounds"]
        assert health.faults(c) == {"slowdown": LR["rounds"]}
        assert health.mean_train_s(c) is not None
    assert server._tracer.listeners().count(health._on_span) == 0  # detached at finish
    assert rows[-1]["faults/slowdowns"] == LR["num_clients"] * LR["rounds"]
