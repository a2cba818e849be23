"""FedBuff, the async buffered federation (fedml_tpu_torch/algorithms/
fedbuff.py), against ``fedml_tpu``'s.

- The buffer step and the staleness discount against the reference's on
  numpy-seeded trees (atol 1e-6: the float32 pow and the order of the
  weighted sum differ), and the fresh-buffer oracle against the port's
  FedAvg average.
- One worker with k = 1 over loopback is the protocol's fixed arrival
  order (every delta at staleness 0, the dispatch tags as shuffle seeds):
  the whole run against the reference's, params within 1e-5, the rows but
  ``t_s``, ``staleness_seen`` and the dispatch stream's client ids exactly.
- With more workers the arrival order is the threads', so the runs hold the
  invariants: every step flushed k deltas, the model learns.
- The protocol's failure cases of tests/test_fedbuff.py on the port's
  managers, the elastic fleet (join/leave, max_workers), request_stop
  (drain and discard), the checkpoint state and the command line.

Every test that starts a federation runs under ``time_limit`` with a short
orphan deadline."""

import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import fedml_tpu.config as jcfg  # noqa: E402
from fedml_tpu.algorithms import fedbuff as jfb  # noqa: E402
from fedml_tpu.data.synthetic import synthetic_classification as jax_synthetic  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch import cli  # noqa: E402
from fedml_tpu_torch.algorithms import fedbuff as fb  # noqa: E402
from fedml_tpu_torch.algorithms.fedavg import weighted_average  # noqa: E402
from fedml_tpu_torch.algorithms.fedavg_transport import LocalTrainer  # noqa: E402
from fedml_tpu_torch.bridge import from_flax, to_flax_variables  # noqa: E402
from fedml_tpu_torch.core.loopback import LoopbackCommManager, LoopbackHub  # noqa: E402
from fedml_tpu_torch.core.message import Message, MessageType as MT  # noqa: E402
from fedml_tpu_torch.data.synthetic import synthetic_classification  # noqa: E402
from fedml_tpu_torch.models import create_model  # noqa: E402

from torch_parity import (  # noqa: E402
    LR, free_port_block, jax_lr_model, jax_transport_perm_fn, lr_data, private_reference_programs,
    reference_record, time_limit, torch_lr_model,
)

ORPHAN_S = 20.0


def _cfg(cfg_mod, comm_round, k, workers, total, batch_size=16, freq=5, **fed):
    return cfg_mod.RunConfig(
        data=cfg_mod.DataConfig(batch_size=batch_size),
        fed=cfg_mod.FedConfig(client_num_in_total=total, client_num_per_round=workers,
                              comm_round=comm_round, epochs=1, frequency_of_the_test=freq,
                              async_buffer_k=k, **fed),
        train=cfg_mod.TrainConfig(client_optimizer="sgd", lr=0.1),
        seed=0,
    )


def _small(seed=1, clients=8, classes=3, feat=8):
    data = synthetic_classification(num_clients=clients, num_classes=classes, feat_shape=(feat,),
                                    samples_per_client=24, partition_method="homo", seed=seed)
    return data, create_model("lr", "synthetic", (feat,), classes)


def _run(runner, cfg, data, model, **kw):
    return runner(cfg, data, model, device="cpu", orphan_deadline_s=ORPHAN_S, **kw)


# -- the buffer step --------------------------------------------------------

def _tree(rng, scale=1.0):
    """Port variables and the same values in the reference's layout."""
    port = {"dense.weight": torch.from_numpy((scale * rng.normal(size=(4, 3))).astype(np.float32)),
            "dense.bias": torch.from_numpy((scale * rng.normal(size=(4,))).astype(np.float32)),
            "conv.weight": torch.from_numpy((scale * rng.normal(size=(5, 2, 3, 3))).astype(np.float32))}
    return port, to_flax_variables(port)


def test_staleness_weight_matches_the_reference():
    tau = np.arange(12)
    for exp in (0.0, 0.5, 1.0, 2.0):
        got = fb.staleness_weight(tau, exp).numpy()
        want = np.asarray(jfb.staleness_weight(tau, exp))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        assert got.dtype == np.float32 and got[0] == 1.0
        assert exp == 0.0 or np.all(np.diff(got) < 0)


@pytest.mark.parametrize("taus,eta,exp", [([0, 0, 0, 0], 1.0, 0.5), ([0, 3, 1, 9, 2], 0.7, 0.5),
                                          ([5, 0, 2], 1.3, 1.0)])
def test_buffered_update_matches_the_reference(taus, eta, exp):
    rng = np.random.default_rng(len(taus))
    g, gj = _tree(rng)
    deltas = [_tree(rng, 0.1) for _ in taus]
    got = to_flax_variables(fb.apply_buffered_update(g, [d for d, _ in deltas], taus, eta, exp))
    want = jfb.apply_buffered_update(gj, [d for _, d in deltas], taus, eta, exp)
    for layer in want["params"]:
        for leaf in want["params"][layer]:
            np.testing.assert_allclose(got["params"][layer][leaf],
                                       np.asarray(want["params"][layer][leaf]),
                                       rtol=0, atol=1e-6, err_msg=f"{layer}/{leaf}")


def test_a_fresh_buffer_is_the_fedavg_average():
    """Every delta at staleness 0, eta_g 1, equal shards: one buffered step
    equals FedAvg's average of the k local models."""
    rng = np.random.default_rng(0)
    g, _ = _tree(rng)
    local = [_tree(rng)[0] for _ in range(4)]
    deltas = [{k: w[k] - g[k] for k in g} for w in local]
    got = fb.apply_buffered_update(g, deltas, [0] * 4, 1.0, 0.5)
    want = weighted_average({k: torch.stack([w[k] for w in local]) for k in g}, torch.ones(4))
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6)
    # a stale delta moves the model less than a fresh one
    big, small = {k: torch.ones_like(v) for k, v in g.items()}, {k: -torch.ones_like(v) for k, v in g.items()}
    zero = {k: torch.zeros_like(v) for k, v in g.items()}
    assert all(v.abs().max() < 1e-6 for v in fb.apply_buffered_update(zero, [big, small], [0, 0], 1.0, 1.0).values())
    assert all(v.min() > 0.5 for v in fb.apply_buffered_update(zero, [big, small], [0, 9], 1.0, 1.0).values())


# -- the fixed arrival order against the reference -------------------------

K1 = dict(comm_round=6, k=1, workers=1, total=LR["num_clients"], batch_size=-1, freq=3)


def _record_dispatches(monkeypatch, cls, out):
    orig = cls._next_client_index

    def wrapped(self):
        idx = orig(self)
        out.append(int(idx))
        return idx

    monkeypatch.setattr(cls, "_next_client_index", wrapped)


def _reference_k1(tmp_path):
    def run():
        mp, ids = pytest.MonkeyPatch(), []
        _record_dispatches(mp, jfb.FedBuffServerManager, ids)
        try:
            with private_reference_programs(tmp_path):
                server = jfb.run_fedbuff_loopback(_cfg(jcfg, **K1), lr_data(jax_synthetic),
                                                  jax_lr_model())
        finally:
            mp.undo()
        init = jax_lr_model().init(jax.random.fold_in(jax.random.PRNGKey(0), 0))
        return dict(init=jax.device_get(init), global_vars=jax.device_get(server.global_vars),
                    history=server.history, staleness_seen=server.staleness_seen, ids=ids)

    return reference_record("fedbuff_loopback_k1", K1, run)


@time_limit(120)
def test_one_worker_k1_matches_the_reference(tmp_path, monkeypatch):
    ref = _reference_k1(tmp_path)
    ids = []
    _record_dispatches(monkeypatch, fb.FedBuffServerManager, ids)
    cfg = _cfg(tcfg, **K1)
    data = lr_data(synthetic_classification)
    model = torch_lr_model()
    server = _run(
        fb.run_fedbuff_loopback, cfg, data, model, init_vars=from_flax(ref.init),
        trainer_factory=lambda rank: LocalTrainer(cfg, data, model, device="cpu",
                                                  perm_fn=jax_transport_perm_fn(0)),
    )
    got = to_flax_variables(server.global_vars)["params"]
    for layer, leaves in ref.global_vars["params"].items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(got[layer][leaf], want, rtol=0, atol=1e-5,
                                       err_msg=f"{layer}/{leaf}")
    assert server.staleness_seen == ref.staleness_seen == [0] * K1["comm_round"]
    assert ids == ref.ids and len(ids) >= K1["comm_round"]
    assert len(server.history) == len(ref.history) == K1["comm_round"]
    for trow, jrow in zip(server.history, ref.history):
        assert trow.keys() == jrow.keys()
        for k in jrow:
            if k in ("Test/Loss", "Test/Acc"):
                assert abs(trow[k] - jrow[k]) <= 1e-5, (k, trow, jrow)
            elif k != "t_s":
                assert trow[k] == jrow[k], (k, trow, jrow)


# -- live federations hold the invariants -----------------------------------

@time_limit(120)
def test_four_workers_k2_learn():
    data = synthetic_classification(num_clients=12, num_classes=4, feat_shape=(16,),
                                    samples_per_client=48, partition_method="homo", seed=0)
    model = create_model("lr", "synthetic", (16,), 4)
    rows = []
    server = _run(fb.run_fedbuff_loopback, _cfg(tcfg, 25, 2, 4, 12), data, model, log_fn=rows.append)
    assert server.server_steps == server.version == 25
    assert len(server.staleness_seen) == 50  # every flush buffered k deltas
    accs = [r["Test/Acc"] for r in server.history if "Test/Acc" in r]
    assert accs and accs[-1] > 0.8, accs
    final = [r for r in rows if r.get("async_final")]
    assert len(final) == 1 and sum(final[0]["staleness_hist"].values()) == 50
    # the health registry saw every buffered upload once (the span and the
    # round trip of one assignment collapse), and at most one train a
    # worker past the last step
    seen = sum(server.health.rounds_participated(c) for c in range(12))
    assert 50 <= seen <= 50 + 4


@time_limit(120)
@pytest.mark.parametrize("runtime", ["shm", "mqtt", "grpc"])
def test_federations_complete_over_each_transport(runtime):
    data, model = _small()
    cfg = _cfg(tcfg, 6, 2, 3, 8)
    if runtime == "grpc":
        pytest.importorskip("grpc")
        from fedml_tpu_torch.core.grpc_comm import GrpcCommManager

        base = free_port_block(4)
        ips = {r: "127.0.0.1" for r in range(4)}
        server = fb.run_fedbuff_federation(
            cfg, data, model, lambda rank: GrpcCommManager(rank, ips, base_port=base,
                                                           bind_host="127.0.0.1"),
            device="cpu", orphan_deadline_s=ORPHAN_S,
        )
    else:
        runner = {"shm": fb.run_fedbuff_shm, "mqtt": fb.run_fedbuff_mqtt}[runtime]
        server = _run(runner, cfg, data, model)
    assert server.server_steps == 6
    assert len(server.staleness_seen) == 12
    assert [r for r in server.history if "Test/Acc" in r]


@time_limit(120)
def test_a_fault_plan_declines_and_dedupes():
    """dropout 0.2 and flaky 0.1: declined assignments are re-dispatched,
    the flaky second copies are dropped by the tag dedupe exactly as often
    as the injector recorded them, and the run completes its steps."""
    data, model = _small()
    plan = '{"seed": 3, "default": {"dropout_p": 0.2, "flaky_upload_p": 0.1}}'
    rows = []
    server = _run(fb.run_fedbuff_loopback, _cfg(tcfg, 10, 2, 3, 8, fault_plan=plan), data, model,
                  log_fn=rows.append)
    assert server.server_steps == 10 and len(server.staleness_seen) == 20
    summary = rows[-1]
    assert summary["faults/dropouts"] > 0 and summary["faults/flaky_uploads"] > 0
    faults = {}
    for c in range(8):
        for kind, n in server.health.faults(c).items():
            faults[kind] = faults.get(kind, 0) + n
    assert faults.get("dropout", 0) == summary["faults/dropouts"]
    assert faults.get("flaky", 0) == summary["faults/flaky_uploads"]


@time_limit(60)
def test_a_starving_plan_raises():
    data, model = _small()
    plan = '{"default": {"dropout_p": 1.0}}'
    with pytest.raises(RuntimeError, match="starved the delta buffer"):
        _run(fb.run_fedbuff_loopback, _cfg(tcfg, 3, 2, 2, 8, fault_plan=plan), data, model)


# -- the protocol's failure cases (tests/test_fedbuff.py) --------------------

def _managers(cfg, data, model, workers, hub=None):
    hub = hub or LoopbackHub()
    server = fb.FedBuffServerManager(cfg, LoopbackCommManager(hub, 0), model, data=data,
                                     worker_num=workers, device="cpu")
    clients = [fb.FedBuffClientManager(cfg, LoopbackCommManager(hub, r), r,
                                       LocalTrainer(cfg, data, model, device="cpu"),
                                       orphan_deadline_s=ORPHAN_S)
               for r in range(1, workers + 1)]
    return hub, server, clients


@time_limit(120)
def test_a_dead_worker_does_not_stall_the_server():
    data, model = _small()
    _, server, clients = _managers(_cfg(tcfg, 8, 2, 4, 8), data, model, 4)
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    server.send_init_msg()
    killer = threading.Timer(0.2, clients[0].finish)
    killer.start()
    done = threading.Thread(target=server.run, daemon=True)
    done.start()
    done.join(timeout=100)
    assert not done.is_alive(), "async server stalled after a worker died"
    assert server.server_steps == 8
    for c in clients:
        c.finish()
    killer.cancel()
    for t in threads:
        t.join(timeout=10)


def _dispatch_msg(model, tag=1, client=0, base=0):
    msg = Message(MT.S2C_INIT_CONFIG, 0, 1)
    msg.add_params(MT.ARG_MODEL_PARAMS, to_flax_variables(model.init(torch.Generator().manual_seed(0))))
    msg.add_params(MT.ARG_CLIENT_INDEX, client)
    msg.add_params(MT.ARG_BASE_VERSION, base)
    msg.add_params(MT.ARG_ROUND_IDX, tag)
    return msg


@time_limit(60)
def test_an_orphaned_worker_exits():
    """Uploads undeliverable and no FINISH: the worker exits as orphaned
    within its deadline instead of parking on its inbox."""
    data, model = _small(clients=2, classes=2, feat=4)
    hub = LoopbackHub()

    class DeadServerComm(LoopbackCommManager):
        def _send(self, msg):
            if msg.get_receiver_id() == 0:
                raise ConnectionError("server gone")
            super()._send(msg)

    cfg = _cfg(tcfg, 2, 1, 1, 2)
    client = fb.FedBuffClientManager(cfg, DeadServerComm(hub, 1), 1,
                                     LocalTrainer(cfg, data, model, device="cpu"),
                                     orphan_deadline_s=0.5)
    hub.deliver(_dispatch_msg(model))
    t = threading.Thread(target=client.run, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "orphaned worker failed to exit"
    assert client.orphaned


def _upload(server, tag, sender=1, base=0):
    up = Message(MT.C2S_SEND_MODEL, sender, 0)
    up.add_params(MT.ARG_ASYNC_DELTA, to_flax_variables({k: torch.zeros_like(v)
                                                         for k, v in server.global_vars.items()}))
    up.add_params(MT.ARG_NUM_SAMPLES, 8)
    up.add_params(MT.ARG_BASE_VERSION, base)
    up.add_params(MT.ARG_ROUND_IDX, tag)
    server._on_delta_from_client(up)


def test_the_server_drops_a_duplicate_upload():
    data, model = _small(clients=4, classes=2, feat=4)
    server = fb.FedBuffServerManager(_cfg(tcfg, 5, 3, 2, 4), LoopbackCommManager(LoopbackHub(), 0),
                                     model, data=data, worker_num=2, device="cpu")
    _upload(server, 7)
    _upload(server, 7)  # the retry's duplicate
    assert len(server._buffer) == 1
    _upload(server, 9)  # a new assignment from the same worker
    assert len(server._buffer) == 2


def test_a_duplicate_is_answered_with_the_same_assignment():
    """The reply to a duplicate restates the worker's one outstanding
    assignment (same tag, same client), never a new one; the re-upload of
    that assignment is accepted once and answered with a new one."""
    _, model = _small(clients=4, classes=2, feat=4)
    server = fb.FedBuffServerManager(_cfg(tcfg, 5, 3, 2, 4), LoopbackCommManager(LoopbackHub(), 0),
                                     model, worker_num=2, device="cpu")
    sent = []
    server.send_message = sent.append
    _upload(server, 7)
    assert len(sent) == 1
    fresh_tag, fresh_client = sent[0].get(MT.ARG_ROUND_IDX), sent[0].get(MT.ARG_CLIENT_INDEX)
    for _ in range(3):
        _upload(server, 7)
    assert len(sent) == 4
    assert all(m.get(MT.ARG_ROUND_IDX) == fresh_tag and m.get(MT.ARG_CLIENT_INDEX) == fresh_client
               for m in sent[1:])
    _upload(server, fresh_tag)
    assert len(server._buffer) == 2 and sent[-1].get(MT.ARG_ROUND_IDX) != fresh_tag


def test_a_worker_ignores_a_restated_assignment_it_handled():
    data, model = _small(clients=2, classes=2, feat=4)
    cfg = _cfg(tcfg, 2, 1, 1, 2)
    client = fb.FedBuffClientManager(cfg, LoopbackCommManager(LoopbackHub(), 1), 1,
                                     LocalTrainer(cfg, data, model, device="cpu"),
                                     orphan_deadline_s=ORPHAN_S)
    sent = []
    client.send_message = sent.append
    client._on_model(_dispatch_msg(model, tag=4))
    client._on_model(_dispatch_msg(model, tag=4))  # restated
    assert len(sent) == 1 and sent[0].get(MT.ARG_ROUND_IDX) == 4
    client._on_model(_dispatch_msg(model, tag=6))
    assert len(sent) == 2
    client.finish()


def test_declines_dedupe_and_restate():
    _, model = _small(clients=4, classes=2, feat=4)
    server = fb.FedBuffServerManager(_cfg(tcfg, 5, 3, 2, 4), LoopbackCommManager(LoopbackHub(), 0),
                                     model, worker_num=2, device="cpu")
    sent = []
    server.send_message = sent.append
    decline = Message(MT.C2S_SEND_MODEL, 1, 0)
    decline.add_params(MT.ARG_DECLINED, True)
    decline.add_params(MT.ARG_ROUND_IDX, 3)
    server._on_delta_from_client(decline)
    server._on_delta_from_client(decline)  # duplicate decline
    assert len(sent) == 2 and sent[0].get(MT.ARG_ROUND_IDX) == sent[1].get(MT.ARG_ROUND_IDX)
    assert server._decline_streak == 1 and not server._buffer


def test_buffer_k_must_be_positive():
    data, model = _small(clients=4, classes=2)
    with pytest.raises(ValueError, match="async_buffer_k"):
        fb.FedBuffServerManager(_cfg(tcfg, 1, 0, 2, 4), LoopbackCommManager(LoopbackHub(), 0),
                                model, data=data, device="cpu")


# -- the elastic fleet, the graceful stop, the checkpoint state -------------

def test_join_leave_and_max_workers():
    _, model = _small(clients=4, classes=2, feat=4)
    server = fb.FedBuffServerManager(_cfg(tcfg, 5, 2, 2, 4), LoopbackCommManager(LoopbackHub(), 0),
                                     model, worker_num=2, max_workers=3, device="cpu")
    sent = []
    server.send_message = sent.append

    def msg(kind, sender):
        m = Message(kind, sender, 0)
        m.add_params(MT.ARG_ROUND_IDX, 0)
        return m

    server._on_join(msg(MT.C2S_JOIN, 3))  # admitted: the third live worker
    assert server.joins_accepted == 1 and sent[-1].get_type() == MT.S2C_SYNC_MODEL
    server._on_join(msg(MT.C2S_JOIN, 4))  # refused at the door
    assert server.joins_refused == 1 and sent[-1].get_type() == MT.FINISH and 4 in server._dead_workers
    server._on_leave(msg(MT.C2S_LEAVE, 2))
    server._on_leave(msg(MT.C2S_LEAVE, 2))  # duplicate LEAVE
    assert server.leaves == 1 and 2 not in server._outstanding
    server._on_join(msg(MT.C2S_JOIN, 5))  # a leave freed a slot
    assert server.joins_accepted == 2 and server._live_worker_count() == 3


@pytest.mark.parametrize("drain", [True, False])
def test_request_stop_drains_or_discards(drain):
    _, model = _small(clients=4, classes=2, feat=4)
    server = fb.FedBuffServerManager(_cfg(tcfg, 5, 3, 2, 4), LoopbackCommManager(LoopbackHub(), 0),
                                     model, worker_num=2, device="cpu")
    server.send_message = lambda m: None
    _upload(server, 7)
    assert len(server._buffer) == 1
    server.request_stop(drain=drain)
    # drained: one last partial step; discarded: the buffer is never applied
    assert server._finished and server.server_steps == (1 if drain else 0)
    assert len(server._buffer) == (0 if drain else 1)
    # deferred: the next upload applies it
    server = fb.FedBuffServerManager(_cfg(tcfg, 5, 3, 2, 4), LoopbackCommManager(LoopbackHub(), 0),
                                     model, worker_num=2, device="cpu")
    server.send_message = lambda m: None
    server.request_stop(drain=drain, defer=True)
    assert not server._finished
    _upload(server, 7)
    assert server._finished and server.server_steps == (1 if drain else 0)


def test_checkpoint_state_round_trips():
    _, model = _small(clients=4, classes=2, feat=4)
    cfg = _cfg(tcfg, 5, 1, 2, 4)
    a = fb.FedBuffServerManager(cfg, LoopbackCommManager(LoopbackHub(), 0), model, worker_num=2,
                                device="cpu")
    sent = []
    a.send_message = sent.append
    for tag in (7, 9, 11):
        _upload(a, tag)
    state = a.checkpoint_state()
    assert {k: int(v) for k, v in state.items()} == {"version": 3, "server_steps": 3,
                                                       "dispatch_counter": 3}
    b = fb.FedBuffServerManager(cfg, LoopbackCommManager(LoopbackHub(), 0), model, worker_num=2,
                                device="cpu")
    b.restore_state(state)
    mine = []
    b.send_message = mine.append
    a._dispatch(1)
    b._dispatch(1)
    # the dispatch stream is pure in (seed, counter): the same next assignment
    assert mine[0].get(MT.ARG_CLIENT_INDEX) == sent[-1].get(MT.ARG_CLIENT_INDEX)
    assert mine[0].get(MT.ARG_ROUND_IDX) == sent[-1].get(MT.ARG_ROUND_IDX)
    assert b.version == 3


# -- the command line ---------------------------------------------------------

@time_limit(120)
def test_cli_runs_fedbuff_and_refuses_a_sync_runtime(tmp_path, capsys):
    import json

    args = ["--algorithm", "fedbuff", "--dataset", "synthetic", "--model", "lr",
            "--client_num_in_total", "6", "--client_num_per_round", "3", "--comm_round", "4",
            "--batch_size", "8", "--async_buffer_k", "2", "--lr", "0.1", "--log_dir", str(tmp_path)]
    api = cli.main(args + ["--runtime", "loopback"], device="cpu")
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["server_step"] == 4 and "staleness_mean" in row
    assert api.health.known_client_count() > 0 and api.global_vars is not None
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["server_steps"] == 4 and "staleness_hist" in summary
    with pytest.raises(SystemExit) as e:
        cli.main(args + ["--runtime", "vmap"], device="cpu")
    assert e.value.code == 2
    assert "loopback" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        cli.main(args[:-2] + ["--runtime", "loopback", "--async_buffer_k", "0"], device="cpu")
    assert e.value.code == 2
