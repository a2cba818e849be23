"""The split and vertical federations over the port's loopback transport
(fedml_tpu_torch/splitfed/split_transport.py, vfl_transport.py, codec.py)
on the CPU.

The transports are held to the port's own fused simulators, bit for bit
(the reference's transports are not run here: its split transport test
hangs on a warm executable store); the fused simulators are held to the
reference's in tests/test_torch_split_nn.py and test_torch_vertical_fl.py.
The activation codec is held to the reference's codec byte for byte. Each
federation runs under ``time_limit`` and joins its actor threads with a
timeout (``run_loopback_*`` raise if one outlives it). The fused
simulators run in a thread of their own, as the actors do: a new thread's
OpenMP team is the runtime's default whatever the main thread set, and a
convolution's CPU reductions split by team size. The compressed run's
bound is the reference test's (tests/test_splitfed.py): int8 with error
feedback stays within 0.15 of max(1, |param|) of the exact run."""

import threading

import numpy as np
import pytest
import torch

from fedml_tpu_torch.algorithms.split_nn import SplitNNAPI, default_split_models
from fedml_tpu_torch.algorithms.vertical_fl import VFLAPI
from fedml_tpu_torch.config import CommConfig, DataConfig, FedConfig, RunConfig, TrainConfig
from fedml_tpu_torch.data.synthetic import synthetic_classification
from fedml_tpu_torch.scheduler import ClientScheduler, FaultInjector, FaultPlan
from fedml_tpu_torch.splitfed import ActivationCodec, run_loopback_splitnn, run_loopback_vfl
from fedml_tpu_torch.telemetry import get_comm_meter

from torch_parity import time_limit

JOIN_S = 30.0
SHAPES = {"flat": (10,), "image": (6, 6, 1)}


def _cfg(comm_round=2, workers=3, total=5, seed=11, comm=None):
    return RunConfig(
        data=DataConfig(batch_size=8),
        fed=FedConfig(client_num_in_total=total, client_num_per_round=workers,
                      comm_round=comm_round, epochs=1, frequency_of_the_test=100),
        train=TrainConfig(client_optimizer="sgd", lr=0.1, momentum=0.9, wd=5e-4),
        comm=comm or CommConfig(), seed=seed,
    )


def _data(shape=(10,), num_clients=5):
    return synthetic_classification(num_clients=num_clients, num_classes=3, feat_shape=shape,
                                    samples_per_client=24, partition_method="homo", seed=0)


def _split(cfg, data, **kw):
    return run_loopback_splitnn(cfg, data, device="cpu", **kw)


def _in_thread(fn):
    """``fn()`` in a fresh thread (the actors' OpenMP team), joined with a
    timeout."""
    out = []
    th = threading.Thread(target=lambda: out.append(fn()), daemon=True)
    th.start()
    th.join(timeout=JOIN_S)
    assert not th.is_alive() and out, "the simulator thread did not finish"
    return out[0]


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@time_limit(120)
@pytest.mark.parametrize("geometry", sorted(SHAPES))
def test_splitnn_transport_equals_the_fused_simulator_bitwise(geometry):
    cfg, data = _cfg(), _data(SHAPES[geometry])
    server = _split(cfg, data)
    assert server.round_idx == 2 and server.skipped_turns == 0
    assert [sorted(r) for r in server.history] == [
        ["Test/Acc", "Train/Loss", "round", "split/skipped_turns", "t_s"]] * 2
    bottom, top = default_split_models(tuple(data.client_x[0].shape[1:]), data.num_classes)
    # the ring orders the server draws: an identical scheduler's cohorts
    sched = ClientScheduler.from_config(cfg, num_clients=cfg.fed.client_num_in_total, data=data)

    def simulate():
        api = SplitNNAPI(bottom, top, lr=cfg.train.lr, momentum=cfg.train.momentum,
                         wd=cfg.train.wd, seed=cfg.seed, device="cpu")
        for r in range(cfg.fed.comm_round):
            cohort = sched.select(r, k=cfg.fed.client_num_per_round)
            api.train_ring([(data.client_x[c], data.client_y[c]) for c in cohort],
                           batch_size=cfg.data.batch_size, epochs_per_client=cfg.fed.epochs)
        return api

    api = _in_thread(simulate)
    _equal(server.global_vars["params"]["bottom"], api.bottom_vars)
    _equal(server.global_vars["params"]["top"], api.top_vars)
    assert server.history[-1]["Test/Acc"] == api.evaluate(data.test_x, data.test_y)


@time_limit(120)
def test_vfl_transport_equals_the_fused_simulator_bitwise():
    cfg = _cfg(workers=2, seed=4)
    rng = np.random.default_rng(9)
    xs = [rng.standard_normal((48, d)).astype(np.float32) for d in (4, 3, 3)]
    y = rng.integers(0, 2, size=48).astype(np.float32)
    guest, hosts = run_loopback_vfl(cfg, xs, y, device="cpu")
    api = VFLAPI(feature_splits=[4, 3, 3], lr=cfg.train.lr, seed=cfg.seed, device="cpu")
    stats = _in_thread(lambda: [api.train_epoch(xs, y, batch_size=cfg.data.batch_size)
                                for _ in range(cfg.fed.comm_round)])
    _equal(guest.params, api.params[0])
    for h, pp in zip(hosts, api.params[1:]):
        _equal(h.params, pp)
    assert len(guest.history) == cfg.fed.comm_round
    for row, s in zip(guest.history, stats):
        assert row["Train/Loss"] == s["loss"] and row["Train/Acc"] == s["acc"]


def _faulted(cfg, data, plan_json):
    rows = []
    server = _split(cfg, data, log_fn=rows.append, faults=FaultInjector(FaultPlan.from_json(plan_json)))
    return server, rows


@time_limit(120)
def test_faulted_boundary_round_recovers_deterministically():
    """A client crashed from round 0 declines every turn: the server relays
    the unchanged bottom past it, the round completes with the skip in its
    row, two faulted runs agree bit for bit, and the run differs from a
    clean one."""
    plan = {"clients": {"1": {"crash_at_round": 0}}}
    cfg, data = _cfg(comm_round=2, workers=3), _data()
    a, rows_a = _faulted(cfg, data, plan)
    b, _ = _faulted(cfg, data, plan)
    assert a.round_idx == 2 and a.skipped_turns > 0
    done = [r for r in rows_a if "t_s" in r]
    assert done and all("split/skipped_turns" in r for r in done)
    assert done[-1]["split/skipped_turns"] == a.skipped_turns == b.skipped_turns
    for half in ("bottom", "top"):
        _equal(a.global_vars["params"][half], b.global_vars["params"][half])
    _equal(a._server_opt_state[1][0].trace, b._server_opt_state[1][0].trace)
    clean, _ = _faulted(cfg, data, {})
    assert clean.skipped_turns == 0
    assert any(not torch.equal(a.global_vars["params"]["bottom"][k], v)
               for k, v in clean.global_vars["params"]["bottom"].items())


@time_limit(120)
def test_flaky_duplicate_done_is_deduped():
    """flaky_upload_p = 1 sends every DONE twice; the server's (round,
    worker) dedupe drops the copies, and the run equals the clean one."""
    cfg, data = _cfg(comm_round=2, workers=2), _data()
    flaky, _ = _faulted(cfg, data, {"default": {"flaky_upload_p": 1.0}})
    clean, _ = _faulted(cfg, data, {})
    assert flaky.dropped_boundary > 0
    for half in ("bottom", "top"):
        _equal(flaky.global_vars["params"][half], clean.global_vars["params"][half])


@pytest.mark.parametrize("error_feedback", [False, True])
@pytest.mark.parametrize("method", ["int8", "int4"])
def test_activation_codec_encodes_as_the_reference(method, error_feedback):
    """Three tensors on one stream (a shape change resets its residual):
    every payload byte-identical to the reference codec's, and the decodes
    equal."""
    from fedml_tpu.splitfed.codec import ActivationCodec as JaxCodec

    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((8, 12)).astype(np.float32) * 3,
              rng.standard_normal((8, 12)).astype(np.float32),
              rng.standard_normal((5, 12)).astype(np.float32)]
    port, ref = ActivationCodec(method, error_feedback), JaxCodec(method, error_feedback)
    for a in arrays:
        got, want = port.encode("up:1", a), ref.encode("up:1", a)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
        np.testing.assert_array_equal(ActivationCodec.decode(got, method),
                                      JaxCodec.decode(want, method))


@time_limit(60)
def test_activation_codec_rejects_an_unknown_method():
    for bad in ("topk", "none", "zstd"):
        with pytest.raises(ValueError):
            ActivationCodec(bad)
    with pytest.raises(ValueError):
        _split(_cfg(comm=CommConfig(activation_compression="zstd")), _data())


@time_limit(120)
@pytest.mark.parametrize("method,min_cut", [("int8", 3.0), ("int4", 5.0)])
def test_activation_compression_cut_factor_metered(method, min_cut):
    cfg = _cfg(comm_round=1, workers=2,
               comm=CommConfig(activation_compression=method, activation_error_feedback=True))
    meter = get_comm_meter()
    before = meter.snapshot()
    server = _split(cfg, _data())
    after = meter.snapshot()
    assert server.round_idx == 1
    up_p = after["uplink_payload_bytes"] - before["uplink_payload_bytes"]
    up_r = after["uplink_raw_bytes"] - before["uplink_raw_bytes"]
    dn_p = after["downlink_payload_bytes"] - before["downlink_payload_bytes"]
    dn_r = after["downlink_raw_bytes"] - before["downlink_raw_bytes"]
    assert up_r > 0 and dn_r > 0
    assert up_r / up_p >= min_cut and dn_r / dn_p >= min_cut


@time_limit(120)
def test_compressed_split_run_stays_close_to_exact():
    data = _data()
    exact = _split(_cfg(comm_round=2, workers=2), data)
    lossy = _split(_cfg(comm_round=2, workers=2, comm=CommConfig(
        activation_compression="int8", activation_error_feedback=True)), data)
    assert lossy.round_idx == 2
    for half in ("bottom", "top"):
        for k, a in exact.global_vars["params"][half].items():
            b = lossy.global_vars["params"][half][k]
            scale = max(1.0, float(a.abs().max()))
            assert float((a - b).abs().max()) / scale < 0.15, (half, k)
