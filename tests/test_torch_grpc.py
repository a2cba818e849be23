"""The port's gRPC transport on the CPU (core/grpc_comm.py), where grpcio
imports (the card's machine has none, so it is held here only):

- a message goes through two managers on 127.0.0.1 and back unchanged, and
  the receiver gets the bytes ``to_bytes`` gave;
- a 2-round federation over gRPC is bit-equal to the loopback federation;
- a ``fedml_tpu`` server on the reference's GrpcCommManager trains with the
  port's client managers on the port's, within 1e-5 of the all-reference
  federation;
- a receiver over its stream budget sheds with RESOURCE_EXHAUSTED, the
  sender raises it as RemoteRefusal after its retries, and both ends meter
  it (``refused`` / ``send_refused``), as the reference's fleet tests hold
  its own transport.

Every test that opens a socket runs under its own time limit."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

pytest.importorskip("grpc")
jax = pytest.importorskip("jax")

import fedml_tpu.config as jcfg  # noqa: E402
from fedml_tpu.data.synthetic import synthetic_classification as jax_synthetic  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.algorithms import fedavg_transport as ft  # noqa: E402
from fedml_tpu_torch.core.comm import Observer  # noqa: E402
from fedml_tpu_torch.core.grpc_comm import (  # noqa: E402
    GrpcCommManager, executor_workers_for, read_ip_config,
)
from fedml_tpu_torch.core.message import Message, MessageType as MT  # noqa: E402
from fedml_tpu_torch.core.retry import RemoteRefusal, RetryPolicy  # noqa: E402
from fedml_tpu_torch.data.synthetic import synthetic_classification  # noqa: E402
from fedml_tpu_torch.telemetry import get_comm_meter  # noqa: E402

from torch_parity import (  # noqa: E402
    LR, free_port_block, jax_lr_model, jax_transport_perm_fn, lr_config, lr_data,
    private_reference_programs, time_limit, torch_lr_model,
)

SGD = dict(client_optimizer="sgd", lr=0.1)
ATOL = 1e-5  # the reference's transport-vs-simulator tolerance
LOCAL = "127.0.0.1"


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _ips(n):
    return {r: LOCAL for r in range(n)}


def _manager(rank, n, base, **kw):
    return GrpcCommManager(rank, _ips(n), base_port=base, bind_host=LOCAL, **kw)


@time_limit(30)
def test_message_round_trip(tmp_path):
    base = free_port_block(2)
    a, b = _manager(0, 2, base), _manager(1, 2, base)
    got = []

    class Keep(Observer):
        def receive_message(self, msg_type, msg):
            got.append(msg)
            b.stop_receive_message()

    b.add_observer(Keep())
    rx = threading.Thread(target=b.handle_receive_message, daemon=True)
    rx.start()
    try:
        msg = Message(MT.S2C_SYNC_MODEL, 0, 1)
        w = np.arange(12, dtype=np.float32).reshape(3, 4)
        msg.add_params(MT.ARG_MODEL_PARAMS, {"params": {"linear": {"kernel": w}}})
        msg.add_params(MT.ARG_ROUND_IDX, 3)
        a.send_message(msg)
        rx.join(10)
    finally:
        a.stop_receive_message()
    (back,) = got
    assert back.get_type() == MT.S2C_SYNC_MODEL and back.get(MT.ARG_ROUND_IDX) == 3
    np.testing.assert_array_equal(back.get(MT.ARG_MODEL_PARAMS)["params"]["linear"]["kernel"], w)
    assert back.to_bytes() == msg.to_bytes()
    # the helpers the reference's CLI uses
    (tmp_path / "ip.csv").write_text("receiver_id,ip\n0,10.0.0.1\n1, 10.0.0.2\n")
    assert read_ip_config(str(tmp_path / "ip.csv")) == {0: "10.0.0.1", 1: "10.0.0.2"}
    assert executor_workers_for(0, 4) == 8 and executor_workers_for(0, 1000) == 64
    assert executor_workers_for(5, 1000) == 5


def _port():
    return lr_config(tcfg, SGD), lr_data(synthetic_classification), torch_lr_model()


@time_limit(60)
def test_federation_over_grpc_is_bit_equal_to_loopback():
    cfg, data, model = _port()
    cfg = cfg.replace(fed=dataclasses.replace(cfg.fed, comm_round=2))
    loop = ft.run_loopback_federation(cfg, data, model, device="cpu")
    n = cfg.fed.client_num_per_round + 1
    base = free_port_block(n)
    fed = ft.run_federation(cfg, data, torch_lr_model(), lambda r: _manager(r, n, base),
                            device="cpu")
    assert fed.round_idx == 2
    for k in loop.global_vars:
        assert torch.equal(fed.global_vars[k], loop.global_vars[k]), k
    assert fed.train_losses == loop.train_losses


@time_limit(60)
def test_reference_grpc_server_trains_with_port_clients():
    from fedml_tpu.algorithms.fedavg_transport import (
        FedAvgServerManager as JaxServer, run_loopback_federation as jax_loopback,
    )
    from fedml_tpu.core.grpc_comm import GrpcCommManager as JaxGrpc

    ref_cfg = lr_config(jcfg, SGD)
    ref = jax_loopback(ref_cfg, lr_data(jax_synthetic), jax_lr_model())
    cfg, data, model = _port()
    n = cfg.fed.client_num_per_round + 1
    base = free_port_block(n)
    server = JaxServer(ref_cfg, JaxGrpc(0, _ips(n), base_port=base, bind_host=LOCAL),
                       jax_lr_model(), data=lr_data(jax_synthetic))
    clients = [
        ft.FedAvgClientManager(cfg, _manager(rank, n, base), rank,
                               ft.LocalTrainer(cfg, data, model, device="cpu",
                                               perm_fn=jax_transport_perm_fn(cfg.seed)))
        for rank in range(1, n)
    ]
    errors = []

    def run(c):
        try:
            c.run()
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
            server.finish()

    threads = [threading.Thread(target=run, args=(c,), daemon=True) for c in clients]
    for t in threads:
        t.start()
    server.send_init_msg()
    server.run()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    assert server.round_idx == ref.round_idx == LR["rounds"]
    got = jax.device_get(server.global_vars)["params"]["linear"]
    want = jax.device_get(ref.global_vars)["params"]["linear"]
    for leaf in want:
        np.testing.assert_allclose(np.asarray(got[leaf]), np.asarray(want[leaf]), rtol=ATOL,
                                   atol=ATOL, err_msg=leaf)
    for mrow, rrow in zip(server.history, ref.history, strict=True):
        if "Test/Acc" in rrow:
            assert abs(mrow["Test/Acc"] - rrow["Test/Acc"]) <= ATOL


@time_limit(30)
def test_stream_budget_refusal_is_metered_as_the_reference_meters_it():
    base = free_port_block(2)
    server = _manager(0, 2, base, stream_budget=1, expected_peers=2)
    client = _manager(1, 2, base, send_timeout_s=5.0, expected_peers=2)
    client.set_retry_policy(RetryPolicy(max_attempts=2, backoff_base_s=0.01, backoff_max_s=0.02))
    meter = get_comm_meter()
    before = meter.snapshot()
    try:
        # the server is not draining: the first message fills its budget
        client.send_message(Message(MT.C2S_JOIN, 1, 0))
        with pytest.raises(RemoteRefusal):
            client.send_message(Message(MT.C2S_JOIN, 1, 0))
        after = meter.snapshot()
        shed = after["refused"].get("grpc_stream", 0) - before["refused"].get("grpc_stream", 0)
        redials = (after["send_refused"].get(MT.C2S_JOIN, 0)
                   - before["send_refused"].get(MT.C2S_JOIN, 0))
        assert shed == 2 and redials == 2  # both attempts of the refused send
        assert after["send_gave_up"].get(MT.C2S_JOIN, 0) - before["send_gave_up"].get(MT.C2S_JOIN, 0) == 1
        server._q.get_nowait()  # drained: the budget frees
        client.send_message(Message(MT.C2S_JOIN, 1, 0))
        assert server._q.qsize() == 1
    finally:
        client.stop_receive_message()
        server.stop_receive_message()
