"""The port's MQTT transport on the CPU (core/mqtt_broker.py,
core/mqtt_comm.py, ``run_mqtt_federation``):

- the port's MiniMqttBroker answers, and its MiniMqttClient emits, the
  byte-level MQTT 3.1.1 fixtures of a paho session
  (tests/golden/mqtt311_paho_session.json), as tests/test_mqtt_conformance.py
  holds the reference's broker to them, and a multibyte remaining length
  goes through the broker intact;
- a federation over the embedded broker, and one over TCP to the port's
  broker on 127.0.0.1, is bit-equal to the loopback federation (FedAdam on
  the transport tests' logistic-regression fixture, with and without the
  int8 codecs); the bytes the broker forwards are the bytes ``to_bytes``
  gave for each message, and the same messages as on loopback;
- a ``fedml_tpu`` server on the reference's MqttCommManager trains with the
  port's client managers through one TCP broker, within 1e-5 of the
  all-reference federation;
- past its connection cap the broker refuses a client with CONNACK 3, which
  the client raises as RemoteRefusal, and both ends meter it.

Every test that opens a socket runs under its own time limit."""

import json
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import fedml_tpu.config as jcfg  # noqa: E402
from fedml_tpu.data.synthetic import synthetic_classification as jax_synthetic  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.algorithms import fedavg_transport as ft  # noqa: E402
from fedml_tpu_torch.core import mqtt_broker as mb  # noqa: E402
from fedml_tpu_torch.core.loopback import LoopbackHub  # noqa: E402
from fedml_tpu_torch.core.message import Message, MessageType as MT  # noqa: E402
from fedml_tpu_torch.core.mqtt_comm import MqttCommManager  # noqa: E402
from fedml_tpu_torch.core.retry import RemoteRefusal  # noqa: E402
from fedml_tpu_torch.data.synthetic import synthetic_classification  # noqa: E402
from fedml_tpu_torch.telemetry import get_comm_meter  # noqa: E402

from torch_parity import (  # noqa: E402
    LR, jax_lr_model, jax_transport_perm_fn, lr_config, lr_data, private_reference_programs,
    time_limit, torch_lr_model,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "mqtt311_paho_session.json")
SGD = dict(client_optimizer="sgd", lr=0.1)
FEDADAM = dict(server_optimizer="adam", server_lr=0.05)
INT8 = dict(compression="int8", downlink_compression="int8")
ATOL = 1e-5  # the reference's transport-vs-simulator tolerance


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _fixture():
    with open(GOLDEN) as f:
        return json.load(f)


def _recv_packet(sock):
    """One whole MQTT control packet, raw (spec §2.2)."""
    def exact(n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed")
            buf += chunk
        return buf

    head = exact(1)
    mult, length = 1, 0
    while True:
        b = exact(1)
        head += b
        length += (b[0] & 0x7F) * mult
        mult *= 128
        if not b[0] & 0x80:
            break
    return head + (exact(length) if length else b"")


@time_limit(20)
def test_broker_replays_the_paho_session_byte_exact():
    broker = mb.MiniMqttBroker()
    try:
        s = socket.create_connection(("127.0.0.1", broker.port), timeout=10)
        for step in _fixture()["session"]:
            raw = bytes.fromhex(step["hex"])
            if step["dir"] == "c2s":
                s.sendall(raw)
            else:
                assert _recv_packet(s) == raw, f"{step['name']} ({step['spec']})"
        s.close()
    finally:
        broker.close()


@time_limit(20)
def test_client_emits_the_paho_session_bytes():
    """The client's CONNECT (as paho's, keepalive 60), SUBSCRIBE, PUBLISH
    and DISCONNECT are the fixture's bytes, and it takes the broker's
    CONNACK, SUBACK and PUBLISH fan-out. (It sends no PINGREQ: at
    keepalive 0, its default, none is due.)"""
    steps = {s["name"]: bytes.fromhex(s["hex"]) for s in _fixture()["session"]}
    srv = socket.create_server(("127.0.0.1", 0))
    got, seen = [], []
    ready = threading.Event()

    def fake_broker():
        conn, _ = srv.accept()
        conn.settimeout(10)
        for c2s, s2c in (("CONNECT", "CONNACK"), ("SUBSCRIBE", "SUBACK"),
                         ("PUBLISH", "PUBLISH-fanout"), ("DISCONNECT", None)):
            got.append((c2s, _recv_packet(conn)))
            if s2c:
                conn.sendall(steps[s2c])
            if c2s == "PUBLISH":
                ready.set()
        conn.close()

    t = threading.Thread(target=fake_broker, daemon=True)
    t.start()
    try:
        client = mb.MiniMqttClient("127.0.0.1", srv.getsockname()[1], "paho-test",
                                   on_message=lambda topic, p: seen.append((topic, p)),
                                   keepalive=60)
        client.subscribe("fedml/t", qos=0)
        client.publish("fedml/t", b"hi")
        assert ready.wait(10)
        deadline = time.monotonic() + 10
        while not seen and time.monotonic() < deadline:
            time.sleep(0.01)
        client.close()
        t.join(10)
    finally:
        srv.close()
    assert [(name, raw) for name, raw in got] == [(n, steps[n]) for n, _ in got]
    assert [n for n, _ in got] == ["CONNECT", "SUBSCRIBE", "PUBLISH", "DISCONNECT"]
    assert seen == [("fedml/t", b"hi")]


@time_limit(20)
def test_multibyte_remaining_length_roundtrip():
    """§2.2.3: a 321-byte body takes two varint bytes (C1 02); the broker
    forwards the frame intact, and the port's client receives the payload."""
    fix = _fixture()["multibyte_remaining_length"]
    topic = fix["publish_topic"]
    payload = (bytes(range(256)) * 2)[: fix["payload_len"]]
    body = struct.pack("!H", len(topic)) + topic.encode() + payload
    frame = mb._packet(mb.PUBLISH, 0, body)
    assert frame[:3] == bytes.fromhex(fix["header_hex"]) and len(body) == 321
    assert mb._encode_varint(321) == b"\xc1\x02"
    broker = mb.MiniMqttBroker()
    got = []
    try:
        sub = mb.MiniMqttClient("127.0.0.1", broker.port, "sub",
                                on_message=lambda t, p: got.append((t, p)))
        sub.subscribe(topic)
        raw = socket.create_connection(("127.0.0.1", broker.port), timeout=10)
        raw.sendall(bytes.fromhex("101000044d5154540402003c000470756232"))  # CONNECT "pub2"
        assert _recv_packet(raw)[:1] == b"\x20"
        time.sleep(0.2)  # the subscriber's SUBSCRIBE is in before the publish
        raw.sendall(frame)
        deadline = time.monotonic() + 10
        while not got and time.monotonic() < deadline:
            time.sleep(0.01)
        assert got == [(topic, payload)]
        raw.close()
        sub.close()
    finally:
        broker.close()


def _port(comm=None):
    cfg = lr_config(tcfg, SGD, FEDADAM, comm)
    return cfg, lr_data(synthetic_classification), torch_lr_model()


def _strip(data: bytes) -> bytes:
    """The envelope without what differs from run to run: the trace stamp
    (ids and clock times) and the telemetry beacon (measured seconds)."""
    msg = Message.from_bytes(data)
    msg.trace = None
    msg.params.pop(MT.ARG_TELEMETRY, None)
    return msg.to_bytes()


class _TappedHub(LoopbackHub):
    def __init__(self):
        super().__init__()
        self.sent = []

    def deliver(self, msg):
        self.sent.append(msg.to_bytes())
        super().deliver(msg)


def _loopback(comm=None):
    hub = _TappedHub()
    fed = ft.run_federation(*_port(comm), lambda rank: ft.LoopbackCommManager(hub, rank),
                            server_opt=True, device="cpu")
    return fed, hub.sent


def _assert_bit_equal(a, b):
    for k in a.global_vars:
        assert torch.equal(a.global_vars[k], b.global_vars[k]), k
    assert a.train_losses == b.train_losses
    assert [{k: v for k, v in r.items() if k != "t_s"} for r in a.history] == \
        [{k: v for k, v in r.items() if k != "t_s"} for r in b.history]


@time_limit(40)
@pytest.mark.parametrize("comm", [None, INT8], ids=["float32", "int8"])
def test_embedded_broker_federation_is_bit_equal_to_loopback(comm):
    loop, _ = _loopback(comm)
    mqtt = ft.run_mqtt_federation(*_port(comm), server_opt=True, device="cpu")
    assert mqtt.round_idx == LR["rounds"]
    _assert_bit_equal(mqtt, loop)


class _Sniffer:
    """A client of the broker subscribed to every rank's topic: what the
    broker forwards."""

    def __init__(self, port, ranks):
        self.got = []
        self.client = mb.MiniMqttClient("127.0.0.1", port, "sniffer",
                                        on_message=lambda t, p: self.got.append(bytes(p)))
        for r in ranks:
            self.client.subscribe(f"fedml_tpu/to_{r}")


@time_limit(60)
def test_tcp_broker_federation_is_bit_equal_to_loopback_and_forwards_its_bytes(monkeypatch):
    sent = []
    real_send = MqttCommManager._send

    def tapped(self, msg):
        sent.append(msg.to_bytes())
        real_send(self, msg)

    monkeypatch.setattr(MqttCommManager, "_send", tapped)
    loop, loop_bytes = _loopback()
    broker = mb.MiniMqttBroker()
    try:
        sniffer = _Sniffer(broker.port, range(LR["num_clients"] + 1))
        time.sleep(0.2)  # the sniffer's SUBSCRIBEs are in before the first publish
        fed = ft.run_mqtt_federation(*_port(), host="127.0.0.1", port=broker.port,
                                     server_opt=True, device="cpu")
        deadline = time.monotonic() + 10
        while len(sniffer.got) < len(sent) and time.monotonic() < deadline:
            time.sleep(0.01)
        sniffer.client.close()
    finally:
        broker.close()
    _assert_bit_equal(fed, loop)
    assert sorted(sniffer.got) == sorted(sent)
    assert sorted(map(_strip, sent)) == sorted(map(_strip, loop_bytes))


@time_limit(60)
def test_reference_server_trains_with_port_clients_over_tcp_mqtt():
    """The reference's FedAvgServerManager on the reference's
    MqttCommManager (its stdlib MQTT client) and the port's client managers
    on the port's, through one broker over TCP, 3 rounds at full batch:
    params and each row's Test/Acc within 1e-5 of the all-reference
    federation."""
    from fedml_tpu.algorithms.fedavg_transport import (
        FedAvgServerManager as JaxServer, run_loopback_federation as jax_loopback,
    )
    from fedml_tpu.core.mqtt_comm import MqttCommManager as JaxMqtt

    ref_cfg = lr_config(jcfg, SGD)
    ref = jax_loopback(ref_cfg, lr_data(jax_synthetic), jax_lr_model())
    broker = mb.MiniMqttBroker()
    try:
        server = JaxServer(ref_cfg, JaxMqtt(0, host="127.0.0.1", port=broker.port),
                           jax_lr_model(), data=lr_data(jax_synthetic))
        cfg, data, model = lr_config(tcfg, SGD), lr_data(synthetic_classification), torch_lr_model()
        clients = [
            ft.FedAvgClientManager(
                cfg, MqttCommManager(rank, host="127.0.0.1", port=broker.port), rank,
                ft.LocalTrainer(cfg, data, model, device="cpu",
                                perm_fn=jax_transport_perm_fn(cfg.seed)))
            for rank in range(1, cfg.fed.client_num_per_round + 1)
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
        time.sleep(0.2)  # every SUBSCRIBE is in before the first broadcast
        server.send_init_msg()
        server.run()
        for t in threads:
            t.join(timeout=30)
    finally:
        broker.close()
    assert not errors, errors
    assert server.round_idx == ref.round_idx == LR["rounds"]
    got = jax.device_get(server.global_vars)["params"]["linear"]
    want = jax.device_get(ref.global_vars)["params"]["linear"]
    for leaf in want:
        np.testing.assert_allclose(np.asarray(got[leaf]), np.asarray(want[leaf]), rtol=ATOL,
                                   atol=ATOL, err_msg=leaf)
    for mrow, rrow in zip(server.history, ref.history, strict=True):
        assert ("Test/Acc" in mrow) == ("Test/Acc" in rrow)
        if "Test/Acc" in rrow:
            assert abs(mrow["Test/Acc"] - rrow["Test/Acc"]) <= ATOL


@time_limit(20)
def test_connection_cap_refuses_then_admits():
    """Past max_connections a dialer gets CONNACK rc=3 → RemoteRefusal,
    metered as ``refused["mqtt_conn"]``; closing a connection frees the
    slot."""
    broker = mb.MiniMqttBroker(max_connections=1)
    before = get_comm_meter().snapshot()["refused"].get("mqtt_conn", 0)
    try:
        c1 = mb.MiniMqttClient("127.0.0.1", broker.port, "c1", lambda t, p: None)
        with pytest.raises(RemoteRefusal):
            mb.MiniMqttClient("127.0.0.1", broker.port, "c2", lambda t, p: None)
        assert broker.refused == 1
        assert get_comm_meter().snapshot()["refused"].get("mqtt_conn", 0) - before == 1
        c1.close()
        deadline = time.monotonic() + 5
        while True:
            try:
                mb.MiniMqttClient("127.0.0.1", broker.port, "c3", lambda t, p: None).close()
                break
            except RemoteRefusal:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
    finally:
        broker.close()
