"""MQTT communication backend (a copy of ``fedml_tpu/core/mqtt_comm.py``).

Topic scheme: every participant subscribes ``{prefix}/to_{rank}``; sending
publishes the binary Message (the same FTM1 bytes as on loopback) to
``{prefix}/to_{receiver}``.

Two broker paths behind one manager:

- **Embedded broker** (the default): an in-process topic-routed pub/sub hub
  with MQTT semantics (subscribe exact topics, publish fan-out, QoS-0
  at-most-once), so the backend runs hermetically.
- **A real broker over TCP** (host/port): paho-mqtt when installed;
  otherwise the built-in MQTT 3.1.1 QoS-0 client (core/mqtt_broker.py,
  which also ships a mini broker). Either way the wire is standard MQTT.

The encode and decode of each message are recorded as ``to_bytes`` /
``from_bytes`` spans on the process tracer, as on the loopback hub.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional, Set

from fedml_tpu_torch.core.comm import BaseCommManager
from fedml_tpu_torch.core.message import Message
from fedml_tpu_torch.telemetry.spans import get_tracer

_STOP = object()


class EmbeddedBroker:
    """In-process MQTT-semantics broker: topic → subscriber queues.
    QoS-0 (at-most-once) fan-out; thread-safe."""

    def __init__(self):
        self._subs: Dict[str, Set["queue.Queue"]] = {}
        self._lock = threading.Lock()

    def subscribe(self, topic: str, q: "queue.Queue") -> None:
        with self._lock:
            self._subs.setdefault(topic, set()).add(q)

    def unsubscribe(self, topic: str, q: "queue.Queue") -> None:
        with self._lock:
            self._subs.get(topic, set()).discard(q)

    def publish(self, topic: str, payload: bytes) -> None:
        with self._lock:
            targets = list(self._subs.get(topic, ()))
        for q in targets:
            q.put(payload)


class MqttCommManager(BaseCommManager):
    """BaseCommManager over MQTT pub/sub (embedded broker or paho client)."""

    def __init__(
        self,
        rank: int,
        broker: Optional[EmbeddedBroker] = None,
        host: Optional[str] = None,
        port: int = 1883,
        topic_prefix: str = "fedml_tpu",
    ):
        super().__init__()
        self.rank = rank
        self.prefix = topic_prefix
        self._q: "queue.Queue" = queue.Queue()
        self._broker = broker
        self._client = None
        if broker is not None:
            broker.subscribe(self._topic(rank), self._q)
        elif host is not None:
            self._client = self._connect_paho(host, port)
        else:
            raise ValueError("need either an EmbeddedBroker or a broker host")

    def _topic(self, rank: int) -> str:
        return f"{self.prefix}/to_{rank}"

    def _connect_paho(self, host: str, port: int):
        try:
            import paho.mqtt.client as mqtt
        except ImportError:
            # no paho: the built-in MQTT 3.1.1 QoS-0 client
            # (core/mqtt_broker.py) speaks the same wire protocol over a
            # real TCP socket
            from fedml_tpu_torch.core.mqtt_broker import MiniMqttClient

            client = MiniMqttClient(
                host,
                port,
                client_id=f"{self.prefix}_{self.rank}",
                on_message=lambda topic, payload: self._q.put(payload),
            )
            client.subscribe(self._topic(self.rank), qos=0)
            return client

        client = mqtt.Client(client_id=f"{self.prefix}_{self.rank}")
        client.on_message = lambda c, u, m: self._q.put(m.payload)
        # Subscribe from on_connect, not once after connect(): paho's loop
        # thread auto-reconnects after a broker blip, and subscriptions are
        # per-connection — resubscribing here keeps receiving after
        # reconnects (the ref subscribes in _on_connect for the same
        # reason, mqtt_comm_manager.py:48-72).
        client.on_connect = lambda c, u, f, rc: c.subscribe(
            self._topic(self.rank), qos=0
        )
        client.connect(host, port)
        client.loop_start()
        return client

    def _send(self, msg: Message) -> None:
        topic = self._topic(msg.get_receiver_id())
        with get_tracer().span("to_bytes", msg_type=msg.get_type()):
            payload = msg.to_bytes()
        if self._broker is not None:
            self._broker.publish(topic, payload)
        else:
            self._client.publish(topic, payload, qos=0)

    def handle_receive_message(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                break
            with get_tracer().span("from_bytes", rank=self.rank):
                msg = Message.from_bytes(item)
            self.notify(msg)

    def stop_receive_message(self) -> None:
        self._q.put(_STOP)
        if self._broker is not None:
            self._broker.unsubscribe(self._topic(self.rank), self._q)
        if self._client is not None:
            if hasattr(self._client, "loop_stop"):  # paho
                self._client.loop_stop()
                self._client.disconnect()
            else:  # MiniMqttClient
                self._client.close()
