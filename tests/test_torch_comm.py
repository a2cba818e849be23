"""The comm layer the MQTT and gRPC transports reach, against the
reference: the send template's refusal branch (``RemoteRefusal`` metered as
``send_refused`` apart from other faults, retried, and given up after the
last attempt), the comm meter's snapshot (the reference's keys in the
reference's order, ``refused`` and ``send_refused`` among them), and shared
memory's decode, a copy that outlives the segment."""

import tempfile
import threading

import numpy as np
import pytest

from fedml_tpu_torch.core.comm import BaseCommManager, Observer
from fedml_tpu_torch.core.message import Message, MessageType as MT
from fedml_tpu_torch.core.retry import RemoteRefusal, RetryPolicy
from fedml_tpu_torch.telemetry.comm import CommMeter

from torch_parity import time_limit


class _Flaky(BaseCommManager):
    """Refuses its first ``refusals`` sends, then takes every one."""

    def __init__(self, refusals, error=RemoteRefusal):
        super().__init__()
        self.refusals, self.error, self.sent = refusals, error, []
        self._meter = CommMeter()

    def _send(self, msg):
        if self.refusals:
            self.refusals -= 1
            raise self.error("shed at budget")
        self.sent.append(msg)

    def handle_receive_message(self):
        pass

    def stop_receive_message(self):
        pass


def test_snapshot_keys_are_the_references():
    from fedml_tpu.telemetry.comm import CommMeter as JaxCommMeter

    got, want = CommMeter(), JaxCommMeter()
    for m in (got, want):
        m.reset()
        m.on_refused("grpc_stream")
        m.on_refused("grpc_stream")
        m.on_send_refused(MT.C2S_JOIN)
        m.on_sent(MT.C2S_JOIN, 10, 0.0)
        m.on_uplink(8, 16)
    assert got.snapshot() == want.snapshot()
    assert list(got.snapshot()) == list(want.snapshot())


def test_a_refusal_is_metered_apart_and_retried():
    comm = _Flaky(refusals=2)
    comm.set_retry_policy(RetryPolicy(max_attempts=3, backoff_base_s=0.001, backoff_max_s=0.002))
    comm.send_message(Message(MT.C2S_JOIN, 1, 0))
    snap = comm._meter.snapshot()
    assert snap["send_refused"] == {MT.C2S_JOIN: 2}
    assert snap["send_retries"] == {MT.C2S_JOIN: 2}
    assert snap["messages_sent"] == {MT.C2S_JOIN: 1} and len(comm.sent) == 1
    # another fault is retried but not counted as a refusal
    comm = _Flaky(refusals=1, error=ConnectionError)
    comm.set_retry_policy(RetryPolicy(max_attempts=2, backoff_base_s=0.001, backoff_max_s=0.002))
    comm.send_message(Message(MT.C2S_JOIN, 1, 0))
    assert comm._meter.snapshot()["send_refused"] == {}


def test_a_refusal_past_the_last_attempt_gives_up():
    comm = _Flaky(refusals=5)
    comm.set_retry_policy(RetryPolicy(max_attempts=2, backoff_base_s=0.001, backoff_max_s=0.002))
    with pytest.raises(RemoteRefusal):
        comm.send_message(Message(MT.C2S_JOIN, 1, 0))
    snap = comm._meter.snapshot()
    assert snap["send_refused"] == {MT.C2S_JOIN: 2}
    assert snap["send_retries"] == {MT.C2S_JOIN: 1}
    assert snap["send_gave_up"] == {MT.C2S_JOIN: 1}
    assert snap["messages_sent"] == {} and comm.sent == []


@time_limit(20)
def test_shm_decodes_a_copy_of_the_message():
    """The segment is unlinked once the observer returns: the decoded
    array owns its memory and outlives the callback."""
    from fedml_tpu_torch.core.shm_comm import ShmCommManager

    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    with tempfile.TemporaryDirectory(prefix="fedml_shm_test_") as d:
        a, b = ShmCommManager(0, d), ShmCommManager(1, d)
        got = []

        class Keep(Observer):
            def receive_message(self, msg_type, msg):
                got.append(msg.get(MT.ARG_MODEL_PARAMS))
                b.stop_receive_message()

        b.add_observer(Keep())
        rx = threading.Thread(target=b.handle_receive_message, daemon=True)
        rx.start()
        msg = Message(MT.S2C_SYNC_MODEL, 0, 1)
        msg.add_params(MT.ARG_MODEL_PARAMS, w)
        a.send_message(msg)
        rx.join(10)
        a.stop_receive_message()
    (arr,) = got
    assert arr.flags.owndata
    np.testing.assert_array_equal(arr, w)
