"""Message envelope with binary tensor serialization (a whole copy of
``fedml_tpu/core/message.py``: the FTM1 wire is the reference's byte for
byte, so a port client can talk to a ``fedml_tpu`` server and the reverse).

Wire layout::

    [4 bytes magic 'FTM1'][8 bytes meta_len][meta JSON][buf 0][buf 1]...

meta = {msg_type, sender_id, receiver_id, params: {key: scalar|str|descriptor}}
plus an optional ``_trace`` key (cross-process trace context, stamped by
the comm template — see telemetry/wire.py; absent = legacy envelope).
descriptor = {"__nd__": n, dtype, shape, nbytes} referring to the n-th buffer.
Params may be nested dicts/lists whose leaves are numpy arrays; only numpy
arrays go on the wire — the port turns its tensors into the reference's
flax-layout numpy tree (``fedml_tpu_torch.bridge.to_flax``) before it builds
a message."""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_MAGIC = b"FTM1"


class MessageType:
    """Round FSM message types (ref fedavg/message_define.py:1-30)."""

    S2C_INIT_CONFIG = "s2c_init"
    S2C_SYNC_MODEL = "s2c_sync"
    C2S_SEND_MODEL = "c2s_model"
    C2S_SEND_STATS = "c2s_stats"  # fedlint: disable=dead-msg-type -- reference-FedML parity constant; the neutral envelope type transport/retry tests send when they need a real MessageType no production handler consumes
    FINISH = "finish"
    # secure-aggregation key exchange + dropout recovery (client-held keys,
    # secagg/secure_aggregation.py ClientParty/ServerAggregator): clients
    # advertise fresh per-round DH public keys, the server relays the
    # registry, masked uploads follow; if a registry party drops before
    # uploading, survivors return recovery masks
    C2S_PUBKEY = "c2s_pubkey"
    S2C_PUBKEYS = "s2c_pubkeys"
    S2C_RECOVER = "s2c_recover"
    C2S_RECOVERY = "c2s_recovery"
    # elastic fleet membership (fedml_tpu/serve/): a worker announces
    # itself mid-federation (the async server answers with an assignment,
    # or with FINISH when the fleet is at max_workers — backpressure) or
    # leaves gracefully (the server stops dispatching to it instead of
    # paying dead-peer timeouts / dispatching into a drained inbox)
    C2S_JOIN = "c2s_join"
    C2S_LEAVE = "c2s_leave"
    # split learning boundary protocol (fedml_tpu/splitfed/): the server
    # hands the relay turn (bottom weights + bottom optimizer state) to one
    # client at a time; per batch the client uploads cut-layer ACTIVATIONS
    # and the server returns the ACTIVATION GRADIENTS (ref
    # fedml_api/distributed/split_nn client.py forward/backward exchange);
    # the turn ends with the client returning its updated bottom state
    S2C_SPLIT_TURN = "s2c_split_turn"
    C2S_SPLIT_ACTS = "c2s_split_acts"
    S2C_SPLIT_GRADS = "s2c_split_grads"
    C2S_SPLIT_DONE = "c2s_split_done"
    # classical vertical FL (fedml_tpu/splitfed/vfl_transport.py): the
    # guest (labels) polls every host for its per-batch logit contribution
    # h_k and answers with dL/dh_k (ref classical_vertical_fl
    # guest_trainer/host_trainer exchange)
    S2C_VFL_BATCH = "s2c_vfl_batch"
    C2S_VFL_CONTRIB = "c2s_vfl_contrib"
    S2C_VFL_GRADS = "s2c_vfl_grads"

    # param keys
    ARG_MODEL_PARAMS = "model_params"
    # compressed uplink update payload (core/compression.py) — carried
    # INSTEAD of ARG_MODEL_PARAMS when CommConfig.compression != "none",
    # together with ARG_COMPRESSION naming the codec (the server decodes by
    # this protocol tag, not by its own config, so a client/server
    # --compression mismatch is handled instead of crashing the FSM)
    ARG_MODEL_DELTA = "model_delta"
    ARG_COMPRESSION = "compression"
    # quantized downlink broadcast (CommConfig.downlink_compression) —
    # carried INSTEAD of ARG_MODEL_PARAMS on server->client syncs: the
    # server encodes the model ONCE per round and every worker's message
    # shares the same payload tree, tagged with the codec so clients
    # decode by protocol, not by their own config
    ARG_MODEL_QUANT = "model_quant"
    ARG_MODEL_CODEC = "model_codec"
    # pairwise-masked field vector (secagg/secure_aggregation.py) — carried
    # instead of ARG_MODEL_PARAMS when CommConfig.secure_agg is on
    ARG_MASKED_UPDATE = "masked_update"
    ARG_CLIENT_INDEX = "client_index"
    ARG_NUM_SAMPLES = "num_samples"
    # client's local mean train loss for the round, attached to uploads —
    # the bias signal power_of_choice selection feeds on (scheduler/)
    ARG_TRAIN_LOSS = "train_loss"
    ARG_ROUND_IDX = "round_idx"
    # asynchronous buffered aggregation (algorithms/fedbuff.py): clients
    # upload deltas tagged with the model VERSION they trained from; the
    # server discounts by staleness = current_version - base_version
    ARG_ASYNC_DELTA = "async_delta"
    ARG_BASE_VERSION = "base_version"
    # async assignment decline: the worker reports "no update for this
    # assignment" (fault-injected dropout/crashed client) so the server
    # re-dispatches instead of waiting on an upload that will never come
    ARG_DECLINED = "declined"
    ARG_PUBKEY = "pubkey"
    ARG_PUBKEY_REGISTRY = "pubkey_registry"  # {party: pk}, public material
    ARG_DROPPED = "dropped_parties"
    ARG_RECOVERY_VEC = "recovery_vec"
    # bounded client telemetry beacon (telemetry/wire.py build_beacon)
    # piggybacked on model uploads — observability sidecar, never read by
    # the aggregation path, so numerics are byte-identical with it on/off
    ARG_TELEMETRY = "telemetry"
    # split/vertical boundary payloads (fedml_tpu/splitfed/). Activations
    # and activation-grads optionally travel COMPRESSED (ARG_ACT_PAYLOAD +
    # ARG_ACT_CODEC naming the codec, core/compression.py) instead of the
    # raw ARG_ACTIVATIONS / ARG_ACT_GRADS array — the receiver decodes by
    # the protocol tag, exactly like the model-delta uplink.
    ARG_ACTIVATIONS = "activations"
    ARG_ACT_GRADS = "act_grads"
    ARG_ACT_PAYLOAD = "act_payload"
    ARG_ACT_CODEC = "act_codec"
    ARG_BATCH_LABELS = "batch_labels"
    ARG_BATCH_IDX = "batch_idx"
    ARG_OPT_STATE = "opt_state"
    # relay-turn decline: the fault plan crashed/dropped this client's
    # turn — the server passes the unchanged bottom state to the next
    # client in the ring instead of waiting on batches that never come
    ARG_SKIPPED = "skipped"
    # VFL host logit contribution h_k and its returned gradient dL/dh_k
    ARG_CONTRIB = "contrib"
    ARG_CONTRIB_GRAD = "contrib_grad"


class Message:
    def __init__(self, msg_type: str = "", sender_id: int = 0, receiver_id: int = 0):
        self.msg_type = msg_type
        self.sender_id = int(sender_id)
        self.receiver_id = int(receiver_id)
        self.params: Dict[str, Any] = {}
        # serialized wire size, stamped by to_wire_parts/from_bytes — None
        # until the envelope has crossed a serialization boundary
        self._wire_nbytes: Optional[int] = None
        # cross-process trace context (telemetry/wire.py), stamped by the
        # BaseCommManager.send_message template and carried as an OPTIONAL
        # "_trace" meta key — absent on legacy peers, so mixed-version
        # fleets decode fine
        self.trace: Optional[Dict[str, Any]] = None

    # -- envelope API (ref message.py:20-74) --
    def add_params(self, key: str, value: Any) -> "Message":
        self.params[key] = value
        return self

    def get(self, key: str, default=None):
        return self.params.get(key, default)

    def get_type(self) -> str:
        return self.msg_type

    def get_sender_id(self) -> int:
        return self.sender_id

    def get_receiver_id(self) -> int:
        return self.receiver_id

    # -- binary wire format --
    def to_wire_parts(self) -> Tuple[bytes, List[np.ndarray]]:
        """(header, contiguous array buffers) — the wire image is their
        concatenation. Lets transports with their own destination memory
        (e.g. the shared-memory backend) assemble with ONE copy per buffer
        instead of materialising an intermediate bytes object."""
        buffers: List[np.ndarray] = []
        meta_params: Dict[str, Any] = {}
        for k, v in self.params.items():
            meta_params[k] = _encode_value(v, buffers)
        meta_doc: Dict[str, Any] = {
            "msg_type": self.msg_type,
            "sender_id": self.sender_id,
            "receiver_id": self.receiver_id,
            "params": meta_params,
        }
        if self.trace is not None:
            meta_doc["_trace"] = self.trace
        meta = json.dumps(meta_doc).encode("utf-8")
        header = _MAGIC + struct.pack("<Q", len(meta)) + meta
        # stamp the serialized size on the envelope: the comm layer's
        # telemetry (core/comm.py) reads it so byte accounting never needs
        # a second serialization pass
        self._wire_nbytes = len(header) + sum(int(b.nbytes) for b in buffers)
        return header, buffers

    def wire_size(self) -> int:
        header, buffers = self.to_wire_parts()
        return len(header) + sum(int(b.nbytes) for b in buffers)

    def write_into(self, view) -> int:
        """Assemble the wire image directly into ``view`` (a writable
        buffer, e.g. SharedMemory.buf). Returns bytes written. Callers that
        also need the size should use ``to_wire_parts`` + ``write_wire_parts``
        to serialize only once."""
        header, buffers = self.to_wire_parts()
        return write_wire_parts(view, header, buffers)

    def to_bytes(self) -> bytes:
        header, buffers = self.to_wire_parts()
        # one copy of each buffer into the wire image
        return b"".join([header] + [b.reshape(-1).view(np.uint8) for b in buffers])

    @classmethod
    def from_bytes(cls, data, copy: bool = True) -> "Message":
        """Parse a wire image. With ``copy=False`` the decoded arrays alias
        ``data`` (zero-copy receive — valid only while the underlying buffer
        lives; the shared-memory backend relies on this)."""
        if bytes(data[:4]) != _MAGIC:
            raise ValueError("bad message magic")
        (meta_len,) = struct.unpack("<Q", bytes(data[4:12]))
        meta = json.loads(bytes(data[12 : 12 + meta_len]).decode("utf-8"))
        msg = cls(meta["msg_type"], meta["sender_id"], meta["receiver_id"])
        # optional trace context — .get() is the legacy-decode contract:
        # an envelope from an older peer simply has no "_trace" key
        msg.trace = meta.get("_trace")
        offset = 12 + meta_len
        # buffers appear in descriptor-index order; walk descriptors sorted
        # by index to compute offsets. NOTE: the recursive helpers are
        # module-level functions on purpose — recursive closures form
        # reference cycles that keep ``data`` (possibly a mapped shared-
        # memory view) alive until a gc pass, breaking prompt close().
        descs: List[Tuple[int, dict]] = []
        _collect_descs(meta["params"], descs)
        offsets = {}
        for idx, d in sorted(descs, key=lambda t: t[0]):
            offsets[idx] = offset
            offset += d["nbytes"]

        for k, v in meta["params"].items():
            msg.params[k] = _decode_node(v, data, offsets, copy)
        # received wire size (exact: header + meta + buffers, independent of
        # any trailing slack in the caller's buffer) — comm telemetry reads it
        msg._wire_nbytes = offset
        return msg


def write_wire_parts(view, header: bytes, buffers: List[np.ndarray]) -> int:
    """Write a ``to_wire_parts`` result into a writable buffer; returns bytes
    written. One buffer-to-buffer copy per array, no intermediate bytes."""
    mv = memoryview(view).cast("B")
    o = len(header)
    mv[:o] = header
    for b in buffers:
        n = int(b.nbytes)
        mv[o : o + n] = memoryview(b).cast("B")
        o += n
    return o


def _collect_descs(node, out: List[Tuple[int, dict]]) -> None:
    if isinstance(node, dict) and "__nd__" in node:
        out.append((node["__nd__"], node))
    elif isinstance(node, dict):
        for v in node.values():
            _collect_descs(v, out)
    elif isinstance(node, list):
        for v in node:
            _collect_descs(v, out)


def _decode_node(node, data, offsets, copy: bool):
    if isinstance(node, dict) and "__nd__" in node:
        o = offsets[node["__nd__"]]
        count = (
            int(np.prod(node["shape"], dtype=np.int64)) if node["shape"] else 1
        )
        a = np.frombuffer(data, dtype=np.dtype(node["dtype"]), count=count, offset=o)
        if node["shape"]:
            a = a.reshape(node["shape"])
            return a.copy() if copy else a
        return a.copy()[0] if copy else a[0]
    if isinstance(node, dict):
        return {k: _decode_node(v, data, offsets, copy) for k, v in node.items()}
    if isinstance(node, list):
        return [_decode_node(v, data, offsets, copy) for v in node]
    return node


def _encode_value(v: Any, buffers: List[np.ndarray]):
    """Scalars/strings inline; ndarrays become buffer descriptors;
    dicts/lists recurse (param trees ride along)."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {k: _encode_value(x, buffers) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_encode_value(x, buffers) for x in v]
    a = np.asarray(v)
    idx = len(buffers)
    buffers.append(np.ascontiguousarray(a))
    return {
        "__nd__": idx,
        "dtype": a.dtype.str,
        "shape": list(a.shape),
        "nbytes": a.nbytes,
    }
