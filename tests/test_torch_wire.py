"""The port's FTM1 wire and update codecs against the reference's on the
same numpy-seeded inputs: a message encodes to identical bytes in both
packages and each decodes the other's; the port's wire model of a network
is the reference's model tree byte for byte and decodes to contiguous
torch-layout weights; the int8, int4, topk and topk8 payloads are
identical arrays with identical ``payload_bytes`` and decode to equal
trees; the leaf order is ``jax.tree_util.tree_flatten``'s."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from fedml_tpu.core import compression as JZ  # noqa: E402
from fedml_tpu.core.message import Message as JaxMessage  # noqa: E402

from fedml_tpu_torch.algorithms.fedavg_transport import model_vars, wire_model  # noqa: E402
from fedml_tpu_torch.core import compression as TZ  # noqa: E402
from fedml_tpu_torch.core.message import Message, MessageType as MT  # noqa: E402

from torch_parity import flat_params  # noqa: E402

CODECS = ("int8", "int4", "topk", "topk8")


def _tree(seed=0):
    """A nested tree with unsorted keys at every level and odd leaf sizes."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {
        "params": {
            "zeta": {"kernel": f(3, 5), "bias": f(7)},
            "alpha": {"scale": f(2, 3, 3), "embedding": f(9, 1)},
            "mid": f(1),
        },
        "extra": [f(4), (f(3, 3), f(5))],
    }


def _message(cls, tree):
    m = cls(MT.C2S_SEND_MODEL, 3, 0)
    m.add_params(MT.ARG_MODEL_PARAMS, tree)
    m.add_params(MT.ARG_NUM_SAMPLES, 12)
    m.add_params(MT.ARG_TRAIN_LOSS, 0.8125)
    m.add_params(MT.ARG_ROUND_IDX, 2)
    m.add_params(MT.ARG_COMPRESSION, "int8")
    m.add_params("flags", [1, "two", 3.5, np.int32(4), np.float32(0.25)])
    m.add_params("scalar", np.float32(1.5))
    m.trace = {"id": "0123456789ab", "src": 3, "seq": 7, "ts": 1712345678901234.5, "r": 2}
    return m


def _assert_equal_tree(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_equal_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_equal_tree(a, b)
    elif isinstance(want, np.ndarray) or isinstance(want, np.generic):
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(got) is type(want) and got == want


def test_message_encodes_to_identical_bytes_in_both_packages():
    tree = _tree()
    ours, theirs = _message(Message, tree).to_bytes(), _message(JaxMessage, tree).to_bytes()
    assert ours[:4] == b"FTM1"
    assert ours == theirs


def test_each_package_decodes_the_others_bytes():
    tree = _tree(1)
    ours, theirs = _message(Message, tree), _message(JaxMessage, tree)
    for decoded, sent in ((Message.from_bytes(theirs.to_bytes()), theirs),
                          (JaxMessage.from_bytes(ours.to_bytes()), ours)):
        assert (decoded.msg_type, decoded.sender_id, decoded.receiver_id) == (
            sent.msg_type, sent.sender_id, sent.receiver_id)
        assert decoded.trace == sent.trace
        assert list(decoded.params) == list(sent.params)
        for key, value in sent.params.items():
            _assert_equal_tree(decoded.params[key], _untuple(value))


def _untuple(tree):
    """JSON carries tuples as lists."""
    if isinstance(tree, dict):
        return {k: _untuple(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_untuple(v) for v in tree]
    return tree


def _sync_bytes(cls, model_tree) -> bytes:
    m = cls(MT.S2C_SYNC_MODEL, 0, 1)
    m.add_params(MT.ARG_MODEL_PARAMS, model_tree)
    m.add_params(MT.ARG_CLIENT_INDEX, 4)
    m.add_params(MT.ARG_ROUND_IDX, 1)
    m.trace = {"id": "feedfacecafe", "src": 0, "seq": 1, "ts": 5.0, "r": 1}
    return m.to_bytes()


@pytest.mark.parametrize("model_name", ["lr", "cnn"])
def test_wire_model_is_the_reference_model_tree_byte_for_byte(model_name):
    """A broadcast of the same weights: the port builds its model tree from
    torch-layout tensors (conv OIHW, dense [out, in]) with bridge.to_flax;
    the reference sends its flax tree as its server holds it (keys sorted
    by JAX's tree utilities). Same header, same buffers."""
    from fedml_tpu.models import create_model as jax_create_model

    shape, classes = ((5,), 3) if model_name == "lr" else ((28, 28, 1), 62)
    jmodel = jax_create_model(model_name, "femnist", shape, classes)
    host = jax.tree_util.tree_map(
        lambda a: np.ascontiguousarray(np.asarray(a)),
        jax.device_get(jmodel.init(jax.random.PRNGKey(3))),
    )
    got = wire_model(model_vars(host, "cpu"))
    assert _sync_bytes(Message, got) == _sync_bytes(JaxMessage, host)
    assert flat_params(got["params"]).keys() == flat_params(host["params"]).keys()


@pytest.mark.parametrize("model_name", ["lr", "cnn"])
def test_wire_model_decodes_to_contiguous_weights(model_name):
    """The wire's HWIO and [in, out] kernels come back as contiguous
    torch-layout tensors, equal to the weights that went out: a transposed
    view would run the layers on strided weights, through other kernels
    that sum in other orders."""
    from fedml_tpu_torch.models import create_model

    shape, classes = ((5,), 3) if model_name == "lr" else ((28, 28, 1), 62)
    sent = create_model(model_name, "femnist", shape, classes).init(torch.Generator().manual_seed(3))
    got = model_vars(wire_model(sent), "cpu")
    assert got.keys() == sent.keys()
    for k, v in got.items():
        assert v.is_contiguous(), k
        assert torch.equal(v, sent[k]), k


def test_leaf_order_is_jax_tree_flatten_order():
    tree = _tree(2)
    want = jax.tree_util.tree_leaves(tree)
    got = TZ.tree_leaves(tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a is b  # the same leaf objects, in the same order
    leaves, structure = TZ.tree_flatten(tree)
    rebuilt = TZ.tree_unflatten(structure, leaves)
    assert jax.tree_util.tree_structure(rebuilt) == jax.tree_util.tree_structure(tree)


@pytest.mark.parametrize("method", CODECS)
def test_codec_payloads_are_identical_and_decode_equal(method):
    rng = np.random.default_rng(4)
    w_round = _tree(5)
    # a round's update: small deltas, exact zeros and ties in one leaf
    w_local = jax.tree_util.tree_map(
        lambda a: a + 0.01 * rng.normal(size=a.shape).astype(np.float32), w_round
    )
    w_local["params"]["mid"] = w_round["params"]["mid"].copy()
    frac = 0.3
    got = TZ.encode_update(w_local, w_round, method, frac)
    want = JZ.encode_update(w_local, w_round, method, frac)
    assert list(got) == list(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert TZ.payload_bytes(got) == JZ.payload_bytes(want)
    # each side decodes either payload to the same model
    dec = TZ.decode_update(want, w_round, method)
    ref = JZ.decode_update(got, w_round, method)
    for a, b in zip(TZ.tree_leaves(dec), jax.tree_util.tree_leaves(ref)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [1, 7, 33])
def test_int4_nibble_packing_matches_at_odd_sizes(size):
    rng = np.random.default_rng(size)
    delta = {"b": rng.normal(size=size).astype(np.float32),
             "a": rng.normal(size=(size, 3)).astype(np.float32)}
    got, want = TZ.encode_int4(delta), JZ.encode_int4(delta)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))
    assert np.asarray(got["q0"]).size == (3 * size + 1) // 2  # "a" first: keys sorted


def test_error_feedback_residual_matches_reference():
    w_round = _tree(6)
    locals_ = [jax.tree_util.tree_map(lambda a, s=s: a * (1.0 + 0.01 * s), w_round) for s in (1, 2)]
    ours, theirs = TZ.ErrorFeedback(0.2, "topk"), JZ.ErrorFeedback(0.2, "topk")
    for w in locals_:  # the second round ships the first round's residual
        got, want = ours.encode(5, w, w_round), theirs.encode(5, w, w_round)
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))
