"""Secure aggregation in the port (secagg/mpc.py, secagg/secure_aggregation.py
and the masked transport round) against the reference:

- the MPC primitives on seeded inputs: BGW shares and their decode, the
  Lagrange coefficients, LCC, additive shares, the DH public and shared
  keys, and the pair masks byte for byte;
- the transport's masking (``ClientParty`` uploads and recovery masks,
  ``ServerAggregator``'s unmasked average) on seeded keys gives the
  reference's field vectors and average, bit for bit (the trees are
  flattened in ``jax.tree_util``'s order: sorted keys, depth first);
- a secure loopback federation equals the plain one within the reference's
  own 5e-4 / 1e-3 (the 2^-16 fixed-point grid);
- a party that advertised its key and then died is recovered through the
  deadline, the quorum and the survivors' recovery masks; a party dead
  before its key leaves the registry and the round closes on quorum;
- a ``fedml_tpu`` server with ``secure_agg`` trains with the port's client
  managers — the pairwise masks cancel across the two packages — within
  1e-5 of the all-reference secure federation.

Tests that wait on deadlines run under their own time limit."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import fedml_tpu.config as jcfg  # noqa: E402
from fedml_tpu.data.synthetic import synthetic_classification as jax_synthetic  # noqa: E402
from fedml_tpu.secagg import mpc as jmpc  # noqa: E402
from fedml_tpu.secagg import secure_aggregation as jsa  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.algorithms import fedavg_transport as ft  # noqa: E402
from fedml_tpu_torch.algorithms.fedavg import weighted_average  # noqa: E402
from fedml_tpu_torch.core.comm import BaseCommManager  # noqa: E402
from fedml_tpu_torch.core.message import Message, MessageType as MT  # noqa: E402
from fedml_tpu_torch.data.synthetic import synthetic_classification  # noqa: E402
from fedml_tpu_torch.secagg import mpc as tmpc  # noqa: E402
from fedml_tpu_torch.secagg import secure_aggregation as tsa  # noqa: E402
from fedml_tpu_torch.telemetry import get_comm_meter  # noqa: E402

from torch_parity import (  # noqa: E402
    LR, jax_lr_model, jax_transport_perm_fn, lr_config, lr_data, private_reference_programs,
    time_limit, torch_lr_model,
)

SGD = dict(client_optimizer="sgd", lr=0.1)
SECURE = dict(secure_agg=True)
FIXED_POINT = dict(atol=5e-4, rtol=1e-3)  # tests/test_secure_transport.py's grid bound


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def test_share_math_matches_the_reference():
    X = np.random.default_rng(0).integers(0, tmpc.FIELD_PRIME, size=(3, 5), dtype=np.int64)
    for N, T in ((5, 2), (9, 4)):
        got = tmpc.bgw_encode(X, N, T, rng=np.random.default_rng(1))
        want = jmpc.bgw_encode(X, N, T, rng=np.random.default_rng(1))
        np.testing.assert_array_equal(got, want)
        idx = list(range(1, T + 2))
        np.testing.assert_array_equal(tmpc.bgw_decode(got[idx], idx), jmpc.bgw_decode(want[idx], idx))
        np.testing.assert_array_equal(tmpc.bgw_decode(got[idx], idx), X)
    alphas, betas = [3, 7, 11, 19], [2, 5, 13]
    np.testing.assert_array_equal(tmpc.gen_lagrange_coeffs(alphas, betas),
                                  jmpc.gen_lagrange_coeffs(alphas, betas))
    blocks = np.random.default_rng(2).integers(0, 1000, size=(3, 2, 4), dtype=np.int64)
    enc = tmpc.lcc_encode_with_points(blocks, alphas, betas)
    np.testing.assert_array_equal(enc, jmpc.lcc_encode_with_points(blocks, alphas, betas))
    np.testing.assert_array_equal(tmpc.lcc_decode_with_points(enc, alphas, betas), blocks)
    x = np.arange(12, dtype=np.int64).reshape(3, 4)
    np.testing.assert_array_equal(tmpc.gen_additive_shares(x, 4, rng=np.random.default_rng(3)),
                                  jmpc.gen_additive_shares(x, 4, rng=np.random.default_rng(3)))
    assert tmpc.modular_inv(12345) == jmpc.modular_inv(12345)


def test_key_agreement_and_pair_masks_match_the_reference():
    assert (tmpc.MODP_2048_P, tmpc.MODP_2048_G, tmpc.DH_SECRET_BITS) == (
        jmpc.MODP_2048_P, jmpc.MODP_2048_G, jmpc.DH_SECRET_BITS)
    a = tmpc.dh_secret(np.random.default_rng(4))
    b = tmpc.dh_secret(np.random.default_rng(5))
    assert a == jmpc.dh_secret(np.random.default_rng(4))
    assert tmpc.dh_public(a) == jmpc.dh_public(a)
    shared = tmpc.dh_shared(a, tmpc.dh_public(b))
    assert shared == jmpc.dh_shared(a, jmpc.dh_public(b)) == tmpc.dh_shared(b, tmpc.dh_public(a))
    for lo, hi, dim in ((0, 1, 1), (2, 7, 4097)):
        got = tmpc.derive_pair_mask(shared, lo, hi, dim)
        assert got.dtype == np.int64 and got.tobytes() == jmpc.derive_pair_mask(shared, lo, hi, dim).tobytes()
    for bad in (0, 1, tmpc.MODP_2048_P - 1):
        with pytest.raises(ValueError, match="degenerate"):
            tmpc.dh_shared(a, bad)


def _tree(rng, scale=1.0):
    # keys inserted out of order: the flattening must sort them as jax does
    return {"params": {
        "linear": {"kernel": (scale * rng.normal(size=(5, 3))).astype(np.float32),
                   "bias": (scale * rng.normal(size=(3,))).astype(np.float32)},
        "conv": {"kernel": (scale * rng.normal(size=(2, 2, 1, 4))).astype(np.float32)},
    }}


def _parties(mod, dim, n=4):
    """n parties of ``mod`` with keys from seeded generators, registered."""
    parties = [mod.ClientParty(i, dim, rng=np.random.default_rng(100 + i)) for i in range(n)]
    registry = {p.party: p.pk for p in parties}
    for p in parties:
        p.set_registry(registry)
    return parties


def test_round_masking_matches_the_reference():
    """The transport's masking on seeded keys: each party's masked upload,
    the survivors' recovery masks for a party that dropped, and the server's
    unmasked average equal the reference's bit for bit."""
    rng = np.random.default_rng(6)
    w_round = _tree(rng)
    locals_ = [jax.tree_util.tree_map(lambda a: a + 0.01 * np.float32(i + 1), w_round)
               for i in range(4)]
    ns = {0: 10.0, 1: 20.0, 2: 30.0, 3: 40.0}
    dim = tsa.tree_dim(w_round)
    assert dim == jsa.tree_dim(w_round)
    flat, spec = tsa.flatten_tree(w_round)
    np.testing.assert_array_equal(flat, jsa.flatten_tree(w_round)[0])
    back = tsa.unflatten_like(spec, flat)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(w_round)
    tparties, jparties = _parties(tsa, dim), _parties(jsa, dim)
    assert [p.pk for p in tparties] == [p.pk for p in jparties]
    tup = {p.party: p.masked_update(locals_[p.party], w_round, ns[p.party]) for p in tparties}
    jup = {p.party: p.masked_update(locals_[p.party], w_round, ns[p.party]) for p in jparties}
    for i in range(4):
        np.testing.assert_array_equal(tup[i], jup[i])
    for drop in (None, 2):  # party 2 drops after masking: the survivors unwind its masks
        averages = []
        for mod, parties, up in ((tsa, tparties, tup), (jsa, jparties, jup)):
            alive = [p for p in parties if p.party != drop]
            srv = mod.ServerAggregator(dim)
            total = srv.masked_sum({p.party: up[p.party] for p in alive})
            if drop is not None:
                total = srv.remove_dropout_masks(total, {p.party: p.recovery_mask([drop]) for p in alive})
            averages.append(srv.decode_average(total, {p.party: ns[p.party] for p in alive}, w_round))
        got, want = averages
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want), strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="field bound"):
        tparties[0].masked_update(_tree(rng, 10.0), w_round, 10_000.0)


def test_client_parties_cancel_across_the_packages():
    """Two port parties and two reference parties in one registry: the
    server's sum of their masked uploads is the plain sum."""
    rng = np.random.default_rng(8)
    w_round = _tree(rng)
    dim = tsa.tree_dim(w_round)
    parties = [tsa.ClientParty(0, dim), jsa.ClientParty(1, dim), tsa.ClientParty(2, dim),
               jsa.ClientParty(3, dim)]
    registry = {p.party: p.pk for p in parties}
    for p in parties:
        p.set_registry(registry)
    locals_ = [jax.tree_util.tree_map(lambda a: a + np.float32(0.01 * (i + 1)), w_round)
               for i in range(4)]
    uploads = {p.party: p.masked_update(locals_[p.party], w_round, 2.0) for p in parties}
    srv = tsa.ServerAggregator(dim)
    avg = srv.decode_average(srv.masked_sum(uploads), {i: 2.0 for i in range(4)}, w_round)
    for a, b in zip(jax.tree_util.tree_leaves(avg), jax.tree_util.tree_leaves(w_round)):
        np.testing.assert_allclose(a, b + np.float32(0.025), atol=2e-5)


def _port(comm=None, **fed):
    cfg = lr_config(tcfg, SGD, comm=comm)
    cfg = cfg.replace(fed=dataclasses.replace(cfg.fed, **fed))
    return cfg, lr_data(synthetic_classification), torch_lr_model()


def test_secure_loopback_matches_the_plain_one():
    plain = ft.run_loopback_federation(*_port(), device="cpu")
    secure = ft.run_loopback_federation(*_port(SECURE), device="cpu")
    assert secure.round_idx == LR["rounds"]
    for k in plain.global_vars:
        torch.testing.assert_close(secure.global_vars[k], plain.global_vars[k], **FIXED_POINT)
    assert [list(r) for r in secure.history] == [list(r) for r in plain.history]


def test_secure_agg_refuses_what_the_reference_refuses():
    cfg, data, model = _port(dict(SECURE, downlink_compression="int8"))
    with pytest.raises(ValueError, match="mutually exclusive"):
        ft.run_loopback_federation(cfg, data, model, device="cpu")


@time_limit(30)
def test_party_lost_after_its_key_is_recovered(monkeypatch):
    """Rank 4 advertises its key every round and never uploads: at the
    deadline the three survivors' uploads reach the quorum, each is asked
    for its recovery masks, and the round's average is exactly theirs."""
    real = ft.FedAvgClientManager._on_pubkeys

    def lost_after_key(self, msg):
        if self.rank != 4:
            real(self, msg)

    monkeypatch.setattr(ft.FedAvgClientManager, "_on_pubkeys", lost_after_key)
    cfg, data, model = _port(SECURE, comm_round=1, deadline_s=1.0, min_clients=2)
    get_comm_meter().reset()
    server = ft.run_loopback_federation(cfg, data, model, device="cpu")
    assert get_comm_meter().snapshot()["messages_sent"].get(MT.S2C_RECOVER) == 3
    w0 = model.init(torch.Generator().manual_seed(cfg.seed))
    locals_, ns = [], []
    for cid in (0, 1, 2):
        trainer = ft.LocalTrainer(cfg, data, model, device="cpu")
        trainer.update_dataset(cid)
        w, n = trainer.train(0, w0)
        locals_.append(w)
        ns.append(float(n))
    want = weighted_average({k: torch.stack([w[k] for w in locals_]) for k in w0}, torch.tensor(ns))
    for k in want:
        torch.testing.assert_close(server.global_vars[k], want[k], **FIXED_POINT)


@time_limit(30)
def test_party_dead_before_its_key_leaves_the_registry(monkeypatch):
    real = ft.FedAvgClientManager._on_sync

    def dying(self, msg):
        if not (self.rank == 4 and msg.get(MT.ARG_ROUND_IDX) >= 1):
            real(self, msg)

    monkeypatch.setattr(ft.FedAvgClientManager, "_on_sync", dying)
    cfg, data, model = _port(SECURE, comm_round=2, deadline_s=1.0, min_clients=2)
    server = ft.run_loopback_federation(cfg, data, model, device="cpu")
    assert server.round_idx == 2
    assert all(np.isfinite(v.numpy()).all() for v in server.global_vars.values())
    assert np.isfinite(server.history[-1]["Test/Loss"])


_STOP = object()


class _HubComm(BaseCommManager):
    """A port comm manager on a ``fedml_tpu`` LoopbackHub: the same FTM1
    bytes on the hub's queues as the reference's managers put there."""

    def __init__(self, hub, rank):
        super().__init__()
        self._hub, self._inbox = hub, hub.inbox(rank)

    def _send(self, msg):
        self._hub.inbox(msg.get_receiver_id()).put(msg.to_bytes())

    def handle_receive_message(self):
        for item in iter(self._inbox.get, _STOP):
            self.notify(Message.from_bytes(item))

    def stop_receive_message(self):
        self._inbox.put(_STOP)


@time_limit(60)
def test_reference_secure_server_trains_with_port_clients():
    from fedml_tpu.algorithms.fedavg_transport import (
        FedAvgServerManager as JaxServer, run_loopback_federation as jax_loopback,
    )
    from fedml_tpu.core.loopback import LoopbackCommManager as JaxLoopback, LoopbackHub

    ref_cfg = lr_config(jcfg, SGD, comm=SECURE)
    ref = jax_loopback(ref_cfg, lr_data(jax_synthetic), jax_lr_model())
    hub = LoopbackHub()
    server = JaxServer(ref_cfg, JaxLoopback(hub, 0), jax_lr_model(), data=lr_data(jax_synthetic))
    cfg, data, model = _port(SECURE)
    clients = [
        ft.FedAvgClientManager(cfg, _HubComm(hub, rank), rank,
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
    server.send_init_msg()
    server.run()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    assert server.round_idx == ref.round_idx == LR["rounds"]
    got = jax.device_get(server.global_vars)["params"]["linear"]
    want = jax.device_get(ref.global_vars)["params"]["linear"]
    for leaf in want:
        np.testing.assert_allclose(np.asarray(got[leaf]), np.asarray(want[leaf]), rtol=1e-5,
                                   atol=1e-5, err_msg=leaf)
    for mrow, rrow in zip(server.history, ref.history, strict=True):
        if "Test/Acc" in rrow:
            assert abs(mrow["Test/Acc"] - rrow["Test/Acc"]) <= 1e-5
