"""The port's cross-silo transport on the CPU, on the transport tests'
logistic-regression fixture (tests/test_transport_algorithms.py; full
batch, so every runtime takes one step of every sample and the shuffles do
not matter):

- in the port, loopback equals the simulator for FedAvg, FedOpt (FedAdam)
  and FedProx (prox_mu 0.1, E=3), FedProx differs from FedAvg, and shared
  memory is bit-equal to loopback;
- the port's loopback federation equals the reference's simulator in params,
  in each round's train loss (the port server's ``train_losses``) and in
  each history row's Test/Acc, and with int8 up- and
  downlink it meters the reference's ``comm/uplink_*`` / ``comm/downlink_*``
  bytes;
- a mixed federation — the reference's server on a ``fedml_tpu``
  LoopbackHub training with the port's client managers — equals the
  all-reference federation;
- the port's client trainer takes the reference client's minibatches and
  shuffles at batch 4 (client-index keyed permutations);
- at batch 4 the port's simulator, trained on the actors' own minibatches
  (``actor_order_perm_fn``), is bit-equal to the loopback federation;
- with overprovisioning (one worker a slot) and power-of-choice the port's
  federation selects the reference federation's cohorts, and secure
  aggregation refuses an overprovisioned worker count as the reference's
  server does.

The reference's programs run with a private program cache and executable
store (torch_parity.private_reference_programs): the session store keys an
executable without its input sharding, and the reference's own
transport-vs-simulator tests are red for it (a mesh-sharded eval program
handed to a single-device call)."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import fedml_tpu.config as jcfg  # noqa: E402
from fedml_tpu.data.synthetic import synthetic_classification as jax_synthetic  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.algorithms import FedAvgAPI, FedOptAPI  # noqa: E402
from fedml_tpu_torch.algorithms.fedavg_transport import (  # noqa: E402
    FedAvgClientManager, LocalTrainer, actor_order_perm_fn, run_loopback_federation,
    run_mqtt_federation, run_shm_federation,
)
from fedml_tpu_torch.bridge import from_flax, to_flax  # noqa: E402
from fedml_tpu_torch.core.comm import BaseCommManager  # noqa: E402
from fedml_tpu_torch.core.message import Message  # noqa: E402
from fedml_tpu_torch.data.synthetic import synthetic_classification  # noqa: E402
from fedml_tpu_torch.telemetry import get_comm_meter  # noqa: E402

from torch_parity import (  # noqa: E402
    LR, jax_lr_model, jax_transport_perm_fn, lr_config, lr_data, private_reference_programs,
    torch_lr_model,
)

SGD = dict(client_optimizer="sgd", lr=0.1)
FEDADAM = dict(server_optimizer="adam", server_lr=0.05)
ATOL = 1e-5  # the reference's transport-vs-simulator tolerance


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _port(train=SGD, server=None, comm=None, epochs=1, batch_size=-1):
    cfg = lr_config(tcfg, train, server, comm, epochs, batch_size)
    return cfg, lr_data(synthetic_classification), torch_lr_model()


def _ref(train=SGD, server=None, comm=None, epochs=1):
    return lr_config(jcfg, train, server, comm, epochs), lr_data(jax_synthetic), jax_lr_model()


def _assert_vars_close(got, want, atol=ATOL):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=atol, atol=atol, err_msg=k)


def _ref_params(vars_):
    return {k: np.asarray(v) for k, v in jax.device_get(vars_)["params"]["linear"].items()}


def _assert_ref_close(port_vars, ref_vars, atol=ATOL):
    got, want = to_flax(port_vars)["linear"], _ref_params(ref_vars)
    for leaf in want:
        np.testing.assert_allclose(got[leaf], want[leaf], rtol=atol, atol=atol, err_msg=leaf)


@pytest.mark.parametrize(
    "algo,train,epochs",
    [("fedavg", SGD, 1), ("fedopt", SGD, 1), ("fedprox", dict(SGD, prox_mu=0.1), 3)],
)
def test_loopback_matches_port_simulator(algo, train, epochs):
    server = FEDADAM if algo == "fedopt" else None
    cfg, data, model = _port(train, server, epochs=epochs)
    sim = (FedOptAPI if algo == "fedopt" else FedAvgAPI)(cfg, data, model, device="cpu")
    sim.train()
    fed = run_loopback_federation(cfg, data, torch_lr_model(), server_opt=algo == "fedopt",
                                  device="cpu")
    assert fed.round_idx == LR["rounds"]
    _assert_vars_close(fed.global_vars, sim.global_vars)
    for srow, frow, loss in zip(sim.history, fed.history, fed.train_losses, strict=True):
        assert abs(srow["Train/Loss"] - loss) <= ATOL
        assert ("Test/Acc" in srow) == ("Test/Acc" in frow)
        if "Test/Acc" in srow:
            assert abs(srow["Test/Acc"] - frow["Test/Acc"]) <= ATOL
    if algo == "fedprox":
        # with one local step the prox gradient mu(w - w_g) is zero; at E=3
        # it changes the trajectory against plain FedAvg
        plain = FedAvgAPI(*_port(SGD, epochs=3), device="cpu")
        plain.train()
        diff = max((plain.global_vars[k] - sim.global_vars[k]).abs().max().item()
                   for k in plain.global_vars)
        assert diff > 1e-4


@pytest.mark.parametrize("algo", ["fedavg", "fedopt"])
def test_simulator_on_the_actors_minibatches_is_bit_equal_to_loopback(algo):
    """At batch 4 (3 steps a client) the simulator, given the actors' row
    orders and client-index keyed shuffles, takes the federation's float32
    steps on the same batches at the same shapes, and averages and steps
    the server the same way: bit-equal, as chip_smoke.py's phase_transport
    requires of the two at batch 20 on the card."""
    server = FEDADAM if algo == "fedopt" else None
    cfg, data, model = _port(server=server, batch_size=4)
    # the actors train one client at a time: the simulator's loop schedule
    # (lr's "auto" is the batched one, whose batched matmuls round otherwise)
    cfg = cfg.replace(fed=dataclasses.replace(cfg.fed, client_parallelism="scan"))
    sim = (FedOptAPI if algo == "fedopt" else FedAvgAPI)(
        cfg, data, model, device="cpu", perm_fn=actor_order_perm_fn(cfg, data))
    sim.train()
    fed = run_loopback_federation(cfg, data, torch_lr_model(), server_opt=algo == "fedopt",
                                  device="cpu")
    for k in sim.global_vars:
        assert torch.equal(fed.global_vars[k], sim.global_vars[k]), k
    # and the shuffles matter: the simulator's own slot-keyed ones differ
    own = (FedOptAPI if algo == "fedopt" else FedAvgAPI)(cfg, data, torch_lr_model(), device="cpu")
    own.train()
    assert any(not torch.equal(own.global_vars[k], sim.global_vars[k]) for k in sim.global_vars)


@pytest.mark.parametrize("comm", [None, dict(compression="int8", downlink_compression="int8")])
def test_shm_is_bit_equal_to_loopback(comm):
    cfg, data, model = _port(server=FEDADAM, comm=comm)
    loop = run_loopback_federation(cfg, data, model, server_opt=True, device="cpu")
    shm = run_shm_federation(cfg, data, torch_lr_model(), server_opt=True, device="cpu")
    for k in loop.global_vars:
        assert torch.equal(loop.global_vars[k], shm.global_vars[k]), k
    assert loop.train_losses == shm.train_losses


@pytest.mark.parametrize("algo", ["fedavg", "fedopt"])
def test_loopback_matches_reference_simulator(algo):
    """The port's federation from the reference simulator's init against
    the reference simulator: params, the train loss and Test/Acc round by
    round (the port server's ``train_losses`` hold the uploads' loss
    weighted by their sample counts, the simulator's ΣLoss/ΣCount)."""
    from fedml_tpu.algorithms import FedAvgAPI as JaxFedAvg
    from fedml_tpu.algorithms.fedopt import FedOptAPI as JaxFedOpt

    server = FEDADAM if algo == "fedopt" else None
    japi = (JaxFedOpt if algo == "fedopt" else JaxFedAvg)(*_ref(server=server))
    init = from_flax(jax.device_get(japi.global_vars)["params"])
    japi.train()
    cfg, data, model = _port(server=server)
    fed = run_loopback_federation(cfg, data, model, server_opt=algo == "fedopt", device="cpu",
                                  init_vars=init)
    _assert_ref_close(fed.global_vars, japi.global_vars)
    for jrow, frow, loss in zip(japi.history, fed.history, fed.train_losses, strict=True):
        assert abs(jrow["Train/Loss"] - loss) <= ATOL, (jrow, loss)
        assert ("Test/Acc" in jrow) == ("Test/Acc" in frow)
        if "Test/Acc" in jrow:
            assert abs(jrow["Test/Acc"] - frow["Test/Acc"]) <= ATOL, (jrow, frow)


def test_compressed_wire_meters_the_reference_bytes():
    """int8 uplink deltas and int8 downlink broadcasts: the payload bytes
    as shipped and their float32 equivalents, metered by each package's
    comm meter over the same 3-round federation, are equal; and the two
    servers' history rows hold the same keys in the same order."""
    from fedml_tpu.algorithms.fedavg_transport import run_loopback_federation as jax_loopback
    from fedml_tpu.telemetry import get_comm_meter as jax_comm_meter

    comm = dict(compression="int8", downlink_compression="int8")
    keys = ("uplink_payload_bytes", "uplink_raw_bytes", "uplink_updates",
            "downlink_payload_bytes", "downlink_raw_bytes", "downlink_updates")
    jax_comm_meter().reset()
    jserver = jax_loopback(*_ref(comm=comm))
    want = {k: jax_comm_meter().snapshot()[k] for k in keys}
    # the reference server's init: model.init(fold_in(PRNGKey(seed), 0))
    init = jax.device_get(jax_lr_model().init(jax.random.fold_in(jax.random.PRNGKey(LR["seed"]), 0)))
    get_comm_meter().reset()
    fed = run_loopback_federation(*_port(comm=comm), device="cpu",
                                  init_vars=from_flax(init["params"]))
    got = {k: get_comm_meter().snapshot()[k] for k in keys}
    assert got == want
    assert [list(row) for row in fed.history] == [list(row) for row in jserver.history]
    assert want["uplink_updates"] == want["downlink_updates"] == LR["num_clients"] * LR["rounds"]
    assert want["uplink_payload_bytes"] < want["uplink_raw_bytes"]
    # and the two runs trained the same model within a quantization step
    _assert_ref_close(fed.global_vars, jserver.global_vars, atol=1e-3)


_STOP = object()


class _RefHubComm(BaseCommManager):
    """A port comm manager on a ``fedml_tpu`` LoopbackHub: it puts and
    takes the same FTM1 bytes on the hub's queues as the reference's
    managers do."""

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


def test_reference_server_trains_with_port_clients():
    """The reference's FedAvgServerManager and the port's client managers
    on one hub, 3 rounds at full batch, against the all-reference
    federation: params and each row's Test/Acc within 1e-5."""
    from fedml_tpu.algorithms.fedavg_transport import (
        FedAvgServerManager as JaxServer, run_loopback_federation as jax_loopback,
    )
    from fedml_tpu.core.loopback import LoopbackCommManager as JaxLoopback, LoopbackHub

    ref = jax_loopback(*_ref())
    jconfig, jdata, jmodel = _ref()
    hub = LoopbackHub()
    server = JaxServer(jconfig, JaxLoopback(hub, 0), jmodel, data=jdata)
    cfg, data, model = _port()
    clients = [
        FedAvgClientManager(cfg, _RefHubComm(hub, rank), rank,
                            LocalTrainer(cfg, data, model, device="cpu",
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
        t.join(timeout=60)
    assert not errors, errors
    assert server.round_idx == ref.round_idx == LR["rounds"]
    got, want = _ref_params(server.global_vars), _ref_params(ref.global_vars)
    for leaf in want:
        np.testing.assert_allclose(got[leaf], want[leaf], rtol=ATOL, atol=ATOL, err_msg=leaf)
    for mrow, rrow in zip(server.history, ref.history, strict=True):
        assert ("Test/Acc" in mrow) == ("Test/Acc" in rrow)
        if "Test/Acc" in rrow:
            assert abs(mrow["Test/Acc"] - rrow["Test/Acc"]) <= ATOL


def test_local_trainer_takes_the_reference_clients_minibatches():
    """One client's local train at batch 4, 2 epochs: the port's trainer
    stacks the shard with the reference's seed and shuffles it with the
    reference's client-index keyed permutations, so the float32 SGD steps
    are the same up to summation order (atol 1e-6)."""
    from fedml_tpu.algorithms.fedavg_transport import LocalTrainer as JaxTrainer

    jconfig = lr_config(jcfg, SGD, epochs=2, batch_size=4)
    cfg, data, model = _port(epochs=2, batch_size=4)
    jtrainer = JaxTrainer(jconfig, lr_data(jax_synthetic), jax_lr_model(), "classification")
    trainer = LocalTrainer(cfg, data, model, device="cpu", perm_fn=jax_transport_perm_fn(cfg.seed))
    variables = jax.device_get(jax_lr_model().init(jax.random.PRNGKey(1)))
    for round_idx, client in ((0, 2), (3, 1)):
        jtrainer.update_dataset(client)
        trainer.update_dataset(client)
        want, jn = jtrainer.train(round_idx, variables)
        got, n = trainer.train(round_idx, from_flax(variables["params"]))
        assert n == jn
        _assert_ref_close(got, want, atol=1e-6)
        assert abs(trainer.last_loss - jtrainer.last_loss) <= 1e-6


def _selections(rows) -> dict:
    return {r["round"]: r["scheduler/selected"] for r in rows if "scheduler/selected" in r}


@pytest.mark.parametrize("fed_kw", [
    dict(overprovision_factor=1.5),
    dict(selection="power_of_choice"),
    dict(selection="power_of_choice", overprovision_factor=1.5),
])
def test_adaptive_cohorts_over_loopback_match_the_reference_federation(fed_kw):
    """2 of 4 clients a round (3 with overprovisioning 1.5: one worker a
    slot), 3 rounds: the port's loopback federation selects the reference
    federation's cohorts (power-of-choice on the uploads' train losses)
    and ends within ATOL of its params, from the same init."""
    from fedml_tpu.algorithms.fedavg_transport import (
        run_loopback_federation as jax_run_loopback,
    )

    def cfg_for(cfg):
        return cfg.replace(fed=dataclasses.replace(cfg.fed, client_num_per_round=2, **fed_kw))

    jcfg_, jdata, jmodel = _ref()
    jrows, trows = [], []
    jfed = jax_run_loopback(cfg_for(jcfg_), jdata, jmodel, log_fn=jrows.append)
    cfg, data, model = _port()
    init = from_flax(jax.device_get(jmodel.init(jax.random.fold_in(jax.random.PRNGKey(0), 0)))["params"])
    fed = run_loopback_federation(cfg_for(cfg), data, model, device="cpu", init_vars=init,
                                  log_fn=trows.append)
    want = 3 if fed_kw.get("overprovision_factor") else 2
    assert fed.worker_num == jfed.worker_num == want
    assert _selections(trows) == _selections(jrows) and len(_selections(trows)) == LR["rounds"]
    assert all(len(c) == want for c in _selections(trows).values())
    _assert_ref_close(fed.global_vars, jfed.global_vars)


def test_secure_agg_refuses_an_overprovisioned_worker_count():
    """The reference server's check: clients size the mask registry from
    client_num_per_round, so another worker count is refused."""
    from fedml_tpu.algorithms.fedavg_transport import (
        run_loopback_federation as jax_run_loopback,
    )

    def over(cfg):
        return cfg.replace(fed=dataclasses.replace(cfg.fed, client_num_per_round=2,
                                                   overprovision_factor=1.5))

    with pytest.raises(ValueError, match="secure_agg requires worker_num"):
        jax_run_loopback(over(_ref(comm=dict(secure_agg=True))[0]), *_ref()[1:])
    cfg, data, model = _port(comm=dict(secure_agg=True))
    with pytest.raises(ValueError, match=r"secure_agg requires worker_num \(3\) == "
                                         r"client_num_per_round \(2\)"):
        run_loopback_federation(over(cfg), data, model, device="cpu")


def test_unported_entry_points_raise():
    cfg, data, model = _port()
    for run in (run_loopback_federation, run_mqtt_federation):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            run(cfg, data, model, device="cpu", warmup=True)


def test_federation_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where there is no card")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_loopback_federation(*_port())

