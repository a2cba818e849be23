"""Straggler deadlines and quorum rounds in the port's transport
(``fed.deadline_s``, ``fed.min_clients``), held to the assertions of the
reference's tests/test_straggler.py and tests/test_scheduler.py that pass
there:

- a client slower than the deadline every round: the rounds close without
  it, the history is complete with finite losses, its late round-tagged
  upload is dropped, and the run's wall time stays bounded;
- ``deadline_s = 0`` is bit-equal to the plain federation;
- a round that loses a client to a dropout closes on the quorum with
  exactly the survivors' sample-weighted average;
- the stall valve: when a plan drops every client, each round is abandoned
  after three barren deadlines with the model unchanged.

Each test waits on deadlines and runs under its own time limit."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from fedml_tpu_torch import config as tcfg
from fedml_tpu_torch.algorithms.fedavg import weighted_average
from fedml_tpu_torch.algorithms.fedavg_transport import (
    LocalTrainer, run_federation, run_loopback_federation,
)
from fedml_tpu_torch.core.loopback import LoopbackCommManager, LoopbackHub
from fedml_tpu_torch.data.synthetic import synthetic_classification
from fedml_tpu_torch.models import create_model

from torch_parity import time_limit


def _data(num_clients=3):
    return synthetic_classification(num_clients=num_clients, num_classes=3, feat_shape=(5,),
                                    samples_per_client=12, partition_method="homo", seed=9)


def _model():
    return create_model("lr", "synthetic", (5,), 3)


def _cfg(**fed_kw):
    fed = dict(client_num_in_total=3, client_num_per_round=3, comm_round=2, epochs=1,
               frequency_of_the_test=1)
    fed.update(fed_kw)
    return tcfg.RunConfig(data=tcfg.DataConfig(batch_size=-1), fed=tcfg.FedConfig(**fed),
                          train=tcfg.TrainConfig(client_optimizer="sgd", lr=0.1), seed=0)


class _SlowTrainer(LocalTrainer):
    def __init__(self, *a, delay_s=0.0, **kw):
        super().__init__(*a, **kw)
        self.delay_s = delay_s

    def train(self, round_idx, variables):
        time.sleep(self.delay_s)
        return super().train(round_idx, variables)


@time_limit(40)
def test_deadline_completes_rounds_without_the_straggler():
    data, model = _data(), _model()
    # 4 rounds at a 1 s deadline keep the server alive ~4 s, so the
    # straggler's 2.5 s round-0 upload lands while it still serves (round
    # ~2) and must be dropped by its round tag
    cfg = _cfg(deadline_s=1.0, min_clients=2, comm_round=4)
    hub = LoopbackHub()
    t0 = time.perf_counter()
    server = run_federation(
        cfg, data, model, lambda rank: LoopbackCommManager(hub, rank),
        trainer_factory=lambda rank: _SlowTrainer(
            cfg, data, model, device="cpu", delay_s=2.5 if rank == 3 else 0.0),
        device="cpu",
    )
    wall = time.perf_counter() - t0
    assert server.round_idx == 4 and len(server.history) == 4
    assert all(np.isfinite(r["Test/Loss"]) for r in server.history)
    assert all(loss is not None and np.isfinite(loss) for loss in server.train_losses)
    assert server.dropped_uploads >= 1
    # gross bound: run_federation joins the straggler's thread, which
    # finishes its ~10 s of sleeps before it takes FINISH
    assert wall < 30.0


@time_limit(20)
def test_no_deadline_is_bit_equal_to_the_plain_federation():
    data, model = _data(), _model()
    ref = run_loopback_federation(_cfg(), data, model, device="cpu")
    hub = LoopbackHub()
    got = run_federation(_cfg(deadline_s=0.0), data, _model(),
                         lambda rank: LoopbackCommManager(hub, rank), device="cpu")
    assert got.dropped_uploads == 0 and got.abandoned_rounds == 0
    for k in ref.global_vars:
        assert torch.equal(ref.global_vars[k], got.global_vars[k]), k
    assert got.train_losses == ref.train_losses


@time_limit(20)
def test_quorum_round_aggregates_exactly_the_survivors():
    """Client 0 drops; min_clients 2 pins the quorum to both survivors, so
    the round closes at the deadline on their two uploads."""
    data, model = _data(), _model()
    cfg = _cfg(comm_round=1, deadline_s=1.0, min_clients=2,
               fault_plan='{"seed": 1, "clients": {"0": {"dropout_p": 1.0}}}')
    rows = []
    server = run_loopback_federation(cfg, data, model, device="cpu", log_fn=rows.append)
    w0 = model.init(torch.Generator().manual_seed(cfg.seed))
    locals_, ns = [], []
    for cid in (1, 2):
        trainer = LocalTrainer(cfg, data, model, device="cpu")
        trainer.update_dataset(cid)
        w, n = trainer.train(0, w0)
        locals_.append(w)
        ns.append(float(n))
    stacked = {k: torch.stack([w[k] for w in locals_]) for k in w0}
    want = weighted_average(stacked, torch.tensor(ns))
    for k in want:
        torch.testing.assert_close(server.global_vars[k], want[k], rtol=1e-6, atol=0)
    assert rows[-1]["faults/dropouts"] == 1 and rows[-1]["faults/total"] == 1


@time_limit(20)
def test_all_dropped_rounds_are_abandoned_instead_of_hanging():
    data, model = _data(), _model()
    cfg = _cfg(deadline_s=0.3, min_clients=2, fault_plan='{"default": {"dropout_p": 1.0}}')
    t0 = time.perf_counter()
    server = run_loopback_federation(cfg, data, model, device="cpu")
    wall = time.perf_counter() - t0
    assert [r["round"] for r in server.history] == [0, 1]
    assert server.abandoned_rounds == 2
    assert server.train_losses == [None, None]
    w0 = model.init(torch.Generator().manual_seed(cfg.seed))
    for k in w0:
        assert torch.equal(server.global_vars[k], w0[k]), k  # nobody trained
    assert wall >= 2 * 3 * 0.3  # three deadlines a round


def test_a_plan_that_drops_needs_a_deadline():
    cfg = _cfg(fault_plan='{"default": {"dropout_p": 0.5}}')
    with pytest.raises(ValueError, match="deadline_s"):
        run_loopback_federation(cfg, _data(), _model(), device="cpu")
    cfg = cfg.replace(comm=dataclasses.replace(cfg.comm, compression="topk", error_feedback=True),
                      fed=dataclasses.replace(cfg.fed, fault_plan="", deadline_s=1.0))
    with pytest.raises(ValueError, match="error_feedback"):
        run_loopback_federation(cfg, _data(), _model(), device="cpu")
