"""``eval_on_clients`` (``FedAvgAPI.local_test_on_all_clients``) against
``fedml_tpu`` on the CPU, on the reference's own fixture
(tests/test_local_eval.py: 5 logistic-regression clients with a per-client
test split). The reference runs with a private program store
(``torch_parity.private_reference_programs``): the session store breaks
its own test_local_eval.py in this container.

- From the same variables, the pooled rows equal the reference's
  (Train/Test Loss and Acc), and equal the per-client sums weighted by
  sample counts;
- ``fed.ci`` evaluates client 0 only;
- without a per-client split the test rows are the central test set's;
- in the round loop, eval rounds carry the reference's keys and values
  (the all-client metrics replace the cohort's train metrics).
Tolerance: ROW_TOL, the same float32 sums in another order."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import fedml_tpu.config as jcfg  # noqa: E402
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvg  # noqa: E402
from fedml_tpu.data.base import FederatedDataset as JaxDataset  # noqa: E402
from fedml_tpu.data.synthetic import synthetic_classification as jax_synthetic  # noqa: E402
from fedml_tpu.models import create_model as jax_create_model  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.algorithms import FedAvgAPI  # noqa: E402
from fedml_tpu_torch.data.base import FederatedDataset  # noqa: E402
from fedml_tpu_torch.data.synthetic import synthetic_classification  # noqa: E402
from fedml_tpu_torch.models import create_model  # noqa: E402
from fedml_tpu_torch.train.evaluate import pad_to_batches  # noqa: E402

from torch_parity import jax_round_perm_fn, private_reference_programs, share_init  # noqa: E402

ROW_TOL = 1e-5
CLASSES, FEAT = 3, (5,)


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _data(synthetic, dataset_cls, client_tests=True):
    base = synthetic(num_clients=5, num_classes=CLASSES, feat_shape=FEAT,
                     samples_per_client=20, partition_method="homo", seed=2)
    if not client_tests:
        return base
    rng = np.random.default_rng(9)
    ctx = [rng.normal(size=(6 + i, *FEAT)).astype(np.float32) for i in range(5)]
    cty = [rng.integers(0, CLASSES, size=(6 + i,)).astype(np.int32) for i in range(5)]
    return dataset_cls(name=base.name, client_x=base.client_x, client_y=base.client_y,
                       test_x=base.test_x, test_y=base.test_y, num_classes=base.num_classes,
                       client_test_x=ctx, client_test_y=cty)


def _cfg(mod, ci=False, eval_on_clients=False):
    return mod.RunConfig(
        data=mod.DataConfig(batch_size=16),
        fed=mod.FedConfig(client_num_in_total=5, client_num_per_round=5, comm_round=2,
                          frequency_of_the_test=1, ci=ci, eval_on_clients=eval_on_clients),
        train=mod.TrainConfig(client_optimizer="sgd", lr=0.1),
        seed=0,
    )


def _pair(client_tests=True, **cfg_kw):
    japi = JaxFedAvg(_cfg(jcfg, **cfg_kw), _data(jax_synthetic, JaxDataset, client_tests),
                     jax_create_model("lr", "synthetic", FEAT, CLASSES))
    tapi = FedAvgAPI(_cfg(tcfg, **cfg_kw), _data(synthetic_classification, FederatedDataset,
                                                 client_tests),
                     create_model("lr", "synthetic", FEAT, CLASSES), device="cpu",
                     perm_fn=jax_round_perm_fn(0, 5))
    share_init(japi, tapi)
    return japi, tapi


def _assert_rows_close(got, want):
    assert got.keys() >= {k for k in want if k != "round_time_s"}
    for k, w in want.items():
        if k != "round_time_s":
            assert abs(got[k] - w) <= ROW_TOL * max(1.0, abs(w)), (k, got[k], w)


def _weighted(tapi, xs, ys):
    """Per-client sums, sample-weighted: the reference's definition."""
    tot = np.zeros(3)
    for x, y in zip(xs, ys):
        m = tapi.eval_fn(tapi.global_vars, *map(torch.from_numpy, pad_to_batches(x, y, 16)))
        tot += [float(m["loss_sum"]), float(m["correct"]), float(m["count"])]
    return tot[0] / tot[2], tot[1] / tot[2]


def test_rows_equal_the_reference_and_the_weighted_per_client_sums():
    japi, tapi = _pair()
    got, want = tapi.local_test_on_all_clients(round_idx=0), japi.local_test_on_all_clients(0)
    assert set(got) == set(want) == {"round", "Train/Loss", "Train/Acc", "Test/Loss", "Test/Acc"}
    _assert_rows_close(got, want)
    data = tapi.data
    loss, acc = _weighted(tapi, data.client_x, data.client_y)
    assert abs(got["Train/Loss"] - loss) <= ROW_TOL and abs(got["Train/Acc"] - acc) <= 1e-6
    loss, acc = _weighted(tapi, data.client_test_x, data.client_test_y)
    assert abs(got["Test/Loss"] - loss) <= ROW_TOL and abs(got["Test/Acc"] - acc) <= 1e-6


def test_ci_short_circuits_to_client_zero():
    japi, tapi = _pair(ci=True)
    got = tapi.local_test_on_all_clients()
    _assert_rows_close(got, japi.local_test_on_all_clients())
    loss, acc = _weighted(tapi, tapi.data.client_x[:1], tapi.data.client_y[:1])
    assert abs(got["Train/Loss"] - loss) <= ROW_TOL and abs(got["Train/Acc"] - acc) <= 1e-6


def test_no_client_test_split_falls_back_to_the_central_set():
    japi, tapi = _pair(client_tests=False)
    got = tapi.local_test_on_all_clients()
    _assert_rows_close(got, japi.local_test_on_all_clients())
    loss, acc = tapi.evaluate_global()
    assert got["Test/Acc"] == acc and got["Test/Loss"] == loss


def test_eval_on_clients_rows_in_the_round_loop_match_the_reference():
    japi, tapi = _pair(eval_on_clients=True)
    jfinal, tfinal = japi.train(), tapi.train()
    assert len(tapi.history) == len(japi.history) == 2
    for got, want in zip(tapi.history, japi.history):
        assert set(got) == set(want)
        _assert_rows_close(got, want)
    _assert_rows_close(tfinal, jfinal)
    # the all-client train metrics replaced the cohort's
    cohort_mean = tapi.scheduler.state_dict()["loss_vals"][0]
    assert tapi.history[-1]["Train/Loss"] != cohort_mean
    # the pooled shards are placed once
    first = tapi._local_eval_dev
    tapi.local_test_on_all_clients(5)
    assert tapi._local_eval_dev is first


def test_eval_rounds_follow_frequency_of_the_test():
    japi, tapi = _pair(eval_on_clients=True)
    cfg = tapi.config
    tapi.config = cfg.replace(fed=dataclasses.replace(cfg.fed, comm_round=4, frequency_of_the_test=3))
    tapi.train()
    assert ["Test/Acc" in r for r in tapi.history] == [True, False, False, True]
