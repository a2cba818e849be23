"""The port's Ditto against the reference's on the CPU: 3 rounds on the CNN
slice (the global model, the rows, every personal model and the final
``Personalized/*`` keys) with the reference's global and personal
shuffles; λ = 0 giving plain local training bit for bit; unsampled
personal rows left at w_0; personalized eval on the clients' own test
shards where the dataset has them.

Tolerances: the slice's params and rows as the FedAvg slice is held (rtol
1e-4, atol 1e-5; 1e-4); the personal models the same (their steps are the
local train's with a proximal term); the accuracies exactly (both evaluate
the same integer counts)."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from fedml_tpu.algorithms.ditto import DittoAPI as JaxDitto  # noqa: E402

from fedml_tpu_torch.algorithms.ditto import DittoAPI, make_ditto_personal_train  # noqa: E402
from fedml_tpu_torch.bridge import to_flax_variables  # noqa: E402
from fedml_tpu_torch.train.client import make_local_train, seeded_perm_fn  # noqa: E402
from fedml_tpu_torch.train.evaluate import evaluate  # noqa: E402

from torch_parity import (  # noqa: E402
    SLICE, assert_slice_close, flat_params, jax_ditto_personal_perm_fn,
    lr_pair, private_reference_programs, trained_pair,
)


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def test_slice_matches_reference():
    kw = {"lam": 0.1}
    japi, tapi = trained_pair(
        JaxDitto, DittoAPI, jax_kw=kw,
        torch_kw={**kw, "personal_perm_fn": jax_ditto_personal_perm_fn(SLICE["seed"],
                                                                        SLICE["per_round"])},
        extras={"v_stack": lambda j: flat_params(jax.device_get(j.v_stack))},
    )
    jfinal, tfinal = japi.final, tapi.train()
    assert_slice_close(japi, tapi)
    want = japi.v_stack
    got = flat_params(to_flax_variables(tapi.state.stack, 1))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("Personalized/Acc", "Global/Acc", "num_clients_evaluated"):
        assert tfinal[k] == jfinal[k], (k, tfinal[k], jfinal[k])


def test_lambda_zero_is_plain_local_training():
    """The personal step at λ = 0 has no proximal term: bit-equal to the
    local train from the same personal model with the same shuffles."""
    _, tapi = lr_pair(JaxDitto, DittoAPI, batch_size=4)
    cfg = tapi.config
    personal = make_ditto_personal_train(tapi.model, cfg.train, cfg.fed.epochs, 0.0)
    plain = make_local_train(tapi.model, cfg.train, cfg.fed.epochs)
    x, y, mask, *_ = tapi._place_batch(tapi._round_batch(tapi._round_plan(0), 0), 0)
    v = {k: t + 0.05 for k, t in tapi.global_vars.items()}
    perm = lambda e, m: seeded_perm_fn(7)(0, 0, e, m)  # noqa: E731
    got, _ = personal(tapi.global_vars, v, x[0], y[0], mask[0], perm)
    want, _ = plain(v, x[0], y[0], mask[0], perm)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_unsampled_rows_stay_at_w0():
    _, tapi = lr_pair(JaxDitto, DittoAPI, fed={"client_num_per_round": 2}, batch_size=4)
    w0 = {k: v.clone() for k, v in tapi.global_vars.items()}
    tapi.train_round(0)
    sampled = {int(c) for c in tapi._round_plan(0)}
    for i in range(tapi.config.fed.client_num_in_total):
        row = tapi.state.row(i)
        same = all(torch.equal(row[k], w0[k]) for k in w0)
        assert same == (i not in sampled), i


def test_personalized_rows_on_client_test_shards():
    """With per-client test shards the personal models are evaluated there:
    the keys the reference adds to the final row, from each v_k on its
    client's own test shard."""
    _, tapi = lr_pair(JaxDitto, DittoAPI, batch_size=4)
    rng = np.random.default_rng(1)
    data = tapi.data
    tx = [rng.normal(size=(5,) + x.shape[1:]).astype(np.float32) for x in data.client_x]
    ty = [rng.integers(0, 3, size=5).astype(y.dtype) for y in data.client_y]
    tapi.data = dataclasses.replace(data, client_test_x=tx, client_test_y=ty)
    rows = []
    tapi.log_fn = rows.append
    final = tapi.train()
    assert {"Personalized/Acc", "Global/Acc", "num_clients_evaluated"} <= final.keys()
    assert rows[-1] == {k: final[k] for k in rows[-1]}
    accs = [evaluate(tapi.model, tapi.state.row(i), tx[i], ty[i])[1] for i in range(len(tx))]
    assert final["Personalized/Acc"] == pytest.approx(np.mean(accs), abs=1e-12)
    assert final["num_clients_evaluated"] == len(tx)
