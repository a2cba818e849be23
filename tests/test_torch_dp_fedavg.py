"""DP-FedAvg and its RDP ledger (``privacy/``) against ``fedml_tpu.privacy``
on the CPU.

- The accountant is the reference's float64 host arithmetic: epsilon and
  its order equal over a (q, z, rounds, delta) grid (EPS_RTOL).
- Poisson cohorts are the reference's numpy stream: equal, exactly, for
  every (secret, round); so are the secret's uint32 words.
- ``clip_update_tree`` clips the norm over every leaf as the reference's.
- DP rounds from the reference's init, with its shuffles (split, as the
  reference splits them, over ``bucket_cohort(m)`` slots) and its noise
  (``torch_parity.jax_noise_fn``): the FEMNIST slice for 3 rounds of one
  full-batch step a client (at batch 20 the noised rounds are chaotic:
  the two packages' last-bit differences reach 9e-3 of the params by
  round 3, against 1.3e-6 at full batch, measured) and the
  logistic-regression fixture's empty cohort (the model moves by noise
  alone) match the reference within ROUND_TOL.
- A checkpoint written by either package resumes in the other: the
  ledger, the participation secret and the model continue the run."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import fedml_tpu.config as jcfg  # noqa: E402
from fedml_tpu.data.synthetic import synthetic_classification as jax_synthetic  # noqa: E402
from fedml_tpu.privacy import DpConfig as JaxDp  # noqa: E402
from fedml_tpu.privacy import DPFedAvgAPI as JaxDPFedAvg  # noqa: E402
from fedml_tpu.privacy import RdpAccountant as JaxAccountant  # noqa: E402
from fedml_tpu.privacy import dp_fedavg as jdp  # noqa: E402
from fedml_tpu.utils.checkpoint import load_checkpoint as jax_load  # noqa: E402
from fedml_tpu.utils.checkpoint import restore_like as jax_restore_like  # noqa: E402
from fedml_tpu.utils.checkpoint import save_checkpoint as jax_save  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.bridge import from_flax, to_flax  # noqa: E402
from fedml_tpu_torch.data.synthetic import synthetic_classification  # noqa: E402
from fedml_tpu_torch.privacy import DpConfig, DPFedAvgAPI, RdpAccountant  # noqa: E402
from fedml_tpu_torch.privacy import dp_fedavg as tdp  # noqa: E402
from fedml_tpu_torch.utils.checkpoint import load_checkpoint, restore_like, save_checkpoint  # noqa: E402

from torch_parity import (  # noqa: E402
    SLICE, flat_params, jax_lr_model, jax_noise_fn, jax_round_perm_fn, lr_config, lr_data,
    private_reference_programs, share_init, slice_configs, slice_data, slice_models,
    torch_lr_model,
)

# epsilon: the same float64 operations in the same order (measured equal)
EPS_RTOL = 1e-12
# DP rounds, params and rows: |port − reference| <= ROUND_TOL·max(1, |ref|);
# the same float32 steps summed in another order, then noise drawn by the
# reference (measured ≤ 1.3e-6 on these runs)
ROUND_TOL = 1e-4
SECRET = (1 << 100) + 12345  # an explicit 101-bit secret (no low-entropy warning)


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


# ------------------------------------------------------------- host math


@pytest.mark.parametrize("q", [0.01, 10 / 128, 0.3, 1.0])
@pytest.mark.parametrize("z", [0.6, 1.0, 4.0])
def test_epsilon_equals_the_reference(q, z):
    for rounds, delta in ((1, 1e-5), (37, 1e-5), (500, 1e-6)):
        ja, ta = JaxAccountant(), RdpAccountant()
        for acct in (ja, ta):
            acct.step(q, z, rounds=rounds)
            acct.step(q, z)
        (we, wo), (ge, go) = ja.epsilon(delta), ta.epsilon(delta)
        assert go == wo and ta.rounds == ja.rounds == rounds + 1
        assert abs(ge - we) <= EPS_RTOL * abs(we), (q, z, rounds, ge, we)


def test_poisson_cohorts_and_secret_words_equal_the_reference():
    for secret in (0, 7, SECRET, (1 << 128) - 1):
        for n, q in ((12, 4 / 12), (128, 10 / 128), (5, 1.0)):
            for r in range(6):
                np.testing.assert_array_equal(
                    tdp.poisson_client_sampling(secret, r, n, q),
                    jdp.poisson_client_sampling(secret, r, n, q))
        words = tdp._secret_to_words(secret)
        np.testing.assert_array_equal(words, jdp._secret_to_words(secret))
        assert tdp._words_to_secret(words) == jdp._words_to_secret(words) == secret
    for m in range(0, 40):
        assert tdp.bucket_cohort(m) == jdp.bucket_cohort(m)
    with pytest.raises(ValueError, match="sampling probability"):
        tdp.poisson_client_sampling(0, 0, 10, 0.0)


@pytest.mark.parametrize("clip", [0.05, 1e3])
def test_clip_covers_every_leaf_as_the_reference(clip):
    rng = np.random.default_rng(4)
    g = {"params": {"d": {"kernel": rng.normal(size=(6, 3)), "bias": rng.normal(size=(3,))}},
         "batch_stats": {"bn": {"mean": rng.normal(size=(3,))}}}
    g = jax.tree_util.tree_map(lambda a: a.astype(np.float32), g)
    local = jax.tree_util.tree_map(lambda a: a + rng.normal(size=a.shape).astype(np.float32), g)
    want = jdp.clip_update_tree(jax.tree_util.tree_map(jnp.asarray, local),
                                jax.tree_util.tree_map(jnp.asarray, g), clip)
    got = tdp.clip_update_tree(from_flax(local), from_flax(g), clip)
    want_port = from_flax(jax.tree_util.tree_map(np.asarray, want))
    for k in want_port:
        torch.testing.assert_close(got[k], want_port[k], rtol=1e-6, atol=1e-6)
    if clip < 1:  # the statistics are clipped too: the norm covers them
        delta = torch.sqrt(sum(((got[k] - from_flax(g)[k]) ** 2).sum() for k in got))
        assert abs(delta.item() - clip) < 1e-5


def test_dummy_clients_pad_as_the_reference_s():
    """pad_clients_to: all-mask-zero dummies with num_samples 0, for host
    and device-store (torch) batches alike."""
    from fedml_tpu.data.base import ClientBatch as JaxBatch
    from fedml_tpu.data.base import pad_clients_to as jax_pad

    from fedml_tpu_torch.data.base import ClientBatch, pad_clients_to

    rng = np.random.default_rng(0)
    arrays = dict(x=rng.normal(size=(3, 2, 4, 5)).astype(np.float32),
                  y=rng.integers(0, 9, size=(3, 2, 4)).astype(np.int32),
                  mask=np.ones((3, 2, 4), np.float32), num_samples=np.full(3, 8, np.float32))
    want = jax_pad(JaxBatch(**arrays), tdp.bucket_cohort(3))
    got = pad_clients_to(ClientBatch(**arrays), tdp.bucket_cohort(3))
    on_device = pad_clients_to(ClientBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
                               tdp.bucket_cohort(3))
    for field in arrays:
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(want, field)))
        np.testing.assert_array_equal(getattr(on_device, field).numpy(), getattr(got, field))
    assert got.num_clients == 4 and pad_clients_to(got, 2) is got


# ------------------------------------------------------------- the rounds


def _perm_fn(secret, n, per_round):
    """The reference's shuffles: the round key split over bucket_cohort(m)."""
    q = per_round / n
    return jax_round_perm_fn(SLICE["seed"], lambda r: tdp.bucket_cohort(
        len(tdp.poisson_client_sampling(secret, r, n, q))))


def _close(got, want, what):
    assert abs(got - want) <= ROUND_TOL * max(1.0, abs(want)), (what, got, want)


def _assert_rows_close(trows, jrows):
    assert len(trows) == len(jrows)
    for t, j in zip(trows, jrows):
        keys = {k for k in j if k != "round_time_s"}
        assert keys <= t.keys(), keys - t.keys()
        for k in keys:
            if isinstance(j[k], str):
                assert t[k] == j[k], k
            else:
                _close(t[k], j[k], k)


def _assert_params_close(tvars, jvars):
    got, want = flat_params(to_flax(tvars)), flat_params(jax.device_get(jvars)["params"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=ROUND_TOL, atol=ROUND_TOL, err_msg=k)


DP = dict(clip_norm=1.0, noise_multiplier=0.1, delta=1e-5)


def test_three_dp_rounds_of_the_slice_match_the_reference():
    (jdata, tdata), (jmodel, tmodel) = slice_data(), slice_models()
    jconf, tconf = slice_configs(rounds=3, batch_size=-1)
    jrows, trows = [], []
    japi = JaxDPFedAvg(jconf, jdata, jmodel, dp=JaxDp(**DP, sample_secret=SECRET),
                       log_fn=jrows.append)
    tapi = DPFedAvgAPI(tconf, tdata, tmodel, dp=DpConfig(**DP, sample_secret=SECRET),
                       device="cpu", log_fn=trows.append,
                       perm_fn=_perm_fn(SECRET, SLICE["num_clients"], SLICE["per_round"]),
                       noise_fn=jax_noise_fn(SLICE["seed"]))
    share_init(japi, tapi)
    jfinal, tfinal = japi.train(), tapi.train()
    cohorts = [tapi._round_plan(r).tolist() for r in range(3)]
    assert cohorts == [japi._round_plan(r)[0].tolist() for r in range(3)]
    assert len({len(c) for c in cohorts}) > 1  # realized sizes vary around m̂ = 4
    _assert_params_close(tapi.global_vars, japi.global_vars)
    _assert_rows_close(trows, jrows)
    for k in ("DP/epsilon", "DP/rdp_order", "DP/rounds_accounted", "DP/delta", "DP/sampling_note"):
        assert tfinal[k] == jfinal[k], k
    assert tfinal["DP/rounds_accounted"] == 3 and np.isfinite(tfinal["Train/Loss"])


def _lr_pair(per_round, rounds, secret, **extra):
    jc = lr_config(jcfg, dict(lr=0.1))
    tc = lr_config(tcfg, dict(lr=0.1))
    fed = dict(client_num_per_round=per_round, comm_round=rounds, frequency_of_the_test=1)
    jc = jc.replace(fed=dataclasses.replace(jc.fed, **fed))
    tc = tc.replace(fed=dataclasses.replace(tc.fed, **fed))
    japi = JaxDPFedAvg(jc, lr_data(jax_synthetic), jax_lr_model(),
                       dp=JaxDp(**DP, sample_secret=secret))
    tapi = DPFedAvgAPI(tc, lr_data(synthetic_classification), torch_lr_model(),
                       dp=DpConfig(**DP, sample_secret=extra.get("port_secret", secret)),
                       device="cpu", perm_fn=_perm_fn(secret, 4, per_round),
                       noise_fn=jax_noise_fn(SLICE["seed"]))
    share_init(japi, tapi)
    return japi, tapi


def _empty_round_secret(per_round=1, n=4):
    """The first secret whose round-0 Poisson cohort is empty."""
    return next(s for s in range(10_000, 20_000)
                if len(tdp.poisson_client_sampling(s, 0, n, per_round / n)) == 0)


def test_the_empty_cohort_moves_the_model_by_noise_alone():
    secret = _empty_round_secret()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a small secret: the low-entropy warning
        japi, tapi = _lr_pair(per_round=1, rounds=2, secret=secret)
    init = {k: v.clone() for k, v in tapi.global_vars.items()}
    tapi.train_round(0)
    japi.train_round(0)
    assert len(tapi._round_plan(0)) == 0
    noise = jax_noise_fn(SLICE["seed"])(0, 0x5EED, list(init), [tuple(v.shape) for v in init.values()])
    for (k, v), z in zip(init.items(), noise):
        torch.testing.assert_close(tapi.global_vars[k], v + z * (0.1 * 1.0 / 1), rtol=0, atol=1e-6)
    _assert_params_close(tapi.global_vars, japi.global_vars)
    assert tapi.accountant.rounds == japi.accountant.rounds == 1


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_checkpoint_resumes_in_the_other_package(writer, tmp_path):
    """2 rounds in the writer, saved with its algo state (ledger, secret
    words), resumed by the other package for round 2 with a fresh secret
    of its own (which the checkpoint's replaces): params within
    ROUND_TOL of the reference's 3 straight rounds, the same cohort,
    epsilon and ledger."""
    per_round, secret = 2, SECRET
    straight, _ = _lr_pair(per_round, 3, secret)
    straight.train()
    japi, tapi = _lr_pair(per_round, 2, secret)
    path = str(tmp_path / "ck")
    if writer == "reference":
        japi.train()
        jax_save(path, jax.device_get(japi.global_vars), round_idx=2,
                 algo_state=japi.checkpoint_state())
        _, resumed = _lr_pair(per_round, 3, secret, port_secret=None)
        loaded, round_idx, _, _, algo, _ = load_checkpoint(path)
        resumed.global_vars = restore_like(resumed.global_vars, loaded)
    else:
        tapi.train()
        save_checkpoint(path, tapi.global_vars, round_idx=2, algo_state=tapi.checkpoint_state())
        resumed, _ = _lr_pair(per_round, 3, secret)
        resumed.dp = JaxDp(**DP)  # a fresh OS-entropy secret, replaced below
        resumed._sample_secret = jdp.fresh_sample_secret()
        loaded, round_idx, _, _, algo, _ = jax_load(path)
        resumed.global_vars = jax_restore_like(resumed.global_vars, loaded)
    assert round_idx == 2 and algo["dp_sample_secret"].dtype == np.uint32
    resumed.restore_state(algo)
    assert resumed._sample_secret == secret and resumed.accountant.rounds == 2
    resumed.start_round = 2
    final = resumed.train()
    assert resumed.accountant.rounds == 3
    assert final["DP/epsilon"] == straight.privacy_spent()["DP/epsilon"]
    np.testing.assert_array_equal(np.asarray(resumed.accountant._rdp),
                                  np.asarray(straight.accountant._rdp))
    got = resumed.global_vars
    if writer == "port":
        got = from_flax(jax.device_get(got)["params"])
    _assert_params_close(got, straight.global_vars)
