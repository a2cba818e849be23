"""The port's LM slice against the reference on the CPU: the synthetic
Shakespeare data byte for byte, the sequence loss and accuracy, and two
rounds of FedAvgAPI(task="nwp") on a 2-layer transformer LM with flash
attention, from the reference's init with its shuffles, against the
reference's FedAvgAPI with the "scan" client schedule (tests/torch_parity.py
LM_SLICE)."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from fedml_tpu.data.synthetic import synthetic_shakespeare as jax_shakespeare  # noqa: E402
from fedml_tpu.train import losses as jax_losses  # noqa: E402

from fedml_tpu_torch.bridge import to_flax  # noqa: E402
from fedml_tpu_torch.data.synthetic import synthetic_shakespeare  # noqa: E402
from fedml_tpu_torch.ops import flash_attention as fa  # noqa: E402
from fedml_tpu_torch.train import losses  # noqa: E402

from torch_parity import LM_SLICE, flat_params, run_lm_slice  # noqa: E402


@pytest.mark.parametrize("seq_targets", [True, False])
def test_synthetic_shakespeare_is_byte_identical(seq_targets):
    kw = dict(num_clients=6, samples_per_client=20, seq_len=16, vocab_size=50, seed=3,
              seq_targets=seq_targets)
    got, want = synthetic_shakespeare(**kw), jax_shakespeare(**kw)
    assert (got.name, got.num_classes, got.num_clients) == (want.name, want.num_classes, want.num_clients)
    pairs = list(zip(got.client_x, want.client_x)) + list(zip(got.client_y, want.client_y))
    pairs += [(got.test_x, want.test_x), (got.test_y, want.test_y)]
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_sequence_loss_and_accuracy_match_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 10, 7)).astype(np.float32)
    labels = rng.integers(0, 7, size=(4, 10)).astype(np.int32)  # 0 = pad, ignored
    mask = np.array([1, 1, 0, 1], np.float32)
    t = [torch.from_numpy(a) for a in (logits, labels, mask)]
    j = [jnp.asarray(a) for a in (logits, labels, mask)]
    np.testing.assert_allclose(losses.masked_seq_ce(*t).item(),
                               float(jax_losses.masked_seq_ce(*j)), rtol=1e-6)
    got = [v.item() for v in losses.masked_seq_accuracy_stats(*t)]
    want = [float(v) for v in jax_losses.masked_seq_accuracy_stats(*j)]
    assert got == want


def _rows_close(tapi, japi, tol):
    assert len(tapi.history) == len(japi.history) == LM_SLICE["rounds"]
    for trow, jrow in zip(tapi.history, japi.history):
        keys = {k for k in jrow if k != "round_time_s"}
        assert keys <= trow.keys(), keys - trow.keys()
        for k in keys:
            assert abs(trow[k] - jrow[k]) <= tol, (k, trow[k], jrow[k])


def test_fedavg_lm_float32_sgd_matches_reference():
    """Tight: the same float32 arithmetic summed in another order (observed
    ~2e-7 in the params after two rounds at lr 0.1)."""
    before = dict(fa.LAUNCHES)
    japi, tapi, _ = run_lm_slice("float32", "sgd", 0.1)
    assert fa.LAUNCHES == before  # the CPU runs the plain versions
    got, want = flat_params(to_flax(tapi.global_vars)), flat_params(japi.global_vars["params"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    _rows_close(tapi, japi, 1e-4)


def test_fedavg_lm_bfloat16_adam_matches_reference():
    """Looser: every matmul in bf16, which the two frameworks round at
    different places (~1 bf16 ulp, 2^-8), and AMSGrad divides each
    gradient by its own running magnitude, so a near-zero coordinate's
    rounding noise becomes a step of up to lr in either direction
    (ROADMAP §3). At lr 1e-4 a weight moves at most ~4e-4 in the 2 rounds
    of at most 2 steps: params must agree within 3e-4 and the two global
    updates must point the same way (cosine ≥ 0.95 over all params); the
    logged losses and accuracies within 1e-3 (observed ~1.5e-4)."""
    japi, tapi, init = run_lm_slice("bfloat16", "adam", 1e-4)
    got, want = flat_params(to_flax(tapi.global_vars)), flat_params(japi.global_vars["params"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=3e-4, err_msg=k)
    du = np.concatenate([(got[k] - init[k]).ravel() for k in sorted(init)])
    dw = np.concatenate([(want[k] - init[k]).ravel() for k in sorted(init)])
    cosine = float(du @ dw / (np.linalg.norm(du) * np.linalg.norm(dw)))
    assert cosine >= 0.95, cosine
    _rows_close(tapi, japi, 1e-3)
