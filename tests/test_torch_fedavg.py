"""The port's FedAvg slice against the reference on the CPU: the synthetic
FEMNIST data byte for byte, the uniform cohorts, the round batch from host
stacking and from the device store, the weighted average, and three rounds
of FedAvgAPI from the same init with the same shuffles."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from fedml_tpu.algorithms.fedavg import weighted_average as jax_weighted_average  # noqa: E402
from fedml_tpu.data.base import stack_clients as jax_stack_clients  # noqa: E402
from fedml_tpu.data.femnist_synth import femnist_synthetic as jax_femnist  # noqa: E402
from fedml_tpu.scheduler import select_clients as jax_select_clients  # noqa: E402

from fedml_tpu_torch.algorithms.fedavg import client_sampling, weighted_average  # noqa: E402
from fedml_tpu_torch.data.base import stack_clients  # noqa: E402
from fedml_tpu_torch.data.device_store import DeviceDataStore  # noqa: E402
from fedml_tpu_torch.data.femnist_synth import femnist_synthetic  # noqa: E402

from torch_parity import assert_slice_close, run_slice  # noqa: E402


def test_femnist_synthetic_is_byte_identical():
    kw = dict(num_clients=20, mean_samples=60, seed=3)
    got, want = femnist_synthetic(**kw), jax_femnist(**kw)
    assert got.num_clients == want.num_clients and got.num_classes == want.num_classes
    pairs = list(zip(got.client_x, want.client_x)) + list(zip(got.client_y, want.client_y))
    pairs += [(got.test_x, want.test_x), (got.test_y, want.test_y)]
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_uniform_cohorts_match_rounds_0_to_9():
    for r in range(10):
        np.testing.assert_array_equal(
            client_sampling(r, 128, 10),
            jax_select_clients(r, 128, 10, policy="uniform"),
        )


def test_device_store_gather_equals_host_stacking_equals_reference():
    data = femnist_synthetic(num_clients=9, mean_samples=30, seed=1)
    clients, seed = [4, 0, 7], 11
    host = stack_clients(data, clients, 8, seed=seed, pad_bucket=1)
    ref = jax_stack_clients(data, clients, 8, seed=seed, pad_bucket=1)
    store = DeviceDataStore(data, torch.device("cpu")).round_batch(clients, 8, seed=seed)
    for field in ("x", "y", "mask", "num_samples"):
        h, r, s = (np.asarray(getattr(b, field)) for b in (host, ref, store))
        assert h.shape == r.shape == s.shape, field
        np.testing.assert_array_equal(h, r, err_msg=field)
        np.testing.assert_array_equal(s, h, err_msg=field)


def test_weighted_average_matches_reference():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(5, 3, 4)).astype(np.float32),
            "b": rng.normal(size=(5, 7)).astype(np.float32)}
    w = rng.integers(1, 50, size=5).astype(np.float32)
    got = weighted_average({k: torch.from_numpy(v) for k, v in tree.items()}, torch.from_numpy(w))
    want = jax_weighted_average({k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(w))
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


def test_fedavg_three_rounds_match_reference():
    japi, tapi = run_slice()
    assert_slice_close(japi, tapi)
