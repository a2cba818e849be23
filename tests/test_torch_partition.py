"""The port's partitioners and partitioned synthetic data against the
reference's on the CPU: the Dirichlet (LDA) and IID index maps are
identical over a grid of (clients, alpha, seed, min_size), and the
datasets built on them are byte-identical — both packages draw from the
same numpy generators in the same order."""

import numpy as np
import pytest

from fedml_tpu.data.femnist_synth import femnist_synthetic_lda as jax_femnist_lda
from fedml_tpu.data.synthetic import synthetic_classification as jax_synthetic
from fedml_tpu.data.synthetic import synthetic_fedprox as jax_fedprox
from fedml_tpu.partition import noniid as jnoniid

from fedml_tpu_torch.data.femnist_synth import femnist_synthetic_lda
from fedml_tpu_torch.data.synthetic import synthetic_classification, synthetic_fedprox
from fedml_tpu_torch.partition import noniid as tnoniid


def _assert_maps_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _assert_datasets_equal(got, want):
    assert got.name == want.name and got.num_classes == want.num_classes
    assert got.num_clients == want.num_clients
    for a, b in zip(got.client_x + got.client_y + [got.test_x, got.test_y],
                    want.client_x + want.client_y + [want.test_x, want.test_y], strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("clients", [3, 10, 32])
@pytest.mark.parametrize("alpha", [0.1, 0.5, 5.0])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("min_size", [1, 10])
def test_lda_partition_maps_equal_the_reference(clients, alpha, seed, min_size):
    labels = np.random.default_rng(seed + 100).integers(0, 10, size=clients * 40)
    _assert_maps_equal(
        tnoniid.lda_partition(labels, clients, alpha, seed=seed, min_size=min_size),
        jnoniid.lda_partition(labels, clients, alpha, seed=seed, min_size=min_size),
    )


@pytest.mark.parametrize("n,clients,seed", [(100, 7, 0), (64, 64, 3), (1000, 10, 11)])
def test_homo_partition_maps_equal_the_reference(n, clients, seed):
    _assert_maps_equal(
        tnoniid.homo_partition(n, clients, np.random.default_rng(seed)),
        jnoniid.homo_partition(n, clients, np.random.default_rng(seed)),
    )


def test_record_data_stats_equals_the_reference():
    labels = np.random.default_rng(1).integers(0, 5, size=200)
    idx = jnoniid.lda_partition(labels, 6, 0.3, seed=2)
    assert tnoniid.record_data_stats(labels, idx) == jnoniid.record_data_stats(labels, idx)


def test_lda_partition_gives_up_when_min_size_cannot_be_met():
    # one class and a tiny alpha: each draw gives nearly every sample to one
    # client, so a min_size at the mean shard size is never met; both
    # packages give up the same way
    labels = np.zeros(30, np.int64)
    for mod in (tnoniid, jnoniid):
        with pytest.raises(RuntimeError, match="could not reach min"):
            mod.lda_partition(labels, 3, 1e-3, seed=0, min_size=10)


@pytest.mark.parametrize("method,alpha,seed", [
    ("hetero", 0.5, 0), ("hetero", 0.1, 3), ("hetero-fix", 1.0, 1), ("homo", 0.5, 2),
])
def test_synthetic_classification_is_byte_identical(method, alpha, seed):
    kw = dict(num_clients=12, num_classes=10, feat_shape=(6, 6, 1), samples_per_client=30,
              partition_method=method, partition_alpha=alpha, seed=seed)
    _assert_datasets_equal(synthetic_classification(**kw), jax_synthetic(**kw))


@pytest.mark.parametrize("alpha,beta,seed", [(1.0, 1.0, 0), (0.0, 0.0, 4), (0.5, 0.5, 1)])
def test_synthetic_fedprox_is_byte_identical(alpha, beta, seed):
    kw = dict(alpha=alpha, beta=beta, num_clients=12, seed=seed)
    _assert_datasets_equal(synthetic_fedprox(**kw), jax_fedprox(**kw))


@pytest.mark.parametrize("alpha,seed", [(0.5, 0), (0.1, 2)])
def test_femnist_synthetic_lda_is_byte_identical(alpha, seed):
    kw = dict(num_clients=10, alpha=alpha, mean_samples=30, seed=seed)
    _assert_datasets_equal(femnist_synthetic_lda(**kw), jax_femnist_lda(**kw))
