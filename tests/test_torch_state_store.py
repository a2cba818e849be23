"""The port's per-client state store against the reference's on the CPU:
lazy initialisation and the gather/scatter round trip (each operation on
both packages' stores, and a store directory the reference wrote reopened
by the port), the ``state_store`` modes ``resolve_state_store`` picks,
SCAFFOLD and Ditto spilled to the mmap tier bit-equal to the device stack,
and the cohort prefetcher's exclusion of the rows being scattered.

Every comparison is exact: the store copies float32 rows and nothing else.
Tests that start the prefetch thread run under ``time_limit``."""

import gc
import os
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from fedml_tpu.algorithms.ditto import DittoAPI as JaxDitto  # noqa: E402
from fedml_tpu.algorithms.scaffold import ScaffoldAPI as JaxScaffold  # noqa: E402
from fedml_tpu.algorithms.state_store import MmapClientState as JaxStore  # noqa: E402
from fedml_tpu.algorithms.state_store import resolve_state_store as jax_resolve  # noqa: E402
from fedml_tpu.config import FedConfig as JaxFedConfig  # noqa: E402

from fedml_tpu_torch.algorithms.ditto import DittoAPI  # noqa: E402
from fedml_tpu_torch.algorithms.scaffold import ScaffoldAPI  # noqa: E402
from fedml_tpu_torch.algorithms.state_store import (  # noqa: E402
    CohortPrefetcher, MmapClientState, resolve_state_store,
)
from fedml_tpu_torch.config import FedConfig  # noqa: E402

from torch_parity import lr_pair, private_reference_programs, time_limit  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    # the reference's SCAFFOLD and Ditto APIs are built (not trained) here
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _init_tree():
    # sorted names: the order jax.tree_util gives a dict, so both stores
    # number their leaf files alike
    return {"a_bias": np.full((3,), 0.5, np.float32),
            "b_kernel": np.arange(8, dtype=np.float32).reshape(2, 4)}


def _rows(seed, ids):
    rng = np.random.default_rng(seed)
    return {"a_bias": rng.normal(size=(len(ids), 3)).astype(np.float32),
            "b_kernel": rng.normal(size=(len(ids), 2, 4)).astype(np.float32)}


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_lazy_init_and_round_trip_match_reference(tmp_path):
    port = MmapClientState(_init_tree(), 10, str(tmp_path / "port"))
    ref = JaxStore(_init_tree(), 10, str(tmp_path / "ref"))
    for store in (port, ref):
        _equal(store.gather([0, 9, 3]), {k: np.stack([v] * 3) for k, v in _init_tree().items()})
        store.scatter([3, 7], _rows(1, [3, 7]))
        store.scatter([7, 1], _rows(2, [7, 1]))
    for ids in ([3, 7, 1, 0], [5], [1, 1, 3]):
        _equal(port.gather(ids), ref.gather(ids))
    assert port.initialized_ids().tolist() == ref.initialized_ids().tolist() == [1, 3, 7]
    for store in (port, ref):
        store.reset_to([2], _rows(3, [2]))
    _equal(port.gather(range(10)), ref.gather(range(10)))
    assert port.initialized_count() == 1
    assert port.state_bytes_total == ref.state_bytes_total == 10 * (12 + 32)


def test_port_reopens_a_store_the_reference_wrote(tmp_path):
    path = str(tmp_path / "store")
    ref = JaxStore(_init_tree(), 6, path)
    ref.scatter([4, 0], _rows(5, [4, 0]))
    ref.flush()
    port = MmapClientState(_init_tree(), 6, path)
    _equal(port.gather(range(6)), ref.gather(range(6)))
    with pytest.raises(ValueError, match="schema"):
        MmapClientState(_init_tree(), 7, path)


def test_temporary_directory_is_removed_and_a_named_one_kept(tmp_path):
    tmp = MmapClientState(_init_tree(), 4)
    path = tmp.path
    assert os.path.isdir(path)
    del tmp
    gc.collect()
    assert not os.path.exists(path)
    named = MmapClientState(_init_tree(), 4, str(tmp_path / "kept"))
    del named
    gc.collect()
    assert os.path.isdir(tmp_path / "kept")


@pytest.mark.parametrize("mode", ["auto", "device", "mmap", "sharded"])
@pytest.mark.parametrize("state_bytes,n", [(1 << 20, 100), (16 << 30, 1000), (16 << 30, 70000)])
def test_resolve_state_store_matches_reference(mode, state_bytes, n):
    want = jax_resolve(JaxFedConfig(state_store=mode), state_bytes, n_clients=n)
    assert resolve_state_store(FedConfig(state_store=mode), state_bytes, n_clients=n) == want
    with pytest.raises(ValueError):
        resolve_state_store(FedConfig(state_store="disk"), state_bytes)


@pytest.mark.parametrize("jax_cls,torch_cls", [(JaxScaffold, ScaffoldAPI), (JaxDitto, DittoAPI)])
@time_limit(60)
def test_mmap_is_bit_equal_to_device(jax_cls, torch_cls):
    """3 rounds of 2 of the fixture's 4 clients at batch 4, so rows are
    gathered, trained, scattered and re-gathered; the spilled run's
    model, rows and state bit-equal to the device stack's."""
    runs = {}
    for mode in ("device", "mmap"):
        _, api = lr_pair(jax_cls, torch_cls, fed={"client_num_per_round": 2, "state_store": mode},
                         batch_size=4)
        api.train()
        assert api.state.mode == mode
        runs[mode] = api
    dev, mm = runs["device"], runs["mmap"]
    for k, v in dev.global_vars.items():
        assert torch.equal(mm.global_vars[k], v), k
    for i in range(dev.config.fed.client_num_in_total):
        got, want = mm.state.row(i), dev.state.row(i)
        assert all(torch.equal(got[k], want[k]) for k in want), i
    assert len(mm.state.spill_ms) == 3
    assert not [t for t in threading.enumerate() if t.name == "cohort-prefetch" and t.is_alive()]


@time_limit(30)
def test_prefetcher_excludes_the_rows_being_scattered():
    store = MmapClientState(_init_tree(), 8)
    store.scatter([0, 1, 2, 3], _rows(0, [0, 1, 2, 3]))
    pre = CohortPrefetcher(store)
    pre.launch(5, [2, 3, 6], exclude={3})
    # round 4's scatter lands after the launch: row 3 is excluded from the
    # background read, so take() reads it afterwards
    store.scatter([3], _rows(9, [3]))
    got = pre.take(5, [2, 3, 6])
    _equal(got, store.gather([2, 3, 6]))
    assert np.array_equal(got["a_bias"][1], _rows(9, [3])["a_bias"][0])
    # a take for another round or cohort reads synchronously
    pre.launch(6, [0, 1])
    _equal(pre.take(7, [0, 1]), store.gather([0, 1]))
    pre.launch(8, [4])
    pre.cancel()
    assert pre._thread is None
