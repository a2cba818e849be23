"""The port's on-disk federated store against the reference's on the CPU:
the synthetic StackOverflow store and the streaming builder write the
reference's files byte for byte, each package opens a store the other
wrote, both packages stack the same round batches from it (and from the
in-RAM dataset), the builder keeps its RAM ceiling and refuses drift, the
store reports its sizes in O(1), the device cache's byte guard keeps a
store past the cap on the host, and FedAvg rounds over a store equal the
same rounds in RAM bit for bit.

Every comparison is exact: the stores hold bytes, and a round reads the
same rows in the same order from disk as from RAM."""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from fedml_tpu.data import mmap_store as jax_mm  # noqa: E402
from fedml_tpu.data.base import stack_clients as jax_stack  # noqa: E402
from fedml_tpu.data.device_store import fits_on_device as jax_fits  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.algorithms import FedAvgAPI  # noqa: E402
from fedml_tpu_torch.algorithms import state_store  # noqa: E402
from fedml_tpu_torch.data import mmap_store as mm  # noqa: E402
from fedml_tpu_torch.data.base import FederatedDataset, stack_clients  # noqa: E402
from fedml_tpu_torch.data.device_store import fits_on_device  # noqa: E402
from fedml_tpu_torch.models import create_model  # noqa: E402
from fedml_tpu_torch.population import state_tier  # noqa: E402

from torch_parity import population_config  # noqa: E402

STORE_FILES = ("flat_x.npy", "flat_y.npy", "offsets.npy", "test_x.npy", "test_y.npy", "meta.json")
SO = dict(num_clients=300, mean_samples=12, vocab=50, seq_len=5, seed=3)


def _same_files(a, b):
    for f in STORE_FILES:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def _in_ram(store) -> FederatedDataset:
    return FederatedDataset(
        name="ram", client_x=[np.asarray(c) for c in store.client_x],
        client_y=[np.asarray(c) for c in store.client_y], test_x=store.test_x,
        test_y=store.test_y, num_classes=store.num_classes,
    )


def test_synthetic_stackoverflow_store_is_the_references_byte_for_byte(tmp_path):
    port = mm.synth_stackoverflow_mmap(str(tmp_path / "port"), **SO)
    ref = jax_mm.synth_stackoverflow_mmap(str(tmp_path / "ref"), **SO)
    _same_files(tmp_path / "port", tmp_path / "ref")
    assert port.name == ref.name == "so_synth_300c"
    # idempotent: a matching directory is reopened, not rewritten
    stamp = os.stat(tmp_path / "port" / "flat_x.npy").st_mtime_ns
    again = mm.synth_stackoverflow_mmap(str(tmp_path / "port"), **SO)
    assert os.stat(tmp_path / "port" / "flat_x.npy").st_mtime_ns == stamp
    assert again.num_clients == 300


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_package_opens_the_others_store(tmp_path, writer):
    (mm if writer == "port" else jax_mm).synth_stackoverflow_mmap(str(tmp_path), **SO)
    port, ref = mm.load_mmap_dataset(str(tmp_path)), jax_mm.load_mmap_dataset(str(tmp_path))
    assert isinstance(port.client_x[0], np.memmap)
    assert port.num_clients == ref.num_clients == 300
    assert port.train_sample_counts.tolist() == np.asarray(ref.train_sample_counts).tolist()
    assert port.total_train_samples() == ref.total_train_samples()
    assert port.total_train_bytes == ref.total_train_bytes == port.total_train_samples() * 2 * 5 * 4
    assert port.total_train_bytes == sum(x.nbytes + y.nbytes
                                         for x, y in zip(port.client_x, port.client_y))
    assert len(port.client_x) == 300 and len(list(port.client_y)) == 300
    ids = [7, 299, 0, 123]
    for bs, pb in ((4, 1), (8, 4), (-1, 1)):
        got = stack_clients(port, ids, bs, seed=5, pad_bucket=pb)
        want = jax_stack(ref, ids, bs, seed=5, pad_bucket=pb)
        ram = stack_clients(_in_ram(port), ids, bs, seed=5, pad_bucket=pb)
        for part in ("x", "y", "mask", "num_samples"):
            g, w = getattr(got, part), np.asarray(getattr(want, part))
            assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), part
            assert g.tobytes() == getattr(ram, part).tobytes(), part
    # the population index reads the offsets alone
    assert port.population_index().counts.tolist() == port.train_sample_counts.tolist()


def _clients(seed=0, n=23):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(int(c), 3, 2)).astype(np.float32) for c in rng.integers(0, 30, n)]
    ys = [rng.integers(0, 4, len(x)).astype(np.int64) for x in xs]
    return xs, ys, (rng.normal(size=(5, 3, 2)).astype(np.float32), np.arange(5, dtype=np.int64))


def test_builder_writes_the_references_files_and_the_bulk_writers(tmp_path):
    xs, ys, test = _clients()
    logs = []
    for pkg, where in ((mm, "port"), (jax_mm, "ref")):
        b = pkg.MmapStoreBuilder(str(tmp_path / where), flush_bytes=512,
                                 log_fn=logs.append if pkg is mm else None)
        for x, y in zip(xs, ys):
            b.add_client(x, y)
        b.finalize(test, num_classes=4, name="built")
    _same_files(tmp_path / "port", tmp_path / "ref")
    flat_x, flat_y = np.concatenate(xs), np.concatenate(ys)
    mm.write_mmap_dataset(str(tmp_path / "bulk"), [len(x) for x in xs],
                          lambda s, n: (flat_x[s:s + n], flat_y[s:s + n]), test,
                          num_classes=4, name="built", chunk_rows=37)
    _same_files(tmp_path / "port", tmp_path / "bulk")
    stats = logs[-1]
    assert stats["mmap_build/clients"] == len(xs)
    assert stats["mmap_build/rows"] == len(flat_y)
    assert stats["mmap_build/bytes"] == len(flat_y) * (6 * 4 + 8)
    assert stats["mmap_build/flushes"] >= 2
    assert stats["mmap_build/peak_buffer_bytes"] < 512 + 30 * 32  # the ceiling plus one client
    assert any(isinstance(m, str) and "flushed" in m for m in logs)


def test_builder_refuses_drift_and_reuse(tmp_path):
    b = mm.MmapStoreBuilder(str(tmp_path / "a"))
    with pytest.raises(ValueError, match="before any add_client"):
        b.finalize((np.zeros((1, 2)), np.zeros(1)), num_classes=2)
    b.add_client(np.zeros((3, 2), np.float32), np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="misaligned"):
        b.add_client(np.zeros((3, 2), np.float32), np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="drift"):
        b.add_client(np.zeros((3, 5), np.float32), np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="drift"):
        b.add_client(np.zeros((3, 2), np.float64), np.zeros(3, np.int32))
    b.finalize((np.zeros((1, 2), np.float32), np.zeros(1, np.int32)), num_classes=2)
    with pytest.raises(RuntimeError, match="finalized"):
        b.add_client(np.zeros((3, 2), np.float32), np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="reserve"):
        bad = mm.MmapStoreBuilder(str(tmp_path / "b"))
        bad.add_client(np.zeros((1,) + (2,) * 30, np.float32), np.zeros(1, np.int32))


def test_streaming_write_reads_bounded_chunks(tmp_path):
    calls, logs = [], []

    def gen_chunk(start, n):
        calls.append(n)
        r = np.random.default_rng(start)
        return r.normal(size=(n, 3)).astype(np.float32), r.integers(0, 2, n).astype(np.int32)

    mm.write_mmap_dataset(str(tmp_path), [10] * 40, gen_chunk,
                          (np.zeros((4, 3), np.float32), np.zeros(4, np.int32)),
                          num_classes=2, chunk_rows=64, log_fn=logs.append)
    assert max(calls) <= 64 and sum(calls[1:]) == 400
    assert logs[-1]["mmap_build/rows"] == 400 and logs[-1]["mmap_build/clients"] == 40
    store = mm.load_mmap_dataset(str(tmp_path))
    assert store.total_train_samples() == 400 and len(store.client_x[3]) == 10


def test_advise_random_has_one_definition(tmp_path):
    assert state_store.advise_random is mm.advise_random is state_tier.advise_random
    arr = np.lib.format.open_memmap(str(tmp_path / "a.npy"), mode="w+", dtype=np.int32,
                                    shape=(64,))
    mm.advise_random(arr)  # a hint: the bytes read are the same
    arr[:] = np.arange(64)
    assert arr[[63, 0, 5]].tolist() == [63, 0, 5]
    mm.advise_random(np.zeros(3))  # a plain array: no-op


def test_device_cache_guard_keeps_a_store_past_the_cap_on_the_host(tmp_path, monkeypatch):
    store = mm.synth_stackoverflow_mmap(str(tmp_path), **SO)
    ram = _in_ram(store)
    assert fits_on_device(store) == jax_fits(store) is True
    monkeypatch.setenv("FEDML_TPU_DEVICE_CACHE_MAX_BYTES", str(store.total_train_bytes - 1))
    assert fits_on_device(store) is False and fits_on_device(ram) is False
    assert jax_fits(store) is False
    # the guard reads the store's O(1) size, never its client views
    monkeypatch.setattr(type(store), "client_x", property(lambda self: 1 / 0), raising=False)
    assert fits_on_device(store) is False
    monkeypatch.undo()
    model = create_model("rnn", "stackoverflow_nwp", (5,), 54, vocab_size=50, embedding_size=4,
                         latent_size=8)
    cfg = population_config(tcfg, 300, per_round=3, rounds=1)
    cfg = cfg.replace(data=tcfg.DataConfig(batch_size=4, device_cache=True))
    assert FedAvgAPI(cfg, store, model, task="nwp", device="cpu")._store is not None
    monkeypatch.setenv("FEDML_TPU_DEVICE_CACHE_MAX_BYTES", "1000")
    assert FedAvgAPI(cfg, store, model, task="nwp", device="cpu")._store is None


@pytest.mark.parametrize("device_cache", [False, True])
def test_fedavg_rounds_over_a_store_equal_the_rounds_in_ram(tmp_path, device_cache):
    """2 rounds of the narrow StackOverflow RNN (vocab 50, embed 4, LSTM 8,
    windows of 5) over 300 clients, 3 a round, batch 4 with pad_bucket 4:
    the store's model bit-equal to the in-RAM dataset's."""
    store = mm.synth_stackoverflow_mmap(str(tmp_path), **SO)
    outs = {}
    for name, data in (("mmap", store), ("ram", _in_ram(store))):
        model = create_model("rnn", "stackoverflow_nwp", (5,), 54, vocab_size=50,
                             embedding_size=4, latent_size=8)
        cfg = population_config(tcfg, 300, per_round=3, rounds=2)
        cfg = cfg.replace(data=tcfg.DataConfig(batch_size=4, pad_bucket=4,
                                               device_cache=device_cache))
        api = FedAvgAPI(cfg, data, model, task="nwp", device="cpu")
        api.train()
        assert np.isfinite(api.history[-1]["Train/Loss"])
        outs[name] = api
    for k, v in outs["ram"].global_vars.items():
        assert torch.equal(outs["mmap"].global_vars[k], v), k
    assert outs["mmap"].history == [
        {**row, "round_time_s": outs["mmap"].history[i]["round_time_s"]}
        for i, row in enumerate(outs["ram"].history)
    ]
