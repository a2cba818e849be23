"""The port's population tier against the reference's on the CPU: the alias
sampler's and the rejection draw's ids, the packed population index (its
shape classes, its files and their mmap backing), the scheduler's cohorts
at and below ``ocohort_threshold``, the simulator and the loopback
federation agreeing on those cohorts, and the sharded record-major state
tier (lazy init, reopen, schema refusal, the mmap tier's rows), with
SCAFFOLD and Ditto bit-identical over the device, mmap and sharded tiers
and SCAFFOLD's sharded run against the reference's.

Every comparison of ids, files and stored rows is exact: the draws are the
same numpy calls on the same generators, and the stores copy bytes.
SCAFFOLD against the reference holds the LR fixture's full-batch rounds to
float32 rounding (rtol 1e-5, atol 1e-6: one step a round, no chaotic
amplification). Tests that start the prefetch thread run under
``time_limit``."""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from fedml_tpu.algorithms.ditto import DittoAPI as JaxDitto  # noqa: E402
from fedml_tpu.algorithms.scaffold import ScaffoldAPI as JaxScaffold  # noqa: E402
from fedml_tpu.algorithms.state_store import MmapClientState as JaxMmapStore  # noqa: E402
from fedml_tpu.data.base import partition_shape_classes as jax_shape_classes  # noqa: E402
from fedml_tpu.data.base import steps_class_array as jax_steps_class_array  # noqa: E402
from fedml_tpu.population import AliasSampler as JaxAlias  # noqa: E402
from fedml_tpu.population import PopulationIndex as JaxIndex  # noqa: E402
from fedml_tpu.population import draw_uniform_distinct as jax_uniform_distinct  # noqa: E402
from fedml_tpu.population.state_tier import ShardedClientState as JaxSharded  # noqa: E402
from fedml_tpu.scheduler import ClientScheduler as JaxScheduler  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.algorithms import FedAvgAPI  # noqa: E402
from fedml_tpu_torch.algorithms.ditto import DittoAPI  # noqa: E402
from fedml_tpu_torch.algorithms.fedavg_transport import run_loopback_federation  # noqa: E402
from fedml_tpu_torch.algorithms.scaffold import ScaffoldAPI  # noqa: E402
from fedml_tpu_torch.algorithms.state_store import (  # noqa: E402
    CohortPrefetcher, MmapClientState, make_spill_store, resolve_state_store,
)
from fedml_tpu_torch.data.base import (  # noqa: E402
    bucket_steps, partition_shape_classes, steps_class_array,
)
from fedml_tpu_torch.data.synthetic import synthetic_classification  # noqa: E402
from fedml_tpu_torch.models import create_model  # noqa: E402
from fedml_tpu_torch.population import (  # noqa: E402
    AliasSampler, PopulationIndex, draw_uniform_distinct,
)
from fedml_tpu_torch.population.state_tier import ShardedClientState  # noqa: E402
from fedml_tpu_torch.scheduler import ClientScheduler  # noqa: E402

from torch_parity import (  # noqa: E402
    FlaggedHealth, lr_pair, population_config, private_reference_programs, reference_record,
    time_limit,
)


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    # the reference's SCAFFOLD and Ditto APIs are built (and one trained) here
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


WEIGHTS = {
    "lognormal": np.random.default_rng(0).lognormal(3.0, 1.0, 500),
    "heavy_head": np.r_[np.full(3, 1e4), np.ones(200)],
    "zeros": np.r_[np.zeros(40), np.arange(1, 21, dtype=np.float64)],
}


# -- the draws ------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(WEIGHTS))
@pytest.mark.parametrize("k", [1, 7, 20, 60])
def test_alias_draws_are_the_references_byte_for_byte(name, k):
    w = WEIGHTS[name]
    port, ref = AliasSampler(w), JaxAlias(w)
    assert port._prob.tobytes() == ref._prob.tobytes()
    assert port._alias.tobytes() == ref._alias.tobytes()
    for seed in range(3):
        got = port.draw_distinct(np.random.default_rng([seed, k]), k)
        want = ref.draw_distinct(np.random.default_rng([seed, k]), k)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        assert len(set(got.tolist())) == min(k, len(w))
    g1, g2 = np.random.default_rng(9), np.random.default_rng(9)
    assert port.sample(g1, 300).tobytes() == ref.sample(g2, 300).tobytes()


def test_alias_refuses_what_the_reference_refuses():
    for bad in ([], [1.0, -1.0], [0.0, 0.0], [1.0, np.inf]):
        with pytest.raises(ValueError):
            AliasSampler(np.asarray(bad, np.float64))
        with pytest.raises(ValueError):
            JaxAlias(np.asarray(bad, np.float64))


@pytest.mark.parametrize("n,k,exclude", [
    (1000, 10, []), (1000, 10, [3, 5, 999]), (100_000, 64, list(range(0, 5000, 7))),
    (40, 9, [1, 2]),  # (k + |exclude|)·4 >= n: the dense draw
    (10, 12, [0]),  # k past what is left
])
def test_uniform_rejection_draw_is_the_references(n, k, exclude):
    for seed in range(3):
        got = draw_uniform_distinct(np.random.default_rng(seed), n, k, np.asarray(exclude))
        want = jax_uniform_distinct(np.random.default_rng(seed), n, k, np.asarray(exclude))
        assert got.tobytes() == want.tobytes()
        assert not set(got.tolist()) & set(exclude)


# -- the population index --------------------------------------------------------


@pytest.mark.parametrize("bs,pb", [(1, 1), (8, 1), (16, 4), (20, 2), (-1, 1)])
def test_shape_classes_are_the_references_and_the_scalar_buckets(bs, pb):
    counts = np.random.default_rng(bs + 10 * pb).integers(1, 300, 2000)
    counts[:3] = (1, 517, 0 if bs != -1 else 2)  # full batch has no bucket for 0
    got = PopulationIndex(counts).shape_classes(bs, pb)
    assert got == JaxIndex(counts).shape_classes(bs, pb)
    assert got == partition_shape_classes(counts, bs, pb) == jax_shape_classes(counts, bs, pb)
    scalar = {}
    for i, n in enumerate(counts):
        scalar.setdefault(bucket_steps([int(n)], bs, pb)[:2], i)
    assert got == scalar
    if bs != -1:
        arr = steps_class_array(counts, bs, pb)
        assert arr.tobytes() == jax_steps_class_array(counts, bs, pb).tobytes()
        assert arr.tolist() == [bucket_steps([int(n)], bs, pb)[0] for n in counts]


def test_index_lookups_match_the_reference():
    counts = np.random.default_rng(3).integers(0, 90, 700)
    port, ref = PopulationIndex(counts), JaxIndex(counts)
    assert port.num_clients == ref.num_clients == 700
    assert port.total_samples() == ref.total_samples()
    assert port.weights().tobytes() == ref.weights().tobytes()
    ids = [5, 0, 699, 5]
    assert port.cohort_counts(ids).tolist() == ref.cohort_counts(ids).tolist()
    assert port.alias_table() is port.alias_table()  # built once
    with pytest.raises(ValueError):
        PopulationIndex(np.zeros(4)).weights()
    with pytest.raises(ValueError):
        PopulationIndex(np.zeros((2, 2)))


def test_index_files_cross_load_and_map_from_disk(tmp_path):
    counts = np.random.default_rng(1).integers(1, 50, 5000)
    PopulationIndex(counts).save(str(tmp_path / "port"))
    JaxIndex(counts).save(str(tmp_path / "ref"))
    for f in ("counts.npy", "index_meta.json"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes()
    for loaded in (PopulationIndex.load(str(tmp_path / "ref")), JaxIndex.load(str(tmp_path / "port"))):
        assert isinstance(loaded.counts, np.memmap)
        assert loaded.counts.tolist() == counts.tolist()
    # from_counts: above the threshold the index goes to a digest-named
    # directory under the parent, the reference's name, and is mapped
    port = PopulationIndex.from_counts(counts, path=str(tmp_path / "p"), mmap_threshold_bytes=1024)
    ref = JaxIndex.from_counts(counts, path=str(tmp_path / "r"), mmap_threshold_bytes=1024)
    assert os.listdir(tmp_path / "p") == os.listdir(tmp_path / "r")
    assert isinstance(port.counts, np.memmap)
    assert port.shape_classes(16, 4) == ref.shape_classes(16, 4)
    again = PopulationIndex.from_counts(counts, path=str(tmp_path / "p"), mmap_threshold_bytes=1024)
    assert again.counts.tolist() == counts.tolist()
    # below the threshold it stays on the heap
    small = PopulationIndex.from_counts(counts, path=str(tmp_path / "s"), mmap_threshold_bytes=1 << 30)
    assert not isinstance(small.counts, np.memmap) and not (tmp_path / "s").exists()
    meta = tmp_path / "port" / "index_meta.json"
    meta.write_text(json.dumps({"n": 3, "version": 1}))
    with pytest.raises(ValueError, match="counts length"):
        PopulationIndex.load(str(tmp_path / "port"))


def _ragged(n, seed=0):
    """(port, reference) FederatedDatasets of ``n`` clients holding the same
    ragged shards: 4 features, 3 classes, 5-40 samples a client."""
    from fedml_tpu.data.base import FederatedDataset as JaxDataset

    from fedml_tpu_torch.data.base import FederatedDataset

    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(int(c), 4)).astype(np.float32) for c in rng.integers(5, 41, n)]
    ys = [rng.integers(0, 3, len(x)).astype(np.int32) for x in xs]
    tx, ty = rng.normal(size=(12, 4)).astype(np.float32), rng.integers(0, 3, 12).astype(np.int32)
    return tuple(cls("ragged", list(xs), list(ys), tx, ty, 3)
                 for cls in (FederatedDataset, JaxDataset))


def test_dataset_population_index():
    data, _ = _ragged(9)
    idx = data.population_index()
    assert idx.counts.tolist() == data.train_sample_counts.tolist()
    assert data.total_train_samples() == idx.total_samples() == sum(len(y) for y in data.client_y)


# -- the scheduler's cohorts -------------------------------------------------------


N, K = 200, 7
COUNTS = np.random.default_rng(11).integers(0, 60, N)


def _schedulers(policy, threshold, factor=1.0, health=None):
    kw = dict(num_clients=N, k=K, policy=policy, seed=5, sample_counts=COUNTS,
              overprovision_factor=factor, ocohort_threshold=threshold)
    return (ClientScheduler(health=health, **kw), JaxScheduler(health=health, **kw))


@pytest.mark.parametrize("policy", ["weighted", "power_of_choice", "straggler_aware", "uniform"])
@pytest.mark.parametrize("threshold", [64, 65536])
@pytest.mark.parametrize("factor", [1.0, 1.4])
def test_cohorts_are_the_references_at_and_below_the_threshold(policy, threshold, factor):
    health = FlaggedHealth(flagged=[3, 17, 150, 151], slow={3: 2.0, 17: 1.5, 150: 3.0, 151: 1.2})
    port, ref = _schedulers(policy, threshold, factor, health)
    losses = np.random.default_rng(4)
    for r in range(6):
        assert port.select(r).tolist() == np.asarray(ref.select(r)).tolist(), r
        for cid in port.select(r):  # power_of_choice reads the losses
            v = float(losses.random())
            port.report_loss(int(cid), v)
            ref.report_loss(int(cid), v)
    engaged = threshold <= N and policy in ("weighted", "power_of_choice")
    assert (port._ctx.index is not None) == engaged == (ref._ctx.index is not None)


def test_below_the_threshold_the_draws_are_the_exact_numpy_draws():
    from fedml_tpu_torch.scheduler.policies import SelectionContext, _rng, _size_probs, _weighted_draw

    port, _ = _schedulers("weighted", 65536)
    ctx = SelectionContext(seed=5, num_clients=N, sample_counts=COUNTS)
    for r in range(4):
        want = _weighted_draw(_rng(ctx, r, salt=1), N, K, _size_probs(ctx))
        assert port.select(r).tolist() == want.tolist()
    # and at the threshold they are the alias table's
    port, _ = _schedulers("weighted", 64)
    alias = PopulationIndex(COUNTS).alias_table()
    assert port.select(0).tolist() == alias.draw_distinct(_rng(ctx, 0, salt=1), K).tolist()


def test_straggler_aware_tops_up_from_the_flagged_at_the_threshold():
    flagged = list(range(N - 3))  # only 3 fast clients
    health = FlaggedHealth(flagged=flagged, slow={c: float(c % 5) for c in flagged})
    port, ref = _schedulers("straggler_aware", 64, health=health)
    got = port.select(0)
    assert got.tolist() == np.asarray(ref.select(0)).tolist()
    assert {N - 3, N - 2, N - 1} <= set(got.tolist()) and len(got) == K


def test_from_config_builds_the_index_once_with_its_directory(tmp_path):
    import fedml_tpu.config as jcfg

    tdata, jdata = _ragged(96)
    pop = dict(ocohort_threshold=64, index_dir=str(tmp_path), index_mmap_bytes=16)
    port = ClientScheduler.from_config(population_config(tcfg, 96, "weighted", **pop), 96, data=tdata)
    ref = JaxScheduler.from_config(population_config(jcfg, 96, "weighted", **pop), 96, data=jdata)
    assert isinstance(port._ctx.index.counts, np.memmap)
    assert len(os.listdir(tmp_path)) == 1  # one digest directory, shared by both
    assert [port.select(r).tolist() for r in range(5)] == \
           [np.asarray(ref.select(r)).tolist() for r in range(5)]
    # a federation smaller than the data draws no index
    small = ClientScheduler.from_config(population_config(tcfg, 96, "weighted", **pop), 50, data=tdata)
    assert small._ctx.index is None and small._ctx.sample_counts is None


@pytest.mark.parametrize("policy", ["weighted", "power_of_choice"])
@time_limit(60)
def test_simulator_and_loopback_draw_the_same_cohorts_at_the_threshold(policy):
    """The reference's sim/transport parity with the O(cohort) draws
    engaged (population threshold 8 < 16 clients). straggler_aware reads
    wall-clock train times, which differ between the two runtimes; its
    draws are held above on a fixed flagged set."""
    data, jdata = _ragged(16)
    # full batch: a client's train loss (power_of_choice's signal) is the
    # same one step in the simulator and in its actor
    cfg = population_config(tcfg, 16, policy, ocohort_threshold=8, per_round=4, rounds=3,
                            seed=2, batch_size=-1)
    model = create_model("lr", "synthetic", (4,), 3)
    api = FedAvgAPI(cfg, data, model, device="cpu")
    assert api.scheduler._ctx.index is not None  # built for any policy at the threshold
    api.train()
    server = run_loopback_federation(cfg, data, model, device="cpu")
    assert api.scheduler.selections() == server.scheduler.selections()
    if policy == "weighted":  # no loss or timing input: the reference's cohorts too
        import fedml_tpu.config as jcfg

        ref = JaxScheduler.from_config(
            population_config(jcfg, 16, policy, ocohort_threshold=8, per_round=4, rounds=3,
                              seed=2, batch_size=-1), 16, data=jdata)
        assert api.scheduler.selections() == {r: np.asarray(ref.select(r)).tolist()
                                              for r in range(3)}


# -- the sharded state tier --------------------------------------------------------


def _tree():
    return {"a": np.zeros((3, 4), np.float32), "c": np.arange(5, dtype=np.int32)}


def _rows(rng, n):
    return {"a": rng.normal(size=(n, 3, 4)).astype(np.float32),
            "c": rng.integers(0, 9, (n, 5)).astype(np.int32)}


def test_sharded_tier_matches_the_mmap_tiers_of_both_packages():
    n = 500
    sharded = ShardedClientState(_tree(), n, shard_bits=6)
    others = [MmapClientState(_tree(), n), JaxMmapStore(_tree(), n),
              JaxSharded(_tree(), n, shard_bits=6)]
    rng = np.random.default_rng(0)
    for _ in range(15):
        ids = rng.choice(n, 9, replace=False)
        rows = _rows(rng, 9)
        for s in [sharded] + others:
            s.scatter(ids, rows)
        probe = rng.choice(n, 16, replace=False)
        got = sharded.gather(probe)
        for s in others:
            want = s.gather(probe)
            for k in got:
                assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
    for s in others:
        assert sharded.initialized_ids().tolist() == s.initialized_ids().tolist()
    assert sharded.state_bytes_total == others[0].state_bytes_total == n * (48 + 20)
    keep = sharded.initialized_ids()[:3]
    kept = sharded.gather(keep)
    for s in [sharded] + others:
        s.reset_to(keep, kept)
    everything = sharded.gather(np.arange(n))
    for s in others:
        want = s.gather(np.arange(n))
        assert all(everything[k].tobytes() == want[k].tobytes() for k in everything)
    assert sharded.initialized_count() == 3


def test_sharded_records_are_contiguous_and_sparse(tmp_path):
    s = ShardedClientState(_tree(), 100, path=str(tmp_path), shard_bits=5)
    assert sorted(os.listdir(tmp_path)) == ["init_mask.npy", "meta.json"] + [
        f"records_{i:05d}.bin" for i in range(4)]
    assert os.path.getsize(tmp_path / "records_00003.bin") == 4 * s.stride  # 100 - 3·32 rows
    rows = {"a": np.full((1, 3, 4), 2.5, np.float32), "c": np.full((1, 5), 7, np.int32)}
    s.scatter([70], rows)
    s.flush()
    raw = np.fromfile(tmp_path / "records_00002.bin", np.uint8).reshape(32, s.stride)[70 - 64]
    assert raw[:48].view(np.float32).tolist() == [2.5] * 12
    assert raw[48:].view(np.int32).tolist() == [7] * 5


def test_sharded_lazy_init_reopen_and_schema_refusal(tmp_path):
    path = str(tmp_path / "store")
    s = ShardedClientState(_tree(), 100, path=path, shard_bits=5)
    assert s.gather([42])["c"][0].tolist() == list(range(5))  # the initial row
    assert s.initialized_count() == 0
    s.scatter([42], {"a": np.ones((1, 3, 4), np.float32), "c": np.full((1, 5), 7, np.int32)})
    s.flush()
    again = ShardedClientState(_tree(), 100, path=path, shard_bits=5)
    assert again.gather([42])["c"][0].tolist() == [7] * 5
    assert again.initialized_count() == 1
    for n, bits, tree in ((101, 5, _tree()), (100, 6, _tree()),
                          (100, 5, {"a": np.zeros((3, 4), np.float64), "c": _tree()["c"]})):
        with pytest.raises(ValueError, match="existing sharded state store"):
            ShardedClientState(tree, n, path=path, shard_bits=bits)
    with pytest.raises(ValueError, match="state_shard_bits"):
        ShardedClientState(_tree(), 100, shard_bits=3)
    with pytest.raises(ValueError, match="empty"):
        ShardedClientState({"z": np.zeros((0,), np.float32)}, 10)
    # a temporary store is removed when collected; a named one is kept
    tmp = ShardedClientState(_tree(), 10)
    tmp_dir = tmp.path
    del tmp
    import gc

    gc.collect()
    assert not os.path.exists(tmp_dir) and os.path.isdir(path)


def test_make_spill_store_builds_the_sharded_tier_with_the_populations_bits():
    pop = tcfg.PopulationConfig(state_shard_bits=4)
    store = make_spill_store("sharded", _tree(), 40, population=pop)
    assert isinstance(store, ShardedClientState) and store.shard_bits == 4
    assert len(store._shards) == 3
    assert make_spill_store("sharded", _tree(), 40).shard_bits == 16


@time_limit(30)
def test_prefetcher_reads_the_sharded_tier():
    store = ShardedClientState(_tree(), 64, shard_bits=4)
    rng = np.random.default_rng(1)
    store.scatter([0, 17, 40], _rows(rng, 3))
    pre = CohortPrefetcher(store)
    pre.launch(2, [17, 40, 63], exclude={40})
    store.scatter([40], _rows(rng, 1))
    got = pre.take(2, [17, 40, 63])
    want = store.gather([17, 40, 63])
    assert all(got[k].tobytes() == want[k].tobytes() for k in got)


def test_auto_picks_the_sharded_tier_at_the_threshold_and_it_runs():
    fed = tcfg.FedConfig(state_store="auto", state_budget_bytes=1000)
    pop = tcfg.PopulationConfig(ocohort_threshold=1000)
    assert resolve_state_store(fed, 999, n_clients=5000, population=pop) == "device"
    assert resolve_state_store(fed, 1001, n_clients=5000, population=pop) == "sharded"
    assert resolve_state_store(fed, 1001, n_clients=10, population=pop) == "mmap"
    # SCAFFOLD past the budget on a population at the threshold trains there
    from torch_parity import lr_config, lr_data, torch_lr_model

    cfg = lr_config(tcfg, train={"lr": 0.1})
    cfg = cfg.replace(fed=dataclasses.replace(cfg.fed, state_budget_bytes=16),
                      population=tcfg.PopulationConfig(ocohort_threshold=4, state_shard_bits=4))
    api = ScaffoldAPI(cfg, lr_data(synthetic_classification), torch_lr_model(), device="cpu")
    assert api.state.mode == "sharded" and isinstance(api.state.store, ShardedClientState)
    assert api.state.store.shard_bits == 4
    api.train()
    assert api.state.store.initialized_count() == 4


STATE_TIERS = ("device", "mmap", "sharded")


@pytest.mark.parametrize("jax_cls,torch_cls", [(JaxScaffold, ScaffoldAPI), (JaxDitto, DittoAPI)])
@time_limit(60)
def test_state_tiers_are_bit_identical(jax_cls, torch_cls):
    """3 rounds of 2 of the LR fixture's 4 clients at batch 4 (rows are
    gathered, trained, scattered and gathered again) under each tier: the
    model and every client's row bit-equal; the spilled tiers report their
    gather and scatter ms each round."""
    runs = {}
    for mode in STATE_TIERS:
        _, api = lr_pair(jax_cls, torch_cls, fed={"client_num_per_round": 2, "state_store": mode},
                         batch_size=4)
        api.train()
        assert api.state.mode == mode
        runs[mode] = api
    assert isinstance(runs["sharded"].state.store, ShardedClientState)
    dev = runs["device"]
    for mode in ("mmap", "sharded"):
        api = runs[mode]
        for k, v in dev.global_vars.items():
            assert torch.equal(api.global_vars[k], v), (mode, k)
        for i in range(dev.config.fed.client_num_in_total):
            got, want = api.state.row(i), dev.state.row(i)
            assert all(torch.equal(got[k], want[k]) for k in want), (mode, i)
        assert len(api.state.spill_ms) == 3
        assert all(set(r) == {"gather_ms", "scatter_ms"} for r in api.state.spill_ms)
    assert not [t for t in threading.enumerate() if t.name == "cohort-prefetch" and t.is_alive()]


@time_limit(90)
def test_sharded_scaffold_matches_the_references():
    """The port's SCAFFOLD on the sharded tier against the reference's on
    its own sharded tier: the LR fixture, all 4 clients, full batch, 3
    rounds; params, the server control variate and every client's row."""
    from fedml_tpu_torch.bridge import to_flax

    from torch_parity import flat_params

    fed = {"state_store": "sharded"}

    def run():
        japi, _ = lr_pair(JaxScaffold, ScaffoldAPI, fed=fed)
        assert japi._state_mode == "sharded"
        init = jax.device_get(japi.global_vars)
        japi.train()
        return dict(init=init, params=jax.device_get(japi.global_vars),
                    c=jax.device_get(japi.c_server),
                    rows=japi._c_store.gather(np.arange(4)))

    ref = reference_record("sharded_scaffold_lr", fed, run)
    _, api = lr_pair(JaxScaffold, ScaffoldAPI, fed=fed)
    api.train()
    tol = dict(rtol=1e-5, atol=1e-6)
    for got, want, lead in ((api.global_vars, ref.params, 0), (api.c_server, ref.c, 0),
                            (api.state.store.gather(np.arange(4)), ref.rows, 1)):
        got = flat_params(to_flax(got, lead))
        want = flat_params(want.get("params", want))
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, **tol, err_msg=k)


@time_limit(60)
def test_cli_state_store_sharded_runs_as_the_device_stack(tmp_path):
    """``--state_store sharded`` (refused before this tier) trains SCAFFOLD
    as ``--state_store device`` does, bit for bit."""
    from fedml_tpu_torch import cli as tcli

    apis = {}
    for mode in ("device", "sharded"):
        apis[mode] = tcli.main([
            "--algorithm", "scaffold", "--model", "lr", "--dataset", "synthetic",
            "--client_num_in_total", "8", "--client_num_per_round", "3", "--comm_round", "2",
            "--batch_size", "8", "--state_store", mode, "--state_dir", str(tmp_path / mode),
        ], device="cpu")
    assert isinstance(apis["sharded"].state.store, ShardedClientState)
    assert sorted(os.listdir(tmp_path / "sharded")) == ["init_mask.npy", "meta.json",
                                                         "records_00000.bin"]
    for k, v in apis["device"].global_vars.items():
        assert torch.equal(apis["sharded"].global_vars[k], v), k
    for i in range(8):
        got, want = apis["sharded"].state.row(i), apis["device"].state.row(i)
        assert all(torch.equal(got[k], want[k]) for k in want), i
