"""Shared inputs for the parity tests of the PyTorch port
(tests/test_torch_*.py): the reference's shuffle permutations, computed with
JAX and handed to the port, the small FedAvg slice both packages run, the
logistic-regression fixture of the transport tests, a private program
cache for the reference's compiled programs, and an on-disk cache of the
reference's slice runs (:func:`reference_record`).

The port cannot reproduce JAX's threefry stream, so its local train takes a
permutation source ``perm_fn(round, client_slot, epoch, mask_flat)``; these
helpers feed it exactly the permutations the reference draws
(``fold_in(split(fold_in(PRNGKey(seed), r + 1), C)[j], epoch)``,
fedml_tpu/algorithms/fedavg.py ``_round_placed`` and
fedml_tpu/train/client.py ``masked_epoch_perm``)."""

from __future__ import annotations

import contextlib
import fcntl
import functools
import hashlib
import inspect
import io
import json
import os
import random
import signal
import socket
import tempfile
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def jax_epoch_perm(client_rng, epoch: int, m_flat: torch.Tensor) -> torch.Tensor:
    """The reference's epoch permutation for one client key."""
    import jax
    import jax.numpy as jnp

    from fedml_tpu.train.client import masked_epoch_perm

    perm = masked_epoch_perm(
        jax.random.fold_in(client_rng, epoch), jnp.asarray(m_flat.numpy())
    )
    return torch.from_numpy(np.asarray(perm).astype(np.int64))


def jax_transport_perm_fn(seed: int):
    """``perm_fn`` for the port's transport ``LocalTrainer`` that yields the
    reference LocalTrainer's permutations: its key is keyed by the CLIENT
    index, ``fold_in(PRNGKey(seed), (round + 1)·7919 + client_index)``
    (fedml_tpu/algorithms/fedavg_transport.py ``LocalTrainer._train``)."""
    import jax

    base = jax.random.PRNGKey(seed)

    def perm_fn(round_idx, client_index, epoch, m_flat):
        rng = jax.random.fold_in(base, (round_idx + 1) * 7919 + client_index)
        return jax_epoch_perm(rng, epoch, m_flat)

    return perm_fn


@contextlib.contextmanager
def private_reference_programs(path):
    """Run the reference with a ProgramCache and a serialized-executable
    store of its own (under ``path``), restoring the process-wide ones on
    exit. The session store of tests/conftest.py keys an executable without
    its input sharding, so a program another test compiled for the 8-device
    mesh can be handed to a single-device call of the same shapes and fail
    there ("Expected args ... to have 8 shards"); with a private store and
    cache every reference program these tests run is compiled here, for the
    arguments they give it."""
    from fedml_tpu.compile import ProgramCache, use_program_cache
    from fedml_tpu.compile.executable_cache import install_run_executable_cache

    _, restore = install_run_executable_cache(str(path))
    try:
        with use_program_cache(ProgramCache()):
            yield
    finally:
        restore()


def variables_digest(variables) -> str:
    """SHA-256 of port variables (names and bytes): a ``reference_record``
    argument for a reference run that starts from the port's init."""
    h = hashlib.sha256()
    for k in sorted(variables):
        h.update(k.encode() + variables[k].numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def torch_threads(n: int):
    """Run the block with ``n`` intra-op threads, then restore the count.
    The model-bound slice's tests run models of a few thousand weights,
    whose ops gain nothing from threads; on a loaded host (6 test workers)
    8 threads a process spin against each other and make a round ~20×
    slower."""
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def time_limit(seconds: float):
    """Fail the decorated test with TimeoutError once it has run
    ``seconds`` (SIGALRM in the main thread, which interrupts a blocked
    queue get, lock wait, join or socket read there): for tests that open a
    socket or wait on a deadline, so a hang fails the test instead of the
    suite."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            def on_alarm(signum, frame):
                raise TimeoutError(f"{fn.__name__} ran past its {seconds} s limit")

            old = signal.signal(signal.SIGALRM, on_alarm)
            signal.setitimer(signal.ITIMER_REAL, seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.setitimer(signal.ITIMER_REAL, 0)
                signal.signal(signal.SIGALRM, old)

        return wrapper

    return deco


def free_port_block(n: int, tries: int = 200) -> int:
    """A base port b such that b .. b+n-1 are free on 127.0.0.1 now (for
    transports that bind ``base_port + rank``)."""
    rng = random.Random()
    for _ in range(tries):
        base = rng.randrange(20000, 60000 - n)
        socks = []
        try:
            for port in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no block of {n} free ports")


# the transport tests' logistic-regression fixture
# (tests/test_transport_algorithms.py): 4 IID clients of 6-12 samples, 5
# features, 3 classes, all 4 clients every round, full batch (the
# deterministic oracle: one step of every sample, so the shuffles do not
# matter), 3 rounds, evaluated at rounds 0 and 2
LR = dict(num_clients=4, num_classes=3, feat=(5,), samples=12, data_seed=9, rounds=3, seed=0)


def lr_data(synthetic_classification):
    """The fixture's data from either package's ``synthetic_classification``."""
    return synthetic_classification(
        num_clients=LR["num_clients"], num_classes=LR["num_classes"], feat_shape=LR["feat"],
        samples_per_client=LR["samples"], partition_method="homo", seed=LR["data_seed"],
    )


def lr_config(cfg_mod, train: dict, server: dict | None = None, comm: dict | None = None,
              epochs: int = 1, batch_size: int = -1):
    """The fixture's RunConfig in either package's config module."""
    return cfg_mod.RunConfig(
        data=cfg_mod.DataConfig(batch_size=batch_size),
        fed=cfg_mod.FedConfig(
            client_num_in_total=LR["num_clients"], client_num_per_round=LR["num_clients"],
            comm_round=LR["rounds"], epochs=epochs, frequency_of_the_test=3,
        ),
        train=cfg_mod.TrainConfig(**train),
        server=cfg_mod.ServerConfig(**(server or {})),
        comm=cfg_mod.CommConfig(**(comm or {})),
        seed=LR["seed"],
    )


def jax_lr_model():
    from fedml_tpu.models import create_model

    return create_model("lr", "synthetic", LR["feat"], LR["num_classes"])


def torch_lr_model():
    from fedml_tpu_torch.models import create_model

    return create_model("lr", "synthetic", LR["feat"], LR["num_classes"])


def jax_round_perm_fn(seed: int, cohort):
    """``perm_fn`` for the port's FedAvgAPI that yields the reference
    FedAvgAPI's permutations for run seed ``seed`` and cohort size
    ``cohort``: the round's key split over that many slots. ``cohort`` may
    be a function of the round (a fault plan shrinks cohorts; DP-FedAvg
    splits over ``bucket_cohort`` of its Poisson draw)."""
    import jax

    base = jax.random.PRNGKey(seed)
    size = cohort if callable(cohort) else (lambda r: cohort)

    def perm_fn(round_idx, slot, epoch, m_flat):
        rngs = jax.random.split(jax.random.fold_in(base, round_idx + 1), size(round_idx))
        return jax_epoch_perm(rngs[slot], epoch, m_flat)

    return perm_fn


def jax_noise_fn(seed: int):
    """``noise_fn`` for the port's APIs that yields the reference's noise:
    ``normal(split(fold_in(fold_in(PRNGKey(seed), round + 1), tag),
    n_leaves)[i])`` for leaf i of the variables tree in ``jax.tree_util``
    order, drawn in the reference's layout and handed back in the port's
    (conv kernels HWIO -> OIHW, dense kernels transposed)."""
    import jax
    import jax.numpy as jnp

    from fedml_tpu_torch.bridge import from_flax, to_flax_variables

    base = jax.random.PRNGKey(seed)

    def noise_fn(round_idx, tag, names, shapes):
        key = jax.random.fold_in(jax.random.fold_in(base, round_idx + 1), tag)
        tree = to_flax_variables({n: torch.zeros(s) for n, s in zip(names, shapes)})
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        keys = jax.random.split(key, len(leaves))
        drawn = [np.asarray(jax.random.normal(k, leaf.shape, jnp.float32))
                 for k, leaf in zip(keys, leaves)]
        port = from_flax(jax.tree_util.tree_unflatten(treedef, drawn))
        return [port[n] for n in names]

    return noise_fn


# the whole-slice comparison: femnist_synthetic(12 clients, 40 mean samples),
# 4 clients per round, batch 20, E=1, SGD lr 0.1, the 62-class CNN, 3 rounds
SLICE = dict(num_clients=12, mean_samples=40, per_round=4, rounds=3, seed=0)


def _slice_config(cfg_mod, rounds: int = SLICE["rounds"], server: dict | None = None,
                  per_round: int = SLICE["per_round"], batch_size: int = 20):
    return cfg_mod.RunConfig(
        data=cfg_mod.DataConfig(batch_size=batch_size),
        fed=cfg_mod.FedConfig(
            client_num_in_total=SLICE["num_clients"],
            client_num_per_round=per_round,
            comm_round=rounds,
            epochs=1,
        ),
        train=cfg_mod.TrainConfig(lr=0.1),
        server=cfg_mod.ServerConfig(**(server or {})),
        seed=SLICE["seed"],
    )


def slice_data():
    """The slice's femnist_synthetic data from each package (reference, port)."""
    from fedml_tpu.data.femnist_synth import femnist_synthetic as jax_femnist

    from fedml_tpu_torch.data.femnist_synth import femnist_synthetic

    data_kw = dict(num_clients=SLICE["num_clients"], mean_samples=SLICE["mean_samples"])
    return jax_femnist(**data_kw), femnist_synthetic(**data_kw)


def slice_models():
    """The slice's 62-class CNN from each package (reference, port)."""
    from fedml_tpu.models import create_model as jax_create_model

    from fedml_tpu_torch.models import create_model

    shape, classes = (28, 28, 1), 62
    return (jax_create_model("cnn", "femnist", shape, classes),
            create_model("cnn", "femnist", shape, classes))


def slice_configs(rounds: int = SLICE["rounds"], per_round: int = SLICE["per_round"],
                  batch_size: int = 20):
    """The slice's RunConfig from each package (reference, port)."""
    import fedml_tpu.config as jcfg

    import fedml_tpu_torch.config as tcfg

    kw = dict(rounds=rounds, per_round=per_round, batch_size=batch_size)
    return _slice_config(jcfg, **kw), _slice_config(tcfg, **kw)


def share_init(japi, tapi) -> None:
    """Start the port's API from the reference's init."""
    from fedml_tpu_torch.bridge import from_flax

    tapi.global_vars = from_flax(
        {"params": {layer: {k: np.array(v) for k, v in leaves.items()}
                    for layer, leaves in japi.global_vars["params"].items()}}
    )


def run_slice(robust: dict | None = None, server: dict | None = None,
              rounds: int = SLICE["rounds"], per_round: int = SLICE["per_round"]):
    """Run the slice through the reference and through the port on the CPU,
    from the reference's init and with its permutations (and its noise).
    ``robust`` holds RobustConfig fields, ``server`` ServerConfig fields for
    FedOptAPI (both None: plain FedAvgAPI); ``per_round`` the cohort size.
    Returns ``(reference_record, port_api)`` after ``rounds`` rounds of
    training: the record's ``global_vars`` and ``history`` are the
    reference API's (:func:`reference_record`, cached on disk)."""
    import fedml_tpu_torch.config as tcfg
    from fedml_tpu_torch.algorithms import FedAvgAPI, RobustFedAvgAPI
    from fedml_tpu_torch.bridge import from_flax
    from fedml_tpu_torch.data.femnist_synth import femnist_synthetic
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.robustness import RobustConfig

    def run():
        import jax

        import fedml_tpu.config as jcfg
        from fedml_tpu.algorithms import FedAvgAPI as JaxFedAvg
        from fedml_tpu.algorithms.fedavg_robust import RobustFedAvgAPI as JaxRobust
        from fedml_tpu.algorithms.fedopt import FedOptAPI as JaxFedOpt
        from fedml_tpu.data.femnist_synth import femnist_synthetic as jax_femnist
        from fedml_tpu.models import create_model as jax_create_model
        from fedml_tpu.robustness import RobustConfig as JaxRobustConfig

        jdata = jax_femnist(num_clients=SLICE["num_clients"], mean_samples=SLICE["mean_samples"])
        jmodel = jax_create_model("cnn", "femnist", (28, 28, 1), 62)
        jconf = _slice_config(jcfg, rounds, server, per_round=per_round)
        if server is not None:
            japi = JaxFedOpt(jconf, jdata, jmodel)
        elif robust is None:
            japi = JaxFedAvg(jconf, jdata, jmodel)
        else:
            japi = JaxRobust(jconf, jdata, jmodel, robust=JaxRobustConfig(**robust))
        init = jax.device_get(japi.global_vars)
        japi.train()
        return dict(init=init, global_vars=jax.device_get(japi.global_vars),
                    history=list(japi.history))

    ref = reference_record(
        "run_slice", dict(robust=robust, server=server, rounds=rounds, per_round=per_round), run
    )
    tdata = femnist_synthetic(num_clients=SLICE["num_clients"], mean_samples=SLICE["mean_samples"])
    tmodel = create_model("cnn", "femnist", (28, 28, 1), 62)
    tconf = _slice_config(tcfg, rounds, server, per_round=per_round)
    perm_fn = jax_round_perm_fn(SLICE["seed"], per_round)
    if server is not None:
        from fedml_tpu_torch.algorithms import FedOptAPI

        tapi = FedOptAPI(tconf, tdata, tmodel, device="cpu", perm_fn=perm_fn)
    elif robust is None:
        tapi = FedAvgAPI(tconf, tdata, tmodel, device="cpu", perm_fn=perm_fn)
    else:
        tapi = RobustFedAvgAPI(
            tconf, tdata, tmodel, robust=RobustConfig(**robust), device="cpu", perm_fn=perm_fn,
            noise_fn=jax_noise_fn(SLICE["seed"]),
        )
    tapi.global_vars = from_flax(ref.init["params"])
    tapi.train()
    return ref, tapi


def assert_slice_close(japi, tapi, rtol=1e-4, atol=1e-5, row_tol=1e-4, rounds=SLICE["rounds"]):
    """Global params allclose; every logged metric within ``row_tol``."""
    from fedml_tpu_torch.bridge import to_flax

    got = to_flax(tapi.global_vars)
    want = japi.global_vars["params"]
    assert got.keys() == want.keys()
    for layer in want:
        for leaf in want[layer]:
            np.testing.assert_allclose(
                got[layer][leaf], np.asarray(want[layer][leaf]),
                rtol=rtol, atol=atol, err_msg=f"{layer}/{leaf}",
            )
    assert len(tapi.history) == len(japi.history) == rounds
    for trow, jrow in zip(tapi.history, japi.history):
        keys = {k for k in jrow if k != "round_time_s"}
        assert keys <= trow.keys(), keys - trow.keys()
        for k in keys:
            assert abs(trow[k] - jrow[k]) <= row_tol, (k, trow[k], jrow[k])


# the LM slice: synthetic_shakespeare(4 clients, ~16 windows of 64 tokens,
# vocab 64), a 2-layer, 2-head, 32-wide TransformerLM with flash attention
# (blocks of 32), all 4 clients each round, batch 8, E=1, 2 rounds, task nwp
LM_SLICE = dict(num_clients=4, samples_per_client=16, seq_len=64, vocab=64,
                layers=2, heads=2, width=32, block=32, batch=8, rounds=2, seed=0)


def lm_data_kw():
    s = LM_SLICE
    return dict(num_clients=s["num_clients"], samples_per_client=s["samples_per_client"],
                seq_len=s["seq_len"], vocab_size=s["vocab"], seed=s["seed"], seq_targets=True)


def lm_model_kw(flash_fn):
    """create_model options of the LM slice with ``flash_fn`` (either
    package's ``flash_attention_bthd``) at the slice's blocks."""
    import functools

    s = LM_SLICE
    return dict(num_layers=s["layers"], num_heads=s["heads"], embed_dim=s["width"],
                attn_fn=functools.partial(flash_fn, block_q=s["block"], block_k=s["block"]))


def _lm_config(cfg_mod, compute_dtype, optimizer, lr, schedule="scan"):
    s = LM_SLICE
    return cfg_mod.RunConfig(
        data=cfg_mod.DataConfig(batch_size=s["batch"]),
        fed=cfg_mod.FedConfig(
            client_num_in_total=s["num_clients"], client_num_per_round=s["num_clients"],
            comm_round=s["rounds"], epochs=1, client_parallelism=schedule,
        ),
        train=cfg_mod.TrainConfig(client_optimizer=optimizer, lr=lr, compute_dtype=compute_dtype),
        seed=s["seed"],
    )


def run_lm_slice(compute_dtype: str, optimizer: str, lr: float, port_schedule: str = "scan"):
    """FedAvgAPI(task="nwp") on the LM slice through the reference (client
    schedule "scan") and through the port on the CPU (``port_schedule``),
    from the reference's init with its permutations. Returns ``(reference_record, port_api,
    init)`` with ``init`` the shared initial params (flat, numpy); the
    record's ``global_vars`` and ``history`` are the reference API's
    (:func:`reference_record`, cached on disk)."""
    import fedml_tpu_torch.config as tcfg
    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.bridge import from_flax
    from fedml_tpu_torch.data.synthetic import synthetic_shakespeare
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops.flash_attention import flash_attention_bthd

    s = LM_SLICE
    shape = (s["seq_len"],)
    args = (compute_dtype, optimizer, lr)

    def run():
        import jax

        import fedml_tpu.config as jcfg
        from fedml_tpu.algorithms import FedAvgAPI as JaxFedAvg
        from fedml_tpu.data.synthetic import synthetic_shakespeare as jax_shakespeare
        from fedml_tpu.models import create_model as jax_create_model
        from fedml_tpu.ops.flash_attention import flash_attention_bthd as jax_flash

        jmodel = jax_create_model("transformer", "shakespeare_synth", shape, s["vocab"],
                                  **lm_model_kw(jax_flash))
        japi = JaxFedAvg(_lm_config(jcfg, *args), jax_shakespeare(**lm_data_kw()), jmodel,
                         task="nwp")
        init = jax.device_get(japi.global_vars)
        japi.train()
        return dict(init=init, global_vars=jax.device_get(japi.global_vars),
                    history=list(japi.history))

    ref = reference_record(
        "run_lm_slice", dict(compute_dtype=compute_dtype, optimizer=optimizer, lr=lr), run
    )
    tmodel = create_model("transformer", "shakespeare_synth", shape, s["vocab"],
                          **lm_model_kw(flash_attention_bthd))
    tapi = FedAvgAPI(
        _lm_config(tcfg, *args, schedule=port_schedule), synthetic_shakespeare(**lm_data_kw()),
        tmodel, task="nwp",
        device="cpu", perm_fn=jax_round_perm_fn(s["seed"], s["num_clients"]),
    )
    tapi.global_vars = from_flax(ref.init["params"])
    tapi.train()
    return ref, tapi, flat_params(ref.init["params"])


def flat_params(tree, prefix: str = "") -> dict:
    """Nested flax-style params → {"scope/.../leaf": numpy array}."""
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(flat_params(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def jax_ditto_personal_perm_fn(seed: int, cohort):
    """``personal_perm_fn`` for the port's DittoAPI that yields the
    reference's personal-train permutations: each client's round key
    folded with 0x0D1770 (fedml_tpu/algorithms/ditto.py
    ``_make_ditto_cohort_body``)."""
    import jax

    base = jax.random.PRNGKey(seed)
    size = cohort if callable(cohort) else (lambda r: cohort)

    def perm_fn(round_idx, slot, epoch, m_flat):
        rngs = jax.random.split(jax.random.fold_in(base, round_idx + 1), size(round_idx))
        return jax_epoch_perm(jax.random.fold_in(rngs[slot], 0x0D1770), epoch, m_flat)

    return perm_fn


def algorithm_pair(jax_cls, torch_cls, jax_kw=None, torch_kw=None, rounds: int = SLICE["rounds"],
                   per_round: int = SLICE["per_round"], batch_size: int = 20, fed=None,
                   train=None, data=None, models=None):
    """The reference's ``jax_cls`` and the port's ``torch_cls`` on the same
    inputs, built but not trained: the CNN slice by default (``data`` and
    ``models`` are (reference, port) pairs to use instead), ``fed`` and
    ``train`` FedConfig/TrainConfig fields set on both configs, the port
    on the CPU from the reference's init (its model's ``init`` returns it,
    so state initialised from the model, Ditto's v_k = w_0, starts there
    too) with the reference's shuffles."""
    import dataclasses

    import jax

    from fedml_tpu_torch.bridge import from_flax

    jdata, tdata = data or slice_data()
    jmodel, tmodel = models or slice_models()

    def edit(cfg):
        return cfg.replace(fed=dataclasses.replace(cfg.fed, **(fed or {})),
                           train=dataclasses.replace(cfg.train, **(train or {})))

    jconf, tconf = (edit(c) for c in slice_configs(rounds, per_round, batch_size))
    japi = jax_cls(jconf, jdata, jmodel, **(jax_kw or {}))
    init = from_flax(jax.device_get(japi.global_vars))
    tmodel.init = lambda generator: {k: v.clone() for k, v in init.items()}
    kw = dict(device="cpu", perm_fn=jax_round_perm_fn(SLICE["seed"], per_round))
    kw.update(torch_kw or {})
    return japi, torch_cls(tconf, tdata, tmodel, **kw)


def lr_pair(jax_cls, torch_cls, jax_kw=None, torch_kw=None, fed=None, train=None,
            batch_size: int = -1, rounds: int = LR["rounds"], data=None):
    """:func:`algorithm_pair` on the logistic-regression fixture (full batch
    by default), all of its clients in every round."""
    from fedml_tpu.data.synthetic import synthetic_classification as jax_synthetic

    from fedml_tpu_torch.data.synthetic import synthetic_classification

    n = LR["num_clients"]
    return algorithm_pair(
        jax_cls, torch_cls, jax_kw, torch_kw, rounds=rounds, per_round=n, batch_size=batch_size,
        fed={"client_num_in_total": n, **(fed or {})}, train={"lr": 0.1, **(train or {})},
        data=data or (lr_data(jax_synthetic), lr_data(synthetic_classification)),
        models=(jax_lr_model(), torch_lr_model()),
    )


# -- the reference's slice runs, cached on disk --------------------------------
#
# A reference CNN round costs ~18 s on one CPU core, and the parity tests
# compare the port with the same few reference runs every time. A run's
# outputs (params as arrays, history rows, cohorts, whatever else a test
# reads) are kept under the system temp directory, keyed by a SHA-256 of
# every ``fedml_tpu/**/*.py`` and of the call's arguments, so any edit of
# the reference, or another call, misses and runs the reference as before.
# Entries are written atomically, and a worker that misses waits for
# another that is already running the same call (a lock file a key).
# FEDML_REF_CACHE=0 turns the cache off.

REF_CACHE_DIR = Path(tempfile.gettempdir()) / f"fedml_torch_refcache_u{os.getuid()}"


@functools.lru_cache(maxsize=None)
def reference_source_digest() -> str:
    """SHA-256 over the path and bytes of every ``fedml_tpu/**/*.py``."""
    h = hashlib.sha256()
    src = ROOT / "fedml_tpu"
    for path in sorted(src.rglob("*.py")):
        h.update(str(path.relative_to(src)).encode() + b"\0")
        h.update(path.read_bytes() + b"\0")
    return h.hexdigest()


def _encode(obj, path: str, arrays: dict):
    """A JSON skeleton of ``obj`` with its arrays moved into ``arrays``."""
    if isinstance(obj, dict):
        return {"d": {str(k): _encode(v, f"{path}/{k}", arrays) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"l": [_encode(v, f"{path}/{i}", arrays) for i, v in enumerate(obj)]}
    if isinstance(obj, np.generic):
        return {"v": obj.item()}
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):  # numpy or JAX array
        arrays[path] = np.asarray(obj)
        return {"a": path}
    return {"v": obj}


def _decode(node, arrays):
    if "d" in node:
        return {k: _decode(v, arrays) for k, v in node["d"].items()}
    if "l" in node:
        return [_decode(v, arrays) for v in node["l"]]
    if "a" in node:
        return arrays[node["a"]]
    return node["v"]


def reference_record(kind: str, args: dict, run) -> types.SimpleNamespace:
    """``run()``'s record (a dict of trees of arrays and JSON values) for
    the reference call ``kind`` with ``args``, from the cache when the
    reference's sources and the arguments are the ones it was made from;
    ``run()`` is called, and its record stored, on a miss."""
    key = hashlib.sha256(json.dumps(
        {"src": reference_source_digest(), "kind": kind, "args": args}, sort_keys=True, default=str,
    ).encode()).hexdigest()
    path = REF_CACHE_DIR / f"{key}.npz"
    if os.environ.get("FEDML_REF_CACHE", "1") == "0":
        return types.SimpleNamespace(**run())
    REF_CACHE_DIR.mkdir(parents=True, exist_ok=True)
    with open(path.with_suffix(".lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another worker may be running this call
        if path.exists():
            with np.load(path, allow_pickle=False) as z:
                arrays = {k[2:]: z[k] for k in z.files if k.startswith("a:")}
                skeleton = json.loads(bytes(z["json"]).decode())
            return types.SimpleNamespace(**_decode(skeleton, arrays))
        record = run()
        arrays: dict = {}
        skeleton = _encode(record, "", arrays)
        buf = io.BytesIO()
        np.savez(buf, json=np.frombuffer(json.dumps(skeleton).encode(), np.uint8),
                 **{f"a:{k}": v for k, v in arrays.items()})
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_bytes(buf.getvalue())
        os.replace(tmp, path)
    return types.SimpleNamespace(**record)


def port_api(torch_cls, init, per_round=SLICE["per_round"], torch_kw=None,
             rounds=SLICE["rounds"], batch_size=20, fed=None, train=None):
    """The port's ``torch_cls`` on the slice, built from the port-layout
    ``init`` with the reference's shuffles (see :func:`algorithm_pair`)."""
    import dataclasses

    _, tdata = slice_data()
    _, tmodel = slice_models()
    _, tconf = slice_configs(rounds, per_round, batch_size)
    tconf = tconf.replace(fed=dataclasses.replace(tconf.fed, **(fed or {})),
                          train=dataclasses.replace(tconf.train, **(train or {})))
    tmodel.init = lambda generator: {k: v.clone() for k, v in init.items()}
    kw = dict(device="cpu", perm_fn=jax_round_perm_fn(SLICE["seed"], per_round))
    kw.update(torch_kw or {})
    return torch_cls(tconf, tdata, tmodel, **kw)


def trained_pair(jax_cls, torch_cls, jax_kw=None, torch_kw=None, rounds: int = SLICE["rounds"],
                 per_round: int = SLICE["per_round"], batch_size: int = 20, fed=None, train=None,
                 extras=None):
    """:func:`algorithm_pair` on the CNN slice with the reference TRAINED:
    ``(record, port_api)``, the port built from the reference's init and
    not trained. The record holds the reference's ``global_vars``,
    ``history`` and ``final`` (what its ``train()`` returned), and one
    field a name of ``extras`` ({name: fn(trained reference api)}); it
    comes from :func:`reference_record`'s cache when it can."""
    from fedml_tpu_torch.bridge import from_flax

    extras = extras or {}
    args = dict(cls=f"{jax_cls.__module__}.{jax_cls.__qualname__}", jax_kw=jax_kw, rounds=rounds,
                per_round=per_round, batch_size=batch_size, fed=fed, train=train,
                extras={k: inspect.getsource(fn) for k, fn in sorted(extras.items())})

    def run():
        import jax

        japi, _ = algorithm_pair(jax_cls, torch_cls, jax_kw, torch_kw, rounds, per_round,
                                 batch_size, fed, train)
        init = jax.device_get(japi.global_vars)
        final = japi.train()
        out = dict(init=init, global_vars=jax.device_get(japi.global_vars),
                   history=list(japi.history), final=final)
        out.update({k: fn(japi) for k, fn in extras.items()})
        return out

    ref = reference_record("algorithm_pair", args, run)
    tapi = port_api(torch_cls, from_flax(ref.init), per_round, torch_kw, rounds, batch_size, fed,
                    train)
    return ref, tapi


# -- the population tier ------------------------------------------------------


class FlaggedHealth:
    """A client health registry as ``straggler_aware`` reads it: a fixed
    flagged set and each flagged client's mean train seconds."""

    def __init__(self, flagged, slow):
        self.flagged, self.slow = list(flagged), dict(slow)

    def straggler_ids(self):
        return list(self.flagged)

    def mean_train_s(self, cid):
        return self.slow.get(int(cid))


def population_config(cfg_mod, n: int, selection: str = "uniform", per_round: int = 4,
                      rounds: int = 3, seed: int = 0, batch_size: int = 8, **population):
    """A RunConfig in either package's config module over ``n`` clients with
    the named selection and PopulationConfig fields (lr 0.1, no device
    cache, the test round only at the end)."""
    return cfg_mod.RunConfig(
        data=cfg_mod.DataConfig(batch_size=batch_size, device_cache=False),
        fed=cfg_mod.FedConfig(client_num_in_total=n, client_num_per_round=per_round,
                              comm_round=rounds, epochs=1, selection=selection,
                              frequency_of_the_test=100),
        train=cfg_mod.TrainConfig(lr=0.1),
        population=cfg_mod.PopulationConfig(**population),
        seed=seed,
    )


def write_stackoverflow(path, words: int = 10000, tags: int = 600, clients: int = 5,
                        seed: int = 0) -> None:
    """The StackOverflow files in the TFF layout under ``path``: the word
    and tag count files (``words`` and ``tags`` entries, most frequent
    first) and train/test h5 files of ``clients`` clients, each 1-4 posts
    of tokens (some out of the vocabulary), a title and ``|``-joined
    tags."""
    import h5py

    rng = np.random.default_rng(seed)
    path = Path(path)
    (path / "stackoverflow.word_count").write_text(
        "".join(f"w{i} {words * 2 - i}\n" for i in range(words)))
    (path / "stackoverflow.tag_count").write_text(json.dumps({f"t{i}": tags - i for i in range(tags)}))

    def sentence(n):
        return " ".join(f"w{int(i)}" if i < words else f"oov{int(i)}"
                        for i in rng.integers(0, words + 20, n))

    for fname in ("stackoverflow_train.h5", "stackoverflow_test.h5"):
        with h5py.File(path / fname, "w") as f:
            for c in range(clients):
                g = f.create_group(f"examples/u{c:03d}")
                posts = int(rng.integers(1, 5))
                g.create_dataset("tokens", data=[sentence(int(rng.integers(2, 30))).encode()
                                                 for _ in range(posts)])
                g.create_dataset("title", data=[sentence(3).encode() for _ in range(posts)])
                g.create_dataset("tags", data=[
                    "|".join(f"t{int(t)}" for t in rng.integers(0, tags + 5, 3)).encode()
                    for _ in range(posts)])


def assert_same_dataset(got, want) -> None:
    """Two FederatedDatasets (either package) hold the same bytes."""
    assert (got.name, got.num_classes, got.num_clients) == (want.name, want.num_classes,
                                                             want.num_clients)
    for part in ("client_x", "client_y", "client_test_x", "client_test_y"):
        g, w = getattr(got, part), getattr(want, part)
        assert (g is None) == (w is None), part
        for a, b in zip(g or [], w or [], strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), part
    for a, b in ((got.test_x, want.test_x), (got.test_y, want.test_y)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# -- the registries' names ------------------------------------------------------

# (name, dataset, input shape, classes, options): every model name both
# registries build, with a dataset and an input it takes
REGISTRY_CASES = [
    ("lr", "synthetic", (60,), 10, {}),
    ("cnn", "femnist", (28, 28, 1), 62, {}),
    ("cnn_dropout", "femnist", (28, 28, 1), 62, {}),
    ("rnn", "shakespeare", (80,), 90, {}),
    ("rnn", "stackoverflow_nwp", (20,), 10004, {}),
    ("transformer", "shakespeare_synth_lm", (64,), 90, {}),
    ("resnet56", "cifar10", (32, 32, 3), 10, {}),
    ("resnet110", "cifar10", (32, 32, 3), 10, {}),
] + [(n, "cifar100", (32, 32, 3), 100, {}) for n in (
    "resnet18_gn", "resnet34_gn", "resnet50_gn", "resnet101_gn", "resnet152_gn", "mobilenet",
    "mobilenet_v3")
] + [(n, "imagenet", (224, 224, 3), 1000, {}) for n in (
    "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn")
] + [(f"efficientnet_{v}", "imagenet", (224, 224, 3), 1000, {"variant": v}) for v in (
    "b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7")
] + [
    ("segnet", "seg_synth", (128, 128, 3), 21, {}),
    ("darts", "cifar10", (32, 32, 3), 10, {}),
    ("mnistgan", "mnist", (28, 28, 1), 10, {}),
]


def registry_name(case) -> str:
    return case[0].split("_b")[0] if case[0].startswith("efficientnet") else case[0]


def case_id(case) -> str:
    return f"{case[0]}-{case[1]}"


MODEL_FACTS = Path(__file__).with_name("reference_model_facts.json")


def _read_model_facts(cases) -> dict:
    """{case_id: {"mode", "count"}} of the reference for each of ``cases``,
    from one ``jax.eval_shape`` of each model's init (the resolution's own
    call, captured)."""
    import jax

    from fedml_tpu.algorithms import fedavg as jfedavg
    from fedml_tpu.models import create_model as jax_create_model

    out = {}
    real = jax.eval_shape
    for case in cases:
        name, dataset, shape, classes, kw = case
        model = jax_create_model(registry_name(case), dataset, shape, classes, **kw)
        seen = []

        def capture(*a, **k):
            seen.append(real(*a, **k))
            return seen[-1]

        jax.eval_shape = capture
        try:
            mode = jfedavg.resolve_client_parallelism("auto", model)
        finally:
            jax.eval_shape = real
        # the last call is the resolution's own (init may trace inner ones)
        count = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(seen[-1]))
        out[case_id(case)] = {"mode": mode, "count": count}
    return out


def _case_args(case) -> list:
    return list(map(str, case))


def reference_model_facts(cases) -> dict:
    """{case_id: {"mode": the reference's ``resolve_client_parallelism
    ("auto", model)``, "count": its variables' element count}} for the
    given REGISTRY_CASES entries.

    Tracing the reference's full-width models costs ~30 s, so its readings
    of REGISTRY_CASES are kept in ``reference_model_facts.json`` beside
    this file, with the digest of the reference's sources they were read
    from (:func:`write_reference_model_facts` writes it). A case the file
    does not hold for these sources, or every case with FEDML_REF_CACHE=0,
    is read from the reference (through :func:`reference_record`)."""
    saved = {}
    if os.environ.get("FEDML_REF_CACHE", "1") != "0" and MODEL_FACTS.exists():
        doc = json.loads(MODEL_FACTS.read_text())
        if doc["src"] == reference_source_digest():
            saved = doc["facts"]
    out, missing = {}, []
    for case in cases:
        fact = saved.get(case_id(case))
        if fact is not None and fact["args"] == _case_args(case):
            out[case_id(case)] = {"mode": fact["mode"], "count": fact["count"]}
        else:
            missing.append(case)
    if missing:
        rec = reference_record("model_facts", {"cases": [_case_args(c) for c in missing]},
                               lambda: {"facts": _read_model_facts(missing)})
        out.update(rec.facts)
    return out


def write_reference_model_facts() -> None:
    """Read REGISTRY_CASES from the reference and write
    ``reference_model_facts.json``: ``JAX_PLATFORMS=cpu python -c "import
    sys; sys.path[:0] = ['.', 'tests']; import torch_parity as t;
    t.write_reference_model_facts()"`` from the repo root."""
    facts = _read_model_facts(REGISTRY_CASES)
    doc = {"src": reference_source_digest(),
           "facts": {case_id(c): {"args": _case_args(c), **facts[case_id(c)]}
                     for c in REGISTRY_CASES}}
    lines = [f" {json.dumps(k)}: {json.dumps(v)}" for k, v in doc["facts"].items()]
    MODEL_FACTS.write_text(f'{{"src": {json.dumps(doc["src"])}, "facts": {{\n'
                           + ",\n".join(lines) + "\n}}\n")


def port_model(case, device="meta"):
    """The port's ModelDef of a REGISTRY_CASES entry, its module built on
    ``device`` (the meta device: shapes only, nothing allocated)."""
    from fedml_tpu_torch.models import create_model

    name, dataset, shape, classes, kw = case
    with torch.device(device):
        return create_model(registry_name(case), dataset, shape, classes, **kw)
