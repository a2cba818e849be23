"""Disk-backed per-client algorithm state (port of
``fedml_tpu/algorithms/state_store.py``): the spill tier of the stateful
algorithms, SCAFFOLD's control variates and Ditto's personal models.

Past ``FedConfig.state_budget_bytes`` the N × |state| stack leaves the card
for the disk:

    disk (np.memmap, every client's rows)
        -> host RAM (the sampled cohort's rows)
        -> the card (the cohort rows enter the cohort-form round)

A "tree" here is the port's flat mapping ``{name: array}``; its order is the
leaves' order on disk. Layout of the directory: ``leaf_{i}.npy``, one
``np.lib.format`` array [N, *leaf_shape] per leaf, plus ``init_mask.npy``
and ``meta.json``. Rows are initialised lazily: ``open_memmap`` creates
sparse zero files at once, a per-client bitmap records which rows were ever
scattered, and a gather of an untouched row returns the algorithm's initial
state (zeros for SCAFFOLD's c_i, w_0 for Ditto's v_k) without any write.
A round reads and writes only its cohort's rows.

Gather and scatter are exact row copies (float32 in, float32 out), so a
spilled run equals the run that keeps the stack on the card bit for bit
(tests/test_torch_state_store.py). At population scale the same rows live
in the sharded record-major tier instead (population/state_tier.py, mode
"sharded"), which keeps this store's API."""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
import weakref
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.data.mmap_store import advise_random

Tree = Dict[str, np.ndarray]


class MmapClientState:
    """[N, ...] per-client state spilled to one memmap per leaf.

    ``init_tree`` is ONE client's initial state (no leading N axis); its
    names, shapes and dtypes are the store's schema. ``path`` None or ""
    makes a temporary directory that the store removes when it is
    collected; a directory the caller names is theirs and is never removed
    (an existing store there is reopened, its schema checked)."""

    def __init__(self, init_tree: Tree, n_clients: int, path: Optional[str] = None):
        self.n = int(n_clients)
        self._names = list(init_tree)
        self._init_leaves = [np.asarray(init_tree[k]) for k in self._names]
        path = path or None
        self.path = path or tempfile.mkdtemp(prefix="fedml_tpu_torch_state_")
        self._cleanup = (
            weakref.finalize(self, shutil.rmtree, self.path, ignore_errors=True)
            if path is None else None
        )
        os.makedirs(self.path, exist_ok=True)
        meta_path = os.path.join(self.path, "meta.json")
        schema = [{"shape": list(a.shape), "dtype": str(a.dtype)} for a in self._init_leaves]
        leaf = lambda i: os.path.join(self.path, f"leaf_{i}.npy")  # noqa: E731
        mask_path = os.path.join(self.path, "init_mask.npy")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta["n"] != self.n or meta["leaves"] != schema:
                raise ValueError(
                    f"existing state store at {self.path} has schema {meta}, expected "
                    f"n={self.n}, leaves={schema}"
                )
            self._mms = [np.load(leaf(i), mmap_mode="r+") for i in range(len(schema))]
            self._init_mask = np.load(mask_path, mmap_mode="r+")
        else:
            self._mms = [
                np.lib.format.open_memmap(leaf(i), mode="w+", dtype=a.dtype,
                                          shape=(self.n,) + a.shape)
                for i, a in enumerate(self._init_leaves)
            ]
            self._init_mask = np.lib.format.open_memmap(
                mask_path, mode="w+", dtype=np.bool_, shape=(self.n,)
            )
            with open(meta_path, "w") as f:
                json.dump({"n": self.n, "leaves": schema}, f)
        for mm in self._mms:
            advise_random(mm)
        advise_random(self._init_mask)

    @property
    def names(self):
        return list(self._names)

    @property
    def state_bytes_total(self) -> int:
        """Logical size of the whole store (what the card would hold)."""
        return self.n * sum(a.nbytes for a in self._init_leaves)

    def gather(self, idx: Sequence[int]) -> Tree:
        """The cohort's rows as host arrays [C, ...] (copies); untouched
        rows come back as the initial state."""
        idx = np.asarray(idx, np.int64)
        inited = np.asarray(self._init_mask[idx])
        out = {}
        for name, mm, base in zip(self._names, self._mms, self._init_leaves):
            rows = np.array(mm[idx])
            if not inited.all():
                rows[~inited] = base
            out[name] = rows
        return out

    def scatter(self, idx: Sequence[int], rows: Tree) -> None:
        """Write the cohort's updated rows back (host arrays, the store's
        names)."""
        idx = np.asarray(idx, np.int64)
        for name, mm in zip(self._names, self._mms):
            mm[idx] = np.asarray(rows[name], dtype=mm.dtype)
        self._init_mask[idx] = True

    def flush(self) -> None:
        for mm in self._mms:
            mm.flush()
        self._init_mask.flush()

    def initialized_ids(self) -> np.ndarray:
        """The ids of the rows ever scattered: with their :meth:`gather`,
        the store's whole content (every other row is the initial state),
        which is what a checkpoint embeds."""
        return np.flatnonzero(np.asarray(self._init_mask))

    def initialized_count(self) -> int:
        return int(np.count_nonzero(self._init_mask))

    def reset_to(self, idx: Sequence[int], rows: Tree) -> None:
        """The store becomes exactly the initial state everywhere except
        ``idx``, which holds ``rows`` (the restore side of a checkpoint)."""
        inited = self.initialized_ids()
        if len(inited):
            for mm, base in zip(self._mms, self._init_leaves):
                mm[inited] = base
            self._init_mask[inited] = False
        if len(np.asarray(idx)):
            self.scatter(idx, rows)


class CohortPrefetcher:
    """Reads the next round's cohort rows on a thread while the card runs
    the current round.

    The rows the caller scatters this round go in ``exclude``: the thread
    never reads them, and :meth:`take` reads them after the scatter has
    landed, so a prefetched cohort holds no torn or stale row. A
    :meth:`take` whose (round, ids) is not the pending prefetch gathers
    synchronously. :meth:`cancel` joins the thread and drops its rows."""

    def __init__(self, store: MmapClientState):
        self.store = store
        self._pending = None  # (round, ids bytes, safe mask, result)
        self._thread: Optional[threading.Thread] = None

    def launch(self, round_idx: int, ids, exclude=()) -> None:
        self.cancel()
        ids = np.asarray(ids, np.int64)
        excl = {int(i) for i in exclude}
        safe_mask = np.fromiter((int(i) not in excl for i in ids), bool, count=len(ids))
        safe_ids = ids[safe_mask]
        result = {}

        def work():
            try:
                result["rows"] = self.store.gather(safe_ids)
            except Exception as e:  # noqa: BLE001 — the synchronous retry at take() raises it
                result["err"] = e

        t = threading.Thread(target=work, daemon=True, name="cohort-prefetch")
        t.start()
        self._pending = (int(round_idx), ids.tobytes(), safe_mask, result)
        self._thread = t

    def take(self, round_idx: int, ids) -> Tree:
        ids = np.asarray(ids, np.int64)
        if (self._pending is None or self._pending[0] != int(round_idx)
                or self._pending[1] != ids.tobytes()):
            self.cancel()
            return self.store.gather(ids)
        _, _, safe_mask, result = self._pending
        self._thread.join()
        self._pending, self._thread = None, None
        if "rows" not in result:
            # the background read failed: read again here, where a lasting
            # failure raises in the caller's round
            return self.store.gather(ids)
        pre = result["rows"]
        if safe_mask.all():
            return pre
        missing = self.store.gather(ids[~safe_mask])
        out = {}
        for name, p in pre.items():
            merged = np.empty((len(ids),) + p.shape[1:], p.dtype)
            merged[safe_mask], merged[~safe_mask] = p, missing[name]
            out[name] = merged
        return out

    def cancel(self) -> None:
        if self._thread is not None:
            self._thread.join()
        self._pending, self._thread = None, None


# the reference's default PopulationConfig.ocohort_threshold: the clients
# at and above which "auto" would pick the sharded tier
_OCOHORT_THRESHOLD = 65536


def resolve_state_store(config_fed, state_bytes: int, n_clients: int = 0, population=None) -> str:
    """"device" | "mmap" | "sharded" from ``FedConfig.state_store``, the
    state's size and the population. "auto" keeps the stack on the card
    while it fits ``state_budget_bytes``; past it the state spills to the
    mmap tier, or at or above the population threshold to the sharded
    record-major tier."""
    mode = config_fed.state_store
    if mode == "auto":
        if state_bytes <= config_fed.state_budget_bytes:
            return "device"
        threshold = population.ocohort_threshold if population is not None else _OCOHORT_THRESHOLD
        return "sharded" if n_clients and n_clients >= threshold else "mmap"
    if mode not in ("device", "mmap", "sharded"):
        raise ValueError(
            f"FedConfig.state_store must be 'auto', 'device', 'mmap' or 'sharded'; got {mode!r}"
        )
    return mode


def make_spill_store(mode: str, init_tree: Tree, n_clients: int, path=None, population=None):
    """The spill tier a resolved non-device mode names (shared by SCAFFOLD
    and Ditto): "mmap" one memmap per leaf, "sharded" the record-major
    tier (population/state_tier.py), ``1 << population.state_shard_bits``
    clients a shard file."""
    if mode == "sharded":
        from fedml_tpu_torch.population.state_tier import ShardedClientState

        bits = population.state_shard_bits if population is not None else 16
        return ShardedClientState(init_tree, n_clients, path, shard_bits=bits)
    if mode == "mmap":
        return MmapClientState(init_tree, n_clients, path)
    raise ValueError(f"not a spill-store mode: {mode!r}")


class ClientState:
    """The per-client state of a stateful algorithm (SCAFFOLD's c_i, Ditto's
    v_k) in the mode :func:`resolve_state_store` picks.

    ``init`` is one client's initial state, ``{name: tensor}`` on the run's
    device. Mode "device" keeps one [N, ...] float32 stack per leaf on the
    device; a round gathers its cohort's rows with ``index_select`` and
    writes them back in place with ``index_copy_`` (never a second copy of
    the stack). A spill mode keeps the rows in :class:`MmapClientState` or
    the sharded record-major tier, initialised lazily to ``init``; the next cohort's rows are read on a
    thread (:class:`CohortPrefetcher`) while the device runs this round,
    and ``spill_ms`` records each round's gather (disk → device) and
    scatter (device → disk) milliseconds on the host clock."""

    def __init__(self, init, n_clients: int, mode: str, state_dir: str = "", population=None):
        self.mode, self.n = mode, int(n_clients)
        self.init = {k: v.float() for k, v in init.items()}
        self.names = list(init)
        self.device = next(iter(init.values())).device
        self.spill_ms = []
        self.stack = self.store = self.prefetcher = None
        if mode == "device":
            self.stack = {k: v.unsqueeze(0).repeat((self.n,) + (1,) * v.dim())
                          for k, v in self.init.items()}
            return
        self.store = make_spill_store(
            mode, {k: v.cpu().numpy() for k, v in self.init.items()}, self.n, state_dir or None,
            population=population,
        )
        self.prefetcher = CohortPrefetcher(self.store)

    @property
    def stack_bytes(self) -> int:
        """Bytes of the whole [N, ...] state (what the device mode holds)."""
        if self.stack is not None:
            return sum(s.numel() * s.element_size() for s in self.stack.values())
        return self.store.state_bytes_total

    def _index(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def gather(self, round_idx: int, ids):
        """The cohort's rows, ``{name: [C, ...]}`` on the device."""
        if self.stack is not None:
            idx = self._index(ids)
            return {k: s.index_select(0, idx) for k, s in self.stack.items()}
        t0 = time.perf_counter()
        rows = self.prefetcher.take(round_idx, ids)
        out = {k: torch.from_numpy(v).to(self.device) for k, v in rows.items()}
        self._gather_ms = (time.perf_counter() - t0) * 1e3
        return out

    def scatter(self, ids, rows, next_round=None, next_ids=None) -> None:
        """Write the cohort's updated rows back. A spilled store first
        starts reading ``next_ids`` (round ``next_round``) on its thread,
        leaving this cohort's rows to the next :meth:`gather`. (The copy
        off the device waits for the round's last kernels, so on a card
        ``scatter_ms`` holds that wait too.)"""
        if self.stack is not None:
            idx = self._index(ids)
            for k, s in self.stack.items():
                s.index_copy_(0, idx, rows[k].to(s.dtype))
            return
        if next_ids is not None:
            self.prefetcher.launch(next_round, next_ids, exclude={int(i) for i in ids})
        t0 = time.perf_counter()
        self.store.scatter(ids, {k: v.float().cpu().numpy() for k, v in rows.items()})
        self.spill_ms.append({"gather_ms": self._gather_ms,
                              "scatter_ms": (time.perf_counter() - t0) * 1e3})

    def row(self, i: int):
        """Client ``i``'s state, ``{name: tensor}`` on the device."""
        if self.stack is not None:
            return {k: s[i] for k, s in self.stack.items()}
        return {k: torch.from_numpy(v[0]).to(self.device)
                for k, v in self.store.gather([i]).items()}

    def close(self) -> None:
        """Join the prefetch thread, if one runs."""
        if self.prefetcher is not None:
            self.prefetcher.cancel()

    # checkpoints: the reference's two forms, in its tree layout

    def checkpoint_state(self, prefix: str, to_reference) -> dict:
        """``{prefix}_stack`` (the device mode) or the touched rows
        ``{prefix}_rows_idx`` and ``{prefix}_rows_<i>`` (a spilled store;
        self-contained, as untouched rows are the initial state), the
        leaves numbered in ``jax.tree_util`` order. ``to_reference(state,
        lead)`` maps port arrays to the reference's nested tree."""
        from fedml_tpu_torch.bridge import flax_leaves

        if self.stack is not None:
            return {f"{prefix}_stack": to_reference(self.stack, 1)}
        self.store.flush()  # a checkpoint is the spill tier's durability point
        idx = self.store.initialized_ids()
        out = {f"{prefix}_rows_idx": idx}
        for i, leaf in enumerate(flax_leaves(to_reference(self.store.gather(idx), 1))):
            out[f"{prefix}_rows_{i}"] = leaf
        return out

    def restore_state(self, tree: dict, prefix: str, to_reference, from_reference) -> None:
        """Either checkpoint form into either mode, from either package.
        ``from_reference(tree, lead)`` is the inverse of ``to_reference``."""
        from fedml_tpu_torch.bridge import flax_unflatten

        self.close()  # a pending prefetch holds rows from before the restore
        if f"{prefix}_stack" in tree:
            idx = np.arange(self.n)
            rows = from_reference(tree[f"{prefix}_stack"], 1)
        else:
            idx = np.asarray(tree[f"{prefix}_rows_idx"], np.int64).reshape(-1)
            template = to_reference({k: v.cpu() for k, v in self.init.items()}, 0)
            leaves = [np.asarray(tree[f"{prefix}_rows_{i}"]) for i in range(len(self.names))]
            rows = from_reference(flax_unflatten(template, leaves), 1)
        if self.stack is None:
            self.store.reset_to(idx, {k: v.numpy() for k, v in rows.items()})
            return
        t_idx = self._index(idx)
        for k, s in self.stack.items():
            s.copy_(self.init[k].expand_as(s))  # rows the checkpoint lacks: the initial state
            s.index_copy_(0, t_idx, rows[k].to(device=self.device, dtype=s.dtype))


class StatefulFedAvgAPI(FedAvgAPI):
    """The FedAvg skeleton of the algorithms with per-client state
    (SCAFFOLD, Ditto): a subclass sets ``state`` (a :class:`ClientState`)
    and runs its own ``train_round``; the spill tier's prefetch reads the
    next round's cohort, and the prefetch thread is joined when training
    ends."""

    def _build_round_fn(self, local_train_fn):
        if local_train_fn is not None:
            raise ValueError(f"{type(self).__name__} trains with its own local trains")
        return None  # train_round runs the algorithm's cohort body

    def _next_cohort(self, round_idx: int):
        """The next round's cohort, for the spill tier's prefetch (None for
        the device stack and after the last round: the device stack reads
        no cohort ahead, so an adaptive policy's next draw waits for this
        round's losses)."""
        if self.state.store is None or round_idx + 1 >= self.config.fed.comm_round:
            return None
        return self._round_plan(round_idx + 1)

    def train(self):
        try:
            return super().train()
        finally:
            self.state.close()
