"""Sharded record-major client-state tier (port of
``fedml_tpu/population/state_tier.py``): SCAFFOLD's and Ditto's per-client
state at million-client populations.

The mmap spill tier (algorithms/state_store.py ``MmapClientState``) keeps
one ``[N, *leaf_shape]`` memmap per leaf, so a cohort's gather is one
scattered read per leaf per client. This tier keeps a client's whole state
as one record instead:

    records_{s:05d}.bin  np.memmap uint8 [rows_in_shard, stride]: a
                         client's record is every leaf's bytes at fixed
                         offsets (one contiguous read and write per client
                         a round)
    init_mask.npy        np.lib.format bool [N], the lazy-init bitmap
    meta.json            {layout, n, shard_bits, stride, leaves}

A shard holds ``1 << shard_bits`` clients (``PopulationConfig
.state_shard_bits``; 16 gives 1M clients 16 files), so a file's size is
bounded and a gather touches only the shards its cohort lands in. Files
are created sparse, and rows initialise lazily through the bitmap: a
gather of an untouched row returns the algorithm's initial state without
any write. Every shard and the bitmap are read under ``MADV_RANDOM``.

A tree is the port's ``{name: array}`` mapping; its order is the record's
leaf order, as ``MmapClientState`` numbers its leaf files. Gather and
scatter are exact byte copies, so a sharded run equals the mmap and device
runs bit for bit (tests/test_torch_population.py), and the API is
``MmapClientState``'s, so ``CohortPrefetcher`` reads the next cohort's
records on its thread unchanged. A store directory reopens with the same
schema only; the port's records need not match the reference's."""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import weakref
from typing import Dict, Optional, Sequence

import numpy as np

from fedml_tpu_torch.data.mmap_store import advise_random

Tree = Dict[str, np.ndarray]


class ShardedClientState:
    """[N] fixed-stride per-client records over sharded np.memmap files.

    ``init_tree`` is ONE client's initial state (no leading N axis); its
    names, shapes and dtypes define the record layout. ``path`` None or ""
    makes a temporary directory that the store removes when it is
    collected; a directory the caller names is theirs and is never removed
    (an existing store there is reopened, its schema checked)."""

    def __init__(self, init_tree: Tree, n_clients: int, path: Optional[str] = None,
                 shard_bits: int = 16):
        self.n = int(n_clients)
        self.shard_bits = int(shard_bits)
        if not (4 <= self.shard_bits <= 24):
            raise ValueError(f"state_shard_bits must be in [4, 24], got {shard_bits}")
        self._names = list(init_tree)
        self._init_leaves = [np.asarray(init_tree[k]) for k in self._names]
        sizes = [a.nbytes for a in self._init_leaves]
        self._offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.stride = int(self._offsets[-1])
        if self.stride <= 0:
            raise ValueError("client state record is empty")
        # one packed initial record: what an untouched row gathers as
        self._init_record = np.concatenate(
            [a.reshape(-1).view(np.uint8) for a in self._init_leaves]
        )
        path = path or None
        self.path = path or tempfile.mkdtemp(prefix="fedml_tpu_torch_popstate_")
        self._cleanup = (
            weakref.finalize(self, shutil.rmtree, self.path, ignore_errors=True)
            if path is None else None
        )
        os.makedirs(self.path, exist_ok=True)
        meta = {
            "layout": "record-v1",
            "n": self.n,
            "shard_bits": self.shard_bits,
            "stride": self.stride,
            "leaves": [{"shape": list(a.shape), "dtype": str(a.dtype)}
                       for a in self._init_leaves],
        }
        meta_path = os.path.join(self.path, "meta.json")
        fresh = not os.path.exists(meta_path)
        if not fresh:
            with open(meta_path) as f:
                existing = json.load(f)
            if existing != meta:
                raise ValueError(
                    f"existing sharded state store at {self.path} has layout {existing}, "
                    f"expected {meta}"
                )
        shard_rows = 1 << self.shard_bits
        self._shards = []
        for s in range(-(-self.n // shard_rows)):
            rows = min(shard_rows, self.n - s * shard_rows)
            fp = os.path.join(self.path, f"records_{s:05d}.bin")
            # mode w+ creates the file sparse at its full logical size
            shard = np.memmap(fp, dtype=np.uint8,
                              mode="r+" if (not fresh and os.path.exists(fp)) else "w+",
                              shape=(rows, self.stride))
            advise_random(shard)
            self._shards.append(shard)
        mask_path = os.path.join(self.path, "init_mask.npy")
        if fresh:
            self._init_mask = np.lib.format.open_memmap(
                mask_path, mode="w+", dtype=np.bool_, shape=(self.n,)
            )
            with open(meta_path, "w") as f:
                json.dump(meta, f)
        else:
            self._init_mask = np.load(mask_path, mmap_mode="r+")
        advise_random(self._init_mask)

    @property
    def names(self):
        return list(self._names)

    @property
    def state_bytes_total(self) -> int:
        """Logical size of the whole store (what the card would hold); the
        disk holds only the rows ever written."""
        return self.n * self.stride

    def _split_records(self, buf: np.ndarray, inited: np.ndarray) -> Tree:
        """[C, stride] uint8 records -> ``{name: [C, ...]}``; rows whose
        ``inited`` is False become the initial state."""
        C = buf.shape[0]
        out = {}
        fill = not inited.all()
        for name, off, base in zip(self._names, self._offsets[:-1], self._init_leaves):
            raw = np.ascontiguousarray(buf[:, off:off + base.nbytes])
            arr = raw.view(base.dtype).reshape((C,) + base.shape)
            if fill:
                arr[~inited] = base
            out[name] = arr
        return out

    def _pack_records(self, rows: Tree) -> np.ndarray:
        C = len(np.asarray(rows[self._names[0]]))
        buf = np.empty((C, self.stride), np.uint8)
        for name, off, base in zip(self._names, self._offsets[:-1], self._init_leaves):
            r = np.ascontiguousarray(np.asarray(rows[name], dtype=base.dtype))
            buf[:, off:off + base.nbytes] = r.reshape(C, -1).view(np.uint8)
        return buf

    def _shard_rows(self, idx: np.ndarray):
        """A cohort's ids by shard: (shard, its local rows, the cohort's
        positions in it) for each shard the cohort lands in."""
        shard_of = idx >> self.shard_bits
        row_of = idx & ((1 << self.shard_bits) - 1)
        for s in np.unique(shard_of):
            m = shard_of == s
            yield self._shards[int(s)], row_of[m], m

    # -- MmapClientState's API --

    def gather(self, idx: Sequence[int]) -> Tree:
        """The cohort's rows as host arrays [C, ...] (copies); untouched
        rows come back as the initial state."""
        idx = np.asarray(idx, np.int64)
        inited = np.asarray(self._init_mask[idx])
        buf = np.empty((len(idx), self.stride), np.uint8)
        for shard, rows, m in self._shard_rows(idx):
            buf[m] = shard[rows]
        return self._split_records(buf, inited)

    def scatter(self, idx: Sequence[int], rows: Tree) -> None:
        """Write the cohort's updated records back (host arrays, the
        store's names)."""
        idx = np.asarray(idx, np.int64)
        buf = self._pack_records(rows)
        for shard, local, m in self._shard_rows(idx):
            shard[local] = buf[m]
        self._init_mask[idx] = True

    def flush(self) -> None:
        for shard in self._shards:
            shard.flush()
        self._init_mask.flush()

    def initialized_ids(self) -> np.ndarray:
        """The ids of the rows ever scattered: with their :meth:`gather`,
        the store's whole content (what a checkpoint embeds)."""
        return np.flatnonzero(np.asarray(self._init_mask))

    def initialized_count(self) -> int:
        return int(np.count_nonzero(self._init_mask))

    def reset_to(self, idx: Sequence[int], rows: Tree) -> None:
        """The store becomes exactly the initial state everywhere except
        ``idx``, which holds ``rows`` (the restore side of a checkpoint)."""
        inited = self.initialized_ids()
        if len(inited):
            for shard, local, _ in self._shard_rows(inited):
                shard[local] = self._init_record
            self._init_mask[inited] = False
        if len(np.asarray(idx)):
            self.scatter(idx, rows)
