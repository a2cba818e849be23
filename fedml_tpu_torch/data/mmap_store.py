"""Memory-mapped on-disk federated store (a copy of
``fedml_tpu/data/mmap_store.py``): clients far beyond host RAM.

The host tier below data/device_store.py:

    disk (np.memmap, all clients) -> host RAM (the sampled cohort only)
        -> the card (the stacked round batch)

Layout of the directory, the reference's byte for byte (either package
opens a store the other wrote):

    flat_x.npy / flat_y.npy   np.lib.format arrays, clients concatenated
                              along axis 0 (memory-mapped at load)
    offsets.npy               int64 [num_clients + 1] row offsets
    test_x.npy / test_y.npy   central test set (small, loaded eagerly)
    meta.json                 {name, num_classes}

A round reads only its cohort's rows (the slice copies of
``stack_clients``); building a store is a streaming write that never holds
more than one chunk of clients in RAM. :class:`MmapFederatedDataset` keeps
the ``client_x``/``client_y`` indexing contract, so ``stack_clients`` and
``bucket_steps`` give the same batches as the in-RAM dataset, and it
reports its client count, sample counts and bytes in O(1) from the
offsets."""

from __future__ import annotations

import json
import os
import struct
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from fedml_tpu_torch.data.base import FederatedDataset


def advise_random(arr) -> None:
    """``madvise(MADV_RANDOM)`` on a numpy memmap. Cohort rows are random,
    and the kernel's default readahead would treat each row fault as the
    start of a sequential scan and read a whole window of (sparse, zero)
    pages. A hint only: the bytes read are the same. No-op where the
    array or the platform has no ``madvise``. The one definition: the
    state tiers (algorithms/state_store.py, population/state_tier.py)
    import it from here."""
    mm = getattr(arr, "_mmap", None)
    if mm is not None and hasattr(mm, "madvise"):
        import mmap as _mmap

        if hasattr(_mmap, "MADV_RANDOM"):
            mm.madvise(_mmap.MADV_RANDOM)


class _ClientView:
    """List-like lazy view of per-client shards over (flat, offsets).

    ``view[i]`` is a zero-copy mmap slice; nothing is read from disk until
    the slice is actually consumed. Supports the exact subset of the list
    protocol the data paths use (len, index, iterate)."""

    def __init__(self, flat: np.ndarray, offsets: np.ndarray):
        self._flat = flat
        self._offsets = offsets

    def __len__(self) -> int:
        return len(self._offsets) - 1

    def __getitem__(self, i: int) -> np.ndarray:
        return self._flat[self._offsets[i]:self._offsets[i + 1]]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class MmapFederatedDataset(FederatedDataset):
    """FederatedDataset whose client shards live on disk (np.memmap)."""

    def __init__(self, name, flat_x, flat_y, offsets, test_x, test_y, num_classes):
        super().__init__(
            name=name,
            client_x=_ClientView(flat_x, offsets),
            client_y=_ClientView(flat_y, offsets),
            test_x=test_x,
            test_y=test_y,
            num_classes=num_classes,
        )
        self._offsets = np.asarray(offsets, np.int64)
        self._flat_x = flat_x
        self._flat_y = flat_y

    @property
    def num_clients(self) -> int:
        return len(self._offsets) - 1

    @property
    def train_sample_counts(self) -> np.ndarray:
        return np.diff(self._offsets)

    def total_train_samples(self) -> int:
        return int(self._offsets[-1])

    # population_index() is inherited: FederatedDataset's form reads
    # train_sample_counts, which HERE is already the vectorized
    # np.diff(offsets) — no per-client lazy view is ever touched.

    @property
    def total_train_bytes(self) -> int:
        """O(1) size for the device-memory guard — iterating 100k lazy views
        to sum nbytes would defeat the point of the store."""
        row = self._flat_x.dtype.itemsize * int(
            np.prod(self._flat_x.shape[1:], dtype=np.int64)
        ) + self._flat_y.dtype.itemsize * int(
            np.prod(self._flat_y.shape[1:], dtype=np.int64)
        )
        return int(self._offsets[-1]) * row


def write_mmap_dataset(
    path: str,
    client_sizes: Sequence[int],
    gen_chunk: Callable[[int, int], Tuple[np.ndarray, np.ndarray]],
    test: Tuple[np.ndarray, np.ndarray],
    num_classes: int,
    name: str = "mmap",
    chunk_rows: int = 1 << 20,
    log_fn: Optional[Callable[[object], None]] = None,
) -> str:
    """Streaming writer. ``gen_chunk(start_row, n_rows) -> (x, y)``
    produces the next n_rows of the flattened (client-concatenated) data;
    it is called with bounded n_rows, so generation never materializes the
    whole dataset. ``log_fn`` (optional) receives chunk progress strings
    while writing and one ``mmap_build/*`` summary dict at the end — the
    row a million-client build surfaces in summary.json instead of going
    dark for minutes."""
    os.makedirs(path, exist_ok=True)
    t0 = time.perf_counter()
    sizes = np.asarray(client_sizes, np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    total = int(offsets[-1])
    x0, y0 = gen_chunk(0, 1)
    fx = np.lib.format.open_memmap(
        os.path.join(path, "flat_x.npy"), mode="w+",
        dtype=x0.dtype, shape=(total,) + x0.shape[1:],
    )
    fy = np.lib.format.open_memmap(
        os.path.join(path, "flat_y.npy"), mode="w+",
        dtype=y0.dtype, shape=(total,) + y0.shape[1:],
    )
    row = 0
    while row < total:
        n = min(chunk_rows, total - row)
        x, y = gen_chunk(row, n)
        fx[row:row + n] = x
        fy[row:row + n] = y
        row += n
        if log_fn is not None:
            log_fn(f"mmap build: {row}/{total} rows written")
    fx.flush()
    fy.flush()
    np.save(os.path.join(path, "offsets.npy"), offsets)
    np.save(os.path.join(path, "test_x.npy"), test[0])
    np.save(os.path.join(path, "test_y.npy"), test[1])
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"name": name, "num_classes": num_classes}, f)
    if log_fn is not None:
        row_bytes = int(fx.dtype.itemsize * np.prod(fx.shape[1:], dtype=np.int64)) + int(
            fy.dtype.itemsize * np.prod(fy.shape[1:], dtype=np.int64)
        )
        log_fn({
            "mmap_build/rows": total,
            "mmap_build/clients": len(sizes),
            "mmap_build/bytes": total * row_bytes,
            "mmap_build/seconds": round(time.perf_counter() - t0, 3),
        })
    return path


# Reserved on-disk npy header size for the incremental builder: the header
# is written FIRST with a placeholder shape and rewritten at finalize with
# the true row count — 128 bytes fits any practical descr/shape string and
# keeps the array data 64-byte aligned (np.lib.format's own alignment).
_NPY_HEADER_RESERVE = 128


def _write_npy_header(f, dtype: np.dtype, shape: Tuple[int, ...]) -> None:
    """(Re)write a numpy format-1.0 header of exactly
    ``_NPY_HEADER_RESERVE`` bytes at the start of ``f``."""
    magic = b"\x93NUMPY\x01\x00"
    hlen = _NPY_HEADER_RESERVE - len(magic) - 2
    header = "{'descr': %r, 'fortran_order': False, 'shape': %r, }" % (
        np.lib.format.dtype_to_descr(np.dtype(dtype)),
        tuple(int(s) for s in shape),
    )
    if len(header) + 1 > hlen:
        raise ValueError(
            f"npy header {header!r} exceeds the {_NPY_HEADER_RESERVE}-byte "
            "reserve — feature rank too exotic for the incremental builder"
        )
    header = header.ljust(hlen - 1) + "\n"
    f.seek(0)
    f.write(magic + struct.pack("<H", hlen) + header.encode("latin1"))


class MmapStoreBuilder:
    """Bounded-memory incremental builder for the on-disk store.

    :func:`write_mmap_dataset` needs the full ``(client_sizes,
    gen_chunk)`` contract up front — right for synthetic geometry, wrong
    for real-format loaders (LEAF/StackOverflow file walks) that discover
    clients one at a time and never know the total row count until the
    walk ends. This builder accepts ``add_client(x, y)`` in arrival order
    and holds at most ``flush_bytes`` of buffered rows in RAM: appends
    stream into the final ``flat_x.npy``/``flat_y.npy`` through a
    reserved fixed-size header that :meth:`finalize` rewrites with the
    true shape — one pass over the data, one disk image, a RAM ceiling
    that does not grow with the population. ``stats()`` returns the
    ``mmap_build/*`` summary row (rows/bytes/clients/flushes/peak
    buffer/seconds) so a long build is measurable, not dark."""

    def __init__(
        self,
        path: str,
        flush_bytes: int = 64 << 20,
        log_fn: Optional[Callable[[str], None]] = None,
    ):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.flush_bytes = int(flush_bytes)
        self.log_fn = log_fn
        self._bx: list = []
        self._by: list = []
        self._buffered = 0
        self._sizes: list = []
        self._fx = self._fy = None
        self._dtype_x = self._dtype_y = None
        self._feat = self._lab = None
        self._rows_written = 0
        self._flushes = 0
        self._peak_buffer = 0
        self._finalized = False
        self._t0 = time.perf_counter()

    def add_client(self, x: np.ndarray, y: np.ndarray) -> None:
        """Append one client's shard (row-aligned x/y). The rows are
        buffered and flushed to disk whenever the buffer crosses the
        ceiling — RAM held is O(flush_bytes), never O(dataset)."""
        if self._finalized:
            raise RuntimeError("builder already finalized")
        x = np.ascontiguousarray(x)
        y = np.ascontiguousarray(y)
        if len(x) != len(y):
            raise ValueError(f"client rows misaligned: {len(x)} x vs {len(y)} y")
        if self._fx is None:
            self._dtype_x, self._dtype_y = x.dtype, y.dtype
            self._feat, self._lab = x.shape[1:], y.shape[1:]
            self._fx = open(os.path.join(self.path, "flat_x.npy"), "w+b")
            self._fy = open(os.path.join(self.path, "flat_y.npy"), "w+b")
            # placeholder headers reserve the slot; finalize rewrites them
            _write_npy_header(self._fx, self._dtype_x, (0,) + self._feat)
            _write_npy_header(self._fy, self._dtype_y, (0,) + self._lab)
        elif (
            x.dtype != self._dtype_x
            or y.dtype != self._dtype_y
            or x.shape[1:] != self._feat
            or y.shape[1:] != self._lab
        ):
            raise ValueError(
                f"client shard shape/dtype drift: got x{x.shape} {x.dtype} / "
                f"y{y.shape} {y.dtype}, store holds x(*, {self._feat}) "
                f"{self._dtype_x} / y(*, {self._lab}) {self._dtype_y}"
            )
        self._sizes.append(len(x))
        self._bx.append(x)
        self._by.append(y)
        self._buffered += int(x.nbytes) + int(y.nbytes)
        self._peak_buffer = max(self._peak_buffer, self._buffered)
        if self._buffered >= self.flush_bytes:
            self._flush()

    def _flush(self) -> None:
        if not self._bx:
            return
        for a in self._bx:
            self._fx.write(a.data)
        for a in self._by:
            self._fy.write(a.data)
        self._rows_written = int(sum(self._sizes))
        self._flushes += 1
        self._bx, self._by = [], []
        self._buffered = 0
        if self.log_fn is not None:
            self.log_fn(
                f"mmap build: {self._rows_written} rows / "
                f"{len(self._sizes)} clients flushed ({self._flushes} flushes)"
            )

    def finalize(
        self,
        test: Tuple[np.ndarray, np.ndarray],
        num_classes: int,
        name: str = "mmap",
    ) -> str:
        """Flush the tail, rewrite the reserved headers with the true row
        count, and write offsets/test/meta — the store is then exactly
        what :func:`load_mmap_dataset` expects."""
        if self._fx is None:
            raise ValueError("finalize() before any add_client()")
        self._flush()
        total = int(sum(self._sizes))
        _write_npy_header(self._fx, self._dtype_x, (total,) + self._feat)
        _write_npy_header(self._fy, self._dtype_y, (total,) + self._lab)
        for f in (self._fx, self._fy):
            f.flush()
            f.close()
        self._fx = self._fy = None
        offsets = np.concatenate(
            [[0], np.cumsum(np.asarray(self._sizes, np.int64))]
        )
        np.save(os.path.join(self.path, "offsets.npy"), offsets)
        np.save(os.path.join(self.path, "test_x.npy"), test[0])
        np.save(os.path.join(self.path, "test_y.npy"), test[1])
        with open(os.path.join(self.path, "meta.json"), "w") as f:
            json.dump({"name": name, "num_classes": num_classes}, f)
        self._finalized = True
        if self.log_fn is not None:
            self.log_fn(self.stats())
        return self.path

    def stats(self) -> dict:
        """Flat ``mmap_build/*`` summary row (MetricsLogger-shaped)."""
        row_bytes = 0
        if self._dtype_x is not None:
            row_bytes = int(
                self._dtype_x.itemsize * np.prod(self._feat, dtype=np.int64)
            ) + int(self._dtype_y.itemsize * np.prod(self._lab, dtype=np.int64))
        total = int(sum(self._sizes))
        return {
            "mmap_build/rows": total,
            "mmap_build/clients": len(self._sizes),
            "mmap_build/bytes": total * row_bytes,
            "mmap_build/flushes": self._flushes,
            "mmap_build/peak_buffer_bytes": self._peak_buffer,
            "mmap_build/seconds": round(time.perf_counter() - self._t0, 3),
        }


def load_mmap_dataset(path: str) -> MmapFederatedDataset:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return MmapFederatedDataset(
        name=meta["name"],
        flat_x=np.load(os.path.join(path, "flat_x.npy"), mmap_mode="r"),
        flat_y=np.load(os.path.join(path, "flat_y.npy"), mmap_mode="r"),
        offsets=np.load(os.path.join(path, "offsets.npy")),
        test_x=np.load(os.path.join(path, "test_x.npy")),
        test_y=np.load(os.path.join(path, "test_y.npy")),
        num_classes=meta["num_classes"],
    )


def synth_stackoverflow_mmap(
    path: str,
    num_clients: int = 100_000,
    mean_samples: int = 64,
    vocab: int = 10_000,
    seq_len: int = 20,
    seed: int = 0,
) -> MmapFederatedDataset:
    """StackOverflow-geometry synthetic NWP data written straight to an
    mmap store (the StackOverflow benchmark federates 342,477 clients for
    next-word prediction; data/stackoverflow.py holds the real-format
    loader). Token ids are Zipf-distributed like natural text; y is the
    next-token shift of x. Idempotent: reuses the store if the directory already matches."""
    meta_path = os.path.join(path, "meta.json")
    name = f"so_synth_{num_clients}c"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            if json.load(f).get("name") == name:
                return load_mmap_dataset(path)
    rng = np.random.default_rng(seed)
    sizes = np.clip(
        rng.lognormal(np.log(mean_samples), 0.6, num_clients).astype(np.int64),
        8,
        512,
    )

    def gen_chunk(start, n):
        r = np.random.default_rng(seed * 7919 + start)
        # zipf via inverse-CDF over a truncated power law (zipf(1.3))
        u = r.random((n, seq_len))
        vals = u ** (-1 / 0.3)
        x = np.where(
            np.isfinite(vals), np.minimum(vals, vocab - 1), vocab - 1
        ).astype(np.int32)
        y = np.roll(x, -1, axis=1)
        y[:, -1] = 0
        return x, y

    tx, ty = gen_chunk(10**9, 512)
    write_mmap_dataset(
        path, sizes, gen_chunk, (tx, ty), num_classes=vocab, name=name,
    )
    return load_mmap_dataset(path)
