"""PopulationIndex (a copy of ``fedml_tpu/population/index.py``): the
packed per-client partition metadata, apart from the materialized shards.

What the round machinery needs to know about a client without touching
its data fits in a few packed numpy arrays: the sample count (weighted
selection, the bucket math), the inclusion weight derived from it, and the
shape class of its singleton bucket. The index is built once (O(N),
vectorized) from a dataset's counts, or opened from disk, where it is kept
as plain ``.npy`` files mapped read-only; every per-round reader (the alias
sampler, shape classes, a cohort's counts) reads O(cohort) slices. Above
``PopulationConfig.index_mmap_bytes``, with an ``index_dir`` set, the packed
arrays live on disk instead of the heap. The on-disk form is the
reference's, so either package opens an index the other wrote."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from fedml_tpu_torch.data.base import partition_shape_classes
from fedml_tpu_torch.population.sampler import AliasSampler

_COUNTS_FILE = "counts.npy"
_META_FILE = "index_meta.json"


class PopulationIndex:
    """Packed [N] per-client metadata + the derived per-round lookups
    (weights, alias table, shape classes), each computed once and
    cached. Counts may be an in-RAM array or a read-only memmap — every
    consumer goes through O(cohort) fancy-index slices either way."""

    def __init__(self, counts: np.ndarray):
        # asANYarray: a memmap-backed counts vector must stay a memmap
        # (asarray would silently copy it onto the heap — the exact cost
        # the mmap backing exists to avoid)
        self.counts = np.asanyarray(counts)
        if self.counts.dtype != np.int64:
            self.counts = self.counts.astype(np.int64)
        if self.counts.ndim != 1:
            raise ValueError("PopulationIndex counts must be 1-D")
        self._total: Optional[int] = None
        self._weights: Optional[np.ndarray] = None
        self._alias: Optional[AliasSampler] = None
        self._classes: Dict[Tuple[int, int], Dict[tuple, int]] = {}

    # -- construction --
    @classmethod
    def from_dataset(cls, data) -> "PopulationIndex":
        """Build from any FederatedDataset-shaped object. Uses the
        vectorized ``train_sample_counts`` property (O(N) numpy for the
        mmap store's offset diff; one O(N) Python pass for list-backed
        datasets — build-time, once)."""
        return cls(np.asarray(data.train_sample_counts, np.int64))

    @classmethod
    def from_counts(
        cls,
        counts,
        path: Optional[str] = None,
        mmap_threshold_bytes: int = 64 << 20,
    ) -> "PopulationIndex":
        """Build from raw counts; when ``path`` is given and the packed
        array exceeds ``mmap_threshold_bytes``, persist it and reopen
        mmap-backed so the index costs file-cache pages, not heap.

        ``path`` is a PARENT directory that may be shared across
        sessions (PopulationConfig.index_dir is a fixed config string):
        the index lands in a content-digest-keyed subdirectory, written
        once via tmp-dir + atomic rename. Different datasets can never
        clobber each other's mapped files, identical datasets share one
        copy, and a concurrent writer losing the rename race simply
        loads the winner's (bit-identical) index."""
        c = np.asarray(counts, np.int64)
        if path and c.nbytes >= mmap_threshold_bytes:
            import hashlib

            digest = hashlib.sha256(c.tobytes()).hexdigest()[:16]
            sub = os.path.join(path, f"pop_{len(c)}_{digest}")
            if not os.path.exists(os.path.join(sub, _META_FILE)):
                tmp = f"{sub}.tmp.{os.getpid()}"
                cls(c).save(tmp)
                try:
                    os.rename(tmp, sub)  # atomic publish
                except OSError:
                    # a concurrent writer won the rename — use theirs
                    import shutil

                    shutil.rmtree(tmp, ignore_errors=True)
                    if not os.path.exists(os.path.join(sub, _META_FILE)):
                        raise
            return cls.load(sub)
        return cls(c)

    def save(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, _COUNTS_FILE), np.asarray(self.counts))
        with open(os.path.join(path, _META_FILE), "w") as f:
            json.dump(
                {"n": int(self.num_clients), "version": 1}, f
            )
        return path

    @classmethod
    def load(cls, path: str) -> "PopulationIndex":
        with open(os.path.join(path, _META_FILE)) as f:
            meta = json.load(f)
        counts = np.load(
            os.path.join(path, _COUNTS_FILE), mmap_mode="r"
        )
        if len(counts) != meta["n"]:
            raise ValueError(
                f"population index at {path}: counts length "
                f"{len(counts)} != meta n {meta['n']}"
            )
        return cls(counts)

    # -- O(1)/O(cohort) lookups --
    @property
    def num_clients(self) -> int:
        return len(self.counts)

    def total_samples(self) -> int:
        if self._total is None:
            self._total = int(np.sum(self.counts, dtype=np.int64))
        return self._total

    def weights(self) -> np.ndarray:
        """Per-client inclusion probabilities (counts / total), cached.
        One O(N) numpy pass on first use."""
        if self._weights is None:
            total = self.total_samples()
            if total <= 0:
                raise ValueError("population has zero total samples")
            self._weights = self.counts.astype(np.float64) / float(total)
        return self._weights

    def alias_table(self) -> AliasSampler:
        """The run's alias sampler, built once (O(N)) and cached —
        every subsequent round draws in O(cohort)."""
        if self._alias is None:
            self._alias = AliasSampler(self.weights())
        return self._alias

    def cohort_counts(self, ids) -> np.ndarray:
        """Sample counts of a cohort — the O(cohort) read the bucket
        math and weighted aggregation need per round."""
        return np.asarray(self.counts[np.asarray(ids, np.int64)], np.int64)

    def shape_classes(self, batch_size: int, pad_bucket: int):
        """``{(steps, bs): first client index}`` — THE warmup
        pre-enumeration contract, delegated to
        data.base.partition_shape_classes (one definition: its
        vectorized path IS this index's packed-counts form) and cached
        per (batch_size, pad_bucket)."""
        key = (int(batch_size), int(pad_bucket))
        cached = self._classes.get(key)
        if cached is None:
            cached = self._classes[key] = partition_shape_classes(
                self.counts, batch_size, pad_bucket
            )
        return cached
