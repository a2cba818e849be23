"""O(cohort) client sampling (a copy of ``fedml_tpu/population/sampler.py``):
the alias table and the rejection draws that let ``weighted``,
``power_of_choice`` and ``straggler_aware`` selection at population scale
never touch all N clients a round.

- **Build time, once a run:** a Walker/Vose alias table over the
  per-client inclusion probabilities — two packed arrays, O(N) to build,
  O(1) a draw.
- **Round time:** k distinct clients by draw-and-discard-duplicates.
  Discarding repeats from a with-replacement stream is sequential sampling
  without replacement, so the cohort distribution is the exact numpy
  draw's; only the random stream differs, which is why the scheduler
  engages these draws behind a population threshold
  (``PopulationConfig.ocohort_threshold``).

Every draw is a pure function of the generator handed in, and the same
generator gives the reference's draws byte for byte
(tests/test_torch_population.py)."""

from __future__ import annotations

from typing import Optional

import numpy as np


class AliasSampler:
    """Walker alias table over a fixed weight vector.

    ``sample(rng, m)`` draws m ids i.i.d. from p (with replacement) in
    O(m); :meth:`draw_distinct` builds a k-distinct cohort in O(k)
    expected when k << n. Zero-weight clients are never drawn by the
    table; :meth:`draw_distinct` tolerates k exceeding the non-zero
    support by filling uniformly from the zero-weight ids — the same
    degradation contract as policies._weighted_draw (a zero-sample shard
    under the Dirichlet partitioner must not crash a run mid-flight).
    """

    def __init__(self, weights: np.ndarray):
        w = np.asarray(weights, np.float64).ravel()
        if len(w) == 0 or np.any(w < 0) or not np.all(np.isfinite(w)):
            raise ValueError("alias weights must be finite and >= 0")
        total = w.sum()
        if total <= 0:
            raise ValueError("alias weights sum to zero")
        self.n = len(w)
        self.p = w / total
        self._nonzero = np.flatnonzero(w)
        # Vose construction: scaled probabilities split into under/over
        # stacks; each table cell holds (threshold, alias id). Python
        # loop is O(N) BUILD-time work (once per run) — the point is the
        # per-ROUND cost, which is O(cohort).
        scaled = self.p * self.n
        prob = np.ones(self.n, np.float64)
        alias = np.arange(self.n, dtype=np.int64)
        small = [int(i) for i in np.flatnonzero(scaled < 1.0)]
        large = [int(i) for i in np.flatnonzero(scaled >= 1.0)]
        scaled = scaled.copy()
        while small and large:
            s = small.pop()
            g = large.pop()
            prob[s] = scaled[s]
            alias[s] = g
            scaled[g] = (scaled[g] + scaled[s]) - 1.0
            (small if scaled[g] < 1.0 else large).append(g)
        for i in small + large:  # numerical stragglers land on 1.0
            prob[i] = 1.0
        self._prob = prob
        self._alias = alias

    def sample(self, rng: np.random.Generator, m: int) -> np.ndarray:
        """m i.i.d. draws from p (with replacement), O(m)."""
        i = rng.integers(0, self.n, size=m)
        u = rng.random(m)
        return np.where(u < self._prob[i], i, self._alias[i]).astype(np.int64)

    def draw_distinct(self, rng: np.random.Generator, k: int) -> np.ndarray:
        """k DISTINCT ids, distributionally identical to sequential
        weighted sampling without replacement (draw, discard repeats).
        Order of first appearance is preserved — the draw order, like
        the legacy rng.choice's."""
        k = int(k)
        nnz = len(self._nonzero)
        if k >= nnz:
            # request exceeds the weighted support: every weighted client
            # is taken (permuted) and the remainder fills uniformly from
            # the zero-weight ids — policies._weighted_draw's contract
            take = rng.permutation(self._nonzero)
            if k <= nnz:
                return take[:k].astype(np.int64)
            zeros = np.setdiff1d(
                np.arange(self.n, dtype=np.int64), self._nonzero
            )
            fill = rng.choice(zeros, size=k - nnz, replace=False)
            return np.concatenate([take, fill]).astype(np.int64)
        seen: dict = {}
        # batch the rejection rounds: expected acceptance stays high
        # while k << effective support; the batch size grows if the tail
        # keeps colliding (heavy-head weight vectors)
        batch = max(2 * k, 64)
        while len(seen) < k:
            for c in self.sample(rng, batch):
                ci = int(c)
                if ci not in seen:
                    seen[ci] = None
                    if len(seen) == k:
                        break
            batch = min(2 * batch, 1 << 16)
        return np.fromiter(seen.keys(), np.int64, count=k)


def draw_uniform_distinct(
    rng: np.random.Generator,
    n: int,
    k: int,
    exclude: Optional[np.ndarray] = None,
) -> np.ndarray:
    """k distinct ids uniform over [0, n) minus ``exclude``, by
    rejection — O(k + |exclude|) while k + |exclude| << n, vs the O(N)
    ``np.setdiff1d(arange(n), ...)`` + permutation of the legacy path.
    Falls back to the exact dense draw when the request is a large
    fraction of the population (rejection would thrash)."""
    excl = set(int(i) for i in exclude) if exclude is not None else set()
    avail = n - len(excl)
    k = min(int(k), avail)
    if k <= 0:
        return np.empty(0, np.int64)
    if (k + len(excl)) * 4 >= n:
        eligible = np.setdiff1d(
            np.arange(n, dtype=np.int64),
            np.fromiter(excl, np.int64, count=len(excl)),
        )
        return rng.choice(eligible, size=k, replace=False).astype(np.int64)
    seen: dict = {}
    batch = max(2 * k, 64)
    while len(seen) < k:
        for c in rng.integers(0, n, size=batch):
            ci = int(c)
            if ci not in seen and ci not in excl:
                seen[ci] = None
                if len(seen) == k:
                    break
        batch = min(2 * batch, 1 << 16)
    return np.fromiter(seen.keys(), np.int64, count=k)
