"""Client selection (port of ``fedml_tpu/scheduler/policies.py``: the
``uniform``, ``weighted``, ``power_of_choice`` and ``straggler_aware``
policies, the overprovisioning wrapper, and :class:`ClientScheduler` with
its selection memo and checkpoint state).

- ``uniform`` is the reference-parity draw: ``np.random.seed(round_idx)``
  then ``choice`` without replacement. It deliberately ignores the run
  seed, so the cohorts equal the reference's round for round.
- ``weighted`` draws inclusion proportional to local sample counts from a
  per-round generator over (seed, round, salt): the reference's stream, so
  its cohorts are the reference's too.
- ``power_of_choice`` (Cho et al. 2020) draws ``ceil(candidate_factor·k)``
  candidates size-weighted and keeps the k with the highest last-known
  local loss (unknown losses rank first), ties broken by a seeded
  permutation: the reference's rule on the reference's stream.
- ``straggler_aware`` draws uniformly over the clients the client health
  registry (telemetry/health.py) does not flag as stragglers, and tops the
  cohort up from the flagged set, slowest last, when fewer than k fast
  clients remain.
- overprovisioning selects ``ceil(k·factor)`` clients of the wrapped
  policy, so a deadline round still closes with about k uploads.

Every policy is a pure function of (seed, round, policy inputs).

At or above ``PopulationConfig.ocohort_threshold`` clients the non-uniform
policies draw in O(cohort) through the packed
:class:`~fedml_tpu_torch.population.PopulationIndex`: the alias table for
``weighted`` and the ``power_of_choice`` candidates, rejection sampling for
``straggler_aware``'s draw that excludes the flagged clients. The switch is
keyed on the population size only, so the simulator and every transport
draw the same cohorts; below it the exact numpy draws run. ``uniform``
stays the round-seeded draw at every size. Fault plans are in
scheduler/faults.py."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from fedml_tpu_torch.population import BoundedLossMap, PopulationIndex, draw_uniform_distinct

#: the policy names a config or the CLI may name
POLICY_NAMES = ("uniform", "weighted", "power_of_choice", "straggler_aware")


@dataclasses.dataclass
class SelectionContext:
    """What a policy may consult beyond (round, k)."""

    seed: int = 0
    num_clients: int = 0
    # per-client local dataset sizes, indexed by client id (weighted)
    sample_counts: Optional[np.ndarray] = None
    # last reported local train loss per client id
    losses: Optional[BoundedLossMap] = None
    # ClientHealthRegistry-shaped object (straggler_aware): straggler_ids()
    # and mean_train_s(cid)
    health: Optional[object] = None
    # the PopulationIndex of the O(cohort) draws; built from sample_counts
    # at or above ocohort_threshold when absent
    index: Optional[PopulationIndex] = None
    ocohort_threshold: int = 65536


def _population_index(ctx: SelectionContext) -> Optional[PopulationIndex]:
    """The index the O(cohort) draws read: the context's own, or one built
    from the sample counts once the population reaches the threshold. None
    below it (the exact draws) or without counts."""
    if ctx.index is not None:
        return ctx.index
    if (ctx.sample_counts is not None and ctx.num_clients >= ctx.ocohort_threshold
            and len(ctx.sample_counts) == ctx.num_clients):
        ctx.index = PopulationIndex(np.asarray(ctx.sample_counts, np.int64))
        return ctx.index
    return None


def _weighted_cohort(ctx: SelectionContext, rng, n: int, size: int) -> np.ndarray:
    """The size-weighted distinct draw of ``weighted`` and the
    ``power_of_choice`` candidates: the alias table's O(cohort) draw at
    population scale, the exact numpy draw below it (the same distribution
    on another stream)."""
    pop = _population_index(ctx)
    if pop is not None and pop.num_clients == n and pop.total_samples() > 0:
        return pop.alias_table().draw_distinct(rng, size)
    return _weighted_draw(rng, n, size, _size_probs(ctx))


def _rng(ctx: SelectionContext, round_idx: int, salt: int = 0) -> np.random.Generator:
    """A policy's per-round generator: a SeedSequence over (seed, round,
    salt), independent of call order."""
    return np.random.default_rng([int(ctx.seed) & 0x7FFFFFFF, int(round_idx), int(salt)])


def _size_probs(ctx: SelectionContext) -> Optional[np.ndarray]:
    if ctx.sample_counts is None:
        return None
    c = np.asarray(ctx.sample_counts, np.float64)
    if len(c) != ctx.num_clients or c.sum() <= 0:
        return None
    return c / c.sum()


def _weighted_draw(rng, n: int, size: int, p: Optional[np.ndarray]) -> np.ndarray:
    """``rng.choice(n, size, replace=False, p=p)`` that tolerates
    zero-weight entries (a zero-sample shard of the Dirichlet partition):
    when the request exceeds the non-zero support, every weighted client is
    taken and the rest fill uniformly from the zero-weight ones."""
    if p is None:
        return rng.choice(n, size=size, replace=False)
    nz = np.flatnonzero(p)
    if size <= len(nz):
        return rng.choice(n, size=size, replace=False, p=p)
    zeros = np.setdiff1d(np.arange(n), nz)
    fill = rng.choice(zeros, size=size - len(nz), replace=False)
    return np.concatenate([rng.permutation(nz), fill])


class SelectionPolicy:
    """One cohort-selection rule: ``select(round_idx, k, ctx)`` is a pure
    function of its arguments and returns distinct client ids."""

    name = "base"

    def select(self, round_idx: int, k: int, ctx: SelectionContext) -> np.ndarray:
        raise NotImplementedError


class UniformPolicy(SelectionPolicy):
    name = "uniform"

    def select(self, round_idx, k, ctx):
        n = ctx.num_clients
        if k > n:
            raise ValueError(f"client_num_per_round={k} exceeds client_num_in_total={n}")
        if n == k:
            return np.arange(n)
        np.random.seed(round_idx)
        return np.random.choice(range(n), k, replace=False)


class WeightedPolicy(SelectionPolicy):
    name = "weighted"

    def select(self, round_idx, k, ctx):
        n = ctx.num_clients
        return _weighted_cohort(ctx, _rng(ctx, round_idx, salt=1), n, min(k, n))


class PowerOfChoicePolicy(SelectionPolicy):
    """Loss-biased d-choose-k: ``d = ceil(candidate_factor·k)`` candidates
    drawn size-weighted, the k with the highest last-known loss kept;
    unknown losses rank as +inf (cold clients are explored first), ties
    break on a seeded per-round permutation."""

    name = "power_of_choice"

    def __init__(self, candidate_factor: float = 2.0):
        if candidate_factor < 1.0:
            raise ValueError("candidate_factor must be >= 1.0")
        self.candidate_factor = float(candidate_factor)

    def select(self, round_idx, k, ctx):
        n = ctx.num_clients
        k = min(k, n)
        d = min(n, max(k, int(math.ceil(self.candidate_factor * k))))
        rng = _rng(ctx, round_idx, salt=2)
        candidates = _weighted_cohort(ctx, rng, n, d)
        losses = ctx.losses or {}
        tiebreak = rng.permutation(d)
        order = sorted(
            range(d), key=lambda i: (-losses.get(int(candidates[i]), math.inf), tiebreak[i])
        )
        return np.asarray([int(candidates[i]) for i in order[:k]], np.int64)


class StragglerAwarePolicy(SelectionPolicy):
    """Uniform over the clients the health registry does not flag as
    stragglers (``ClientHealthRegistry.straggler_ids``: the slowest decile
    AND more than 1.2× the median mean). When fewer than k fast clients
    exist, the cohort tops up from the flagged set, slowest last, then by
    id. With no registry attached this is a seeded uniform draw. At
    population scale the draw rejection-samples around the flagged set
    (bounded by the registry's active set) instead of building the O(N)
    eligible set."""

    name = "straggler_aware"

    def select(self, round_idx, k, ctx):
        n = ctx.num_clients
        k = min(k, n)
        rng = _rng(ctx, round_idx, salt=3)
        flagged: List[int] = []
        if ctx.health is not None:
            flagged = [c for c in ctx.health.straggler_ids() if c < n]
        if n >= ctx.ocohort_threshold:
            take = min(k, n - len(flagged))
            sel = draw_uniform_distinct(rng, n, take, exclude=np.asarray(flagged, np.int64))
        else:
            eligible = np.setdiff1d(np.arange(n), np.asarray(flagged, np.int64))
            take = min(k, len(eligible))
            sel = rng.choice(eligible, size=take, replace=False) if take else np.empty(0, np.int64)
        if take < k:
            by_speed = sorted(flagged, key=lambda c: (ctx.health.mean_train_s(c) or 0.0, c))
            sel = np.concatenate([sel, np.asarray(by_speed[: k - take], np.int64)])
        return np.sort(sel.astype(np.int64))


def overprovisioned_k(k: int, factor: float, num_clients: int) -> int:
    """ceil(k·factor) clamped to the population: the overprovisioned
    cohort size, and the worker count a transport federation spawns."""
    return max(1, min(int(num_clients), int(math.ceil(k * float(factor)))))


class OverprovisionPolicy(SelectionPolicy):
    """Any policy, selecting ``overprovisioned_k(k, factor, N)`` clients."""

    name = "overprovision"

    def __init__(self, inner: SelectionPolicy, factor: float = 1.0):
        if factor < 1.0:
            raise ValueError("overprovision factor must be >= 1.0")
        self.inner = inner
        self.factor = float(factor)

    def select(self, round_idx, k, ctx):
        return self.inner.select(round_idx, overprovisioned_k(k, self.factor, ctx.num_clients), ctx)


_POLICIES: Dict[str, Callable[..., SelectionPolicy]] = {
    "uniform": UniformPolicy,
    "weighted": WeightedPolicy,
    "power_of_choice": PowerOfChoicePolicy,
    "straggler_aware": StragglerAwarePolicy,
}


def _check_policy(policy: str) -> None:
    if policy not in POLICY_NAMES:
        raise ValueError(f"unknown selection policy {policy!r}; the port has {POLICY_NAMES}")


def make_policy(name: str, overprovision_factor: float = 1.0, **kw) -> SelectionPolicy:
    """The named policy, wrapped in overprovisioning when the factor is not 1."""
    _check_policy(name)
    inner = _POLICIES[name](**kw)
    if overprovision_factor and overprovision_factor != 1.0:
        return OverprovisionPolicy(inner, overprovision_factor)
    return inner


def select_clients(
    round_idx: int, num_clients: int, k: int, policy: str = "uniform"
) -> np.ndarray:
    """One round's cohort through the named policy (run seed 0, no sample
    counts: ``weighted`` then draws uniformly from its own stream)."""
    ctx = SelectionContext(num_clients=int(num_clients))
    return make_policy(policy).select(int(round_idx), int(k), ctx)


class ClientScheduler:
    """The per-run selection: the configured policy (overprovisioned by
    ``overprovision_factor``) over a fixed population and cohort size, a
    per-round memo and a bounded loss map.

    ``select(r)`` is memoized, so the round loop and a checkpoint writer see
    one decision a round, and each fresh decision goes to ``on_select``
    (the ``scheduler/policy`` and ``scheduler/selected`` rows of
    summary.json). The memo of the last ``selection_memo_rounds`` rounds
    and the loss map are the checkpoint's ``sched`` slot
    (:meth:`state_dict`), in the reference's layout. ``health`` is the client health registry ``straggler_aware``
    reads; ``memoize=False`` is for callers keyed by an unbounded counter
    (FedBuff's dispatches)."""

    def __init__(
        self,
        num_clients: int,
        k: int,
        policy: str = "uniform",
        seed: int = 0,
        overprovision_factor: float = 1.0,
        sample_counts: Optional[Sequence[int]] = None,
        health: Optional[object] = None,
        on_select: Optional[Callable[[int, np.ndarray], None]] = None,
        memoize: bool = True,
        index: Optional[PopulationIndex] = None,
        ocohort_threshold: int = 65536,
        loss_map_capacity: int = 65536,
        selection_memo_rounds: int = 64,
    ):
        self.num_clients = int(num_clients)
        self.k = int(k)
        self.policy_name = policy
        self.overprovision_factor = float(overprovision_factor)
        self._policy = make_policy(policy, overprovision_factor)
        self._ctx = SelectionContext(
            seed=int(seed),
            num_clients=self.num_clients,
            sample_counts=None if sample_counts is None else np.asarray(sample_counts, np.int64),
            losses=BoundedLossMap(loss_map_capacity),
            health=health,
            index=index,
            ocohort_threshold=int(ocohort_threshold),
        )
        self._memo_rounds = int(selection_memo_rounds)
        self._on_select = on_select
        self._memoize = bool(memoize)
        self._selections: Dict[int, np.ndarray] = {}

    @classmethod
    def from_config(cls, config, num_clients: int, data=None, log_fn=None, **kw) -> "ClientScheduler":
        """Build from a RunConfig. ``data`` (a FederatedDataset) gives the
        weighted policy its sample counts when its client count is the
        federation's, and at or above ``ocohort_threshold`` clients the
        packed population index is built from them here, once (with
        ``index_dir`` and ``index_mmap_bytes``), so the simulator, the
        transports and FedBuff, which all build their schedulers here, draw
        the same cohorts. ``log_fn`` receives each round's selection row;
        ``kw`` goes to the constructor (``health``, ``memoize``)."""
        pop = config.population
        policy = config.fed.selection
        counts = index = None
        if data is not None and data.num_clients == num_clients:
            # np.diff of the offsets for the mmap store; one len() pass for
            # list datasets
            counts = np.asarray(data.train_sample_counts, np.int64)
            if num_clients >= pop.ocohort_threshold:
                index = PopulationIndex.from_counts(
                    counts, path=pop.index_dir or None,
                    mmap_threshold_bytes=pop.index_mmap_bytes,
                )
        on_select = None
        if log_fn is not None:
            on_select = lambda r, sel: log_fn({  # noqa: E731
                "round": int(r),
                "scheduler/policy": policy,
                "scheduler/selected": [int(c) for c in sel],
            })
        return cls(
            num_clients, config.fed.client_num_per_round, policy=policy, seed=config.seed,
            overprovision_factor=config.fed.overprovision_factor,
            sample_counts=counts, on_select=on_select, index=index,
            ocohort_threshold=pop.ocohort_threshold,
            loss_map_capacity=pop.loss_map_capacity,
            selection_memo_rounds=pop.selection_memo_rounds, **kw,
        )

    def cohort_size(self) -> int:
        """Clients selected a round after overprovisioning: the worker
        count a transport federation spawns."""
        return overprovisioned_k(self.k, self.overprovision_factor, self.num_clients)

    def select(self, round_idx: int, k: Optional[int] = None) -> np.ndarray:
        """This round's cohort of :meth:`cohort_size` clients (memoized; the
        live memo keeps the most recent ``max(selection_memo_rounds, 64)``
        rounds — evicted rounds re-derive, every policy being a pure
        function of (seed, round)). ``k`` overrides the cohort size
        verbatim, past the overprovisioning wrapper."""
        r = int(round_idx)
        if self._memoize and r in self._selections:
            return self._selections[r]
        if k is None:
            sel = self._policy.select(r, self.k, self._ctx)
        else:
            sel = getattr(self._policy, "inner", self._policy).select(r, int(k), self._ctx)
        sel = np.asarray(sel, np.int64)
        if self._memoize:
            self._selections[r] = sel
            cap = max(self._memo_rounds, 64)
            while len(self._selections) > cap:
                del self._selections[next(iter(self._selections))]
        if self._on_select is not None:
            self._on_select(r, sel)
        return sel

    @property
    def wants_client_losses(self) -> bool:
        """Whether the policy biases on per-client losses (power_of_choice,
        overprovisioned or not)."""
        return isinstance(getattr(self._policy, "inner", self._policy), PowerOfChoicePolicy)

    def report_loss(self, client_id: int, loss: float) -> None:
        """Record a client's last observed local train loss."""
        if loss is None or not np.isfinite(loss):
            return
        self._ctx.losses[int(client_id)] = float(loss)

    def selections(self) -> Dict[int, List[int]]:
        """Memoized decisions so far, {round: [ids]}."""
        return {r: [int(c) for c in sel] for r, sel in sorted(self._selections.items())}

    def state_dict(self) -> dict:
        """The checkpoint's ``sched`` slot: the last ``selection_memo_rounds``
        rounds' selections and the loss map, as numpy arrays."""
        rounds = sorted(self._selections)[-self._memo_rounds:]
        loss_ids = sorted(self._ctx.losses)
        return {
            "rounds": np.asarray(rounds, np.int64),
            "selections": [np.asarray(self._selections[r], np.int64) for r in rounds],
            "loss_ids": np.asarray(loss_ids, np.int64),
            "loss_vals": np.asarray([self._ctx.losses.get(i) for i in loss_ids], np.float64),
        }

    def load_state_dict(self, state: dict) -> None:
        rounds = [int(r) for r in np.asarray(state["rounds"]).ravel()]
        self._selections = {
            r: np.asarray(sel, np.int64) for r, sel in zip(rounds, state["selections"])
        }
        losses = BoundedLossMap(self._ctx.losses.capacity)
        for i, v in zip(np.asarray(state["loss_ids"]).ravel(), np.asarray(state["loss_vals"]).ravel()):
            losses[int(i)] = float(v)
        self._ctx.losses = losses
