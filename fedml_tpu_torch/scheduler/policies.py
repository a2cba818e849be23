"""Client selection (port of ``fedml_tpu/scheduler/policies.py``, the
``uniform`` policy only).

``uniform`` is the reference-parity draw: ``np.random.seed(round_idx)`` then
``choice`` without replacement — it deliberately ignores the run seed, so
the cohorts equal the reference's round for round. The weighted,
power-of-choice and straggler-aware policies and overprovisioning are
still to port (ROADMAP.md); fault plans are in scheduler/faults.py."""

from __future__ import annotations

import numpy as np

POLICIES = ("uniform",)


def _uniform(round_idx: int, num_clients: int, k: int) -> np.ndarray:
    if k > num_clients:
        raise ValueError(
            f"client_num_per_round={k} exceeds client_num_in_total={num_clients}"
        )
    if num_clients == k:
        return np.arange(num_clients)
    np.random.seed(round_idx)
    return np.random.choice(range(num_clients), k, replace=False)


def _check_policy(policy: str) -> None:
    if policy not in POLICIES:
        raise NotImplementedError(
            f"selection policy {policy!r} is not ported yet (ROADMAP.md); "
            f"the port has {POLICIES}"
        )


def select_clients(
    round_idx: int, num_clients: int, k: int, policy: str = "uniform"
) -> np.ndarray:
    """One round's cohort through the named policy."""
    _check_policy(policy)
    return _uniform(int(round_idx), int(num_clients), int(k))


class ClientScheduler:
    """Per-run cohort selection: the configured policy over a fixed
    population and cohort size. The uniform draw is a pure function of the
    round, so no per-round memo is needed."""

    def __init__(self, num_clients: int, k: int, policy: str = "uniform"):
        _check_policy(policy)
        self.num_clients = int(num_clients)
        self.k = int(k)
        self.policy_name = policy

    @classmethod
    def from_config(cls, config, num_clients: int) -> "ClientScheduler":
        if config.fed.overprovision_factor != 1.0:
            raise NotImplementedError(
                "overprovision_factor is not ported yet (ROADMAP.md)"
            )
        if num_clients >= config.population.ocohort_threshold:
            # the reference draws such populations through its packed
            # population index, another stream than np.random.choice
            raise NotImplementedError(
                f"populations of {config.population.ocohort_threshold}+ clients "
                "(the population tier) are not ported yet (ROADMAP.md)"
            )
        return cls(num_clients, config.fed.client_num_per_round, config.fed.selection)

    def select(self, round_idx: int) -> np.ndarray:
        return np.asarray(
            select_clients(round_idx, self.num_clients, self.k, self.policy_name),
            np.int64,
        )
