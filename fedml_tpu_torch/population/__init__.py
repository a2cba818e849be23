"""The population tier (port of ``fedml_tpu/population/``): what used to
scale with the total client count N each round, as O(cohort) structures
that touch N only when they are built.

- :class:`PopulationIndex` — packed per-client metadata (sample counts,
  weights, shape classes), apart from the shards; mapped from disk above a
  size threshold.
- :class:`AliasSampler` — an O(N) build and O(cohort) weighted draws a
  round (``weighted``, the ``power_of_choice`` candidates), with
  :func:`draw_uniform_distinct`, the rejection draw ``straggler_aware``
  excludes the flagged clients with.
- :class:`BoundedLossMap` / :class:`ActiveSet` — the scheduler's bounded
  loss map and the health registry's LRU active set with its compact spill.
- ``state_tier.ShardedClientState`` — the record-major per-client store of
  SCAFFOLD's and Ditto's state (imported from its module).

Populations at or above ``PopulationConfig.ocohort_threshold`` take the
O(cohort) paths; below it every draw is the exact numpy draw."""

from fedml_tpu_torch.population.active import ActiveSet, BoundedLossMap, SpilledRecord
from fedml_tpu_torch.population.index import PopulationIndex
from fedml_tpu_torch.population.sampler import AliasSampler, draw_uniform_distinct

__all__ = [
    "ActiveSet",
    "AliasSampler",
    "BoundedLossMap",
    "PopulationIndex",
    "SpilledRecord",
    "draw_uniform_distinct",
]
