"""Bounded per-client bookkeeping (port of ``fedml_tpu/population/``, its
``active.py``): the scheduler's bounded loss map and the health registry's
LRU active set with its compact spill records. The population index, the
alias sampler and the sharded state tier are still to port (ROADMAP.md §1
item 9)."""

from fedml_tpu_torch.population.active import ActiveSet, BoundedLossMap, SpilledRecord

__all__ = ["ActiveSet", "BoundedLossMap", "SpilledRecord"]
