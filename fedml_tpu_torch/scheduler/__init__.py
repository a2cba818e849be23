"""Client selection (port of ``fedml_tpu/scheduler/``)."""

from fedml_tpu_torch.scheduler.policies import (  # noqa: F401
    ClientScheduler,
    select_clients,
)
