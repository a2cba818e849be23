"""Client selection and fault injection (port of ``fedml_tpu/scheduler/``)."""

from fedml_tpu_torch.scheduler.faults import (  # noqa: F401
    DEVICE_PROFILES,
    ClientFaultSpec,
    DeviceProfile,
    FaultDecision,
    FaultInjector,
    FaultPlan,
    FaultTrace,
)
from fedml_tpu_torch.scheduler.policies import (  # noqa: F401
    POLICY_NAMES,
    ClientScheduler,
    OverprovisionPolicy,
    PowerOfChoicePolicy,
    StragglerAwarePolicy,
    make_policy,
    overprovisioned_k,
    select_clients,
)
