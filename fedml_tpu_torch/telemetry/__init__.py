"""Host-side telemetry of the port (counterpart of ``fedml_tpu/telemetry/``):
the comm meter, the span tracer and the wire trace context that the
transport needs. Stdlib only."""

from fedml_tpu_torch.telemetry.comm import CommMeter, get_comm_meter  # noqa: F401
from fedml_tpu_torch.telemetry.spans import Tracer, get_tracer  # noqa: F401
