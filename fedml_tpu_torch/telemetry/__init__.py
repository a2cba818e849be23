"""Host-side telemetry of the port (counterpart of ``fedml_tpu/telemetry/``):
the comm meter, the span tracer with its listeners, the wire trace context
that the transport needs, the thread-scoped telemetry, the Prometheus-text
metrics registry and the client health registry. Stdlib only."""

from fedml_tpu_torch.telemetry.comm import CommMeter, get_comm_meter  # noqa: F401
from fedml_tpu_torch.telemetry.health import ClientHealthRegistry  # noqa: F401
from fedml_tpu_torch.telemetry.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    TenantedRegistryView,
    get_global_registry,
    get_registry,
)
from fedml_tpu_torch.telemetry.scope import (  # noqa: F401
    TelemetryScope,
    activate_scope,
    current_scope,
    wrap_in_current_scope,
)
from fedml_tpu_torch.telemetry.spans import (  # noqa: F401
    SpanEvent,
    Tracer,
    get_global_tracer,
    get_tracer,
)
