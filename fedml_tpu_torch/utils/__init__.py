"""Checkpoints, metric rows and the profiler trace (port of
``fedml_tpu/utils/``)."""

from fedml_tpu_torch.utils.checkpoint import (  # noqa: F401
    load_checkpoint,
    restore_like,
    save_checkpoint,
)
from fedml_tpu_torch.utils.metrics import MetricsLogger  # noqa: F401
