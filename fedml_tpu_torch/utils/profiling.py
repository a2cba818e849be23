"""The ``--profile_dir`` trace (port of ``fedml_tpu/utils/profiling.py``
``trace``): a ``torch.profiler`` capture of the card and the host, written
into the directory as a Chrome trace (viewable in Perfetto)."""

from __future__ import annotations

import contextlib
import os
from typing import Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block into ``log_dir/trace.json``; a no-op when
    ``log_dir`` is falsy, so call sites pass the CLI flag straight
    through."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
