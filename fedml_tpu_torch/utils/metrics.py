"""Metric rows (port of ``fedml_tpu/utils/metrics.py``): wandb-compatible
names without the wandb dependency.

:class:`MetricsLogger` appends each row to ``metrics.jsonl`` and keeps a
``summary`` (the last value of every key), rewritten to ``summary.json`` on
every row — the counterpart of wandb-summary.json that the reference's CI
reads. Rows go to wandb too when it is importable and a run is active."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


def wandb_init(project: str = "fedml_tpu", name: Optional[str] = None, config: Optional[dict] = None):
    """Start a wandb run if wandb is importable; the run, or None."""
    try:
        import wandb
    except ImportError:
        return None
    return wandb.init(project=project, name=name, config=config or {})


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, use_wandb: bool = False):
        self.log_dir = log_dir
        self.summary: Dict[str, float] = {}
        self.history = []
        self._fh = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb if wandb.run is not None else None
            except ImportError:
                self._wandb = None

    def log(self, row: Dict) -> None:
        row = dict(row)
        row.setdefault("_ts", time.time())
        self.history.append(row)
        self.summary.update({k: v for k, v in row.items() if not k.startswith("_")})
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
            with open(os.path.join(self.log_dir, "summary.json"), "w") as f:
                json.dump(self.summary, f)
        if self._wandb:
            self._wandb.log({k: v for k, v in row.items() if not k.startswith("_")})

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
