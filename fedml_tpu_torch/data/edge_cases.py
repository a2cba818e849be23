"""Backdoor-poisoned federated datasets and the attack-success metric (a
copy of ``fedml_tpu/data/edge_cases.py``, which is numpy only; the metric
runs through the port's eval function).

The trigger is the BadNets pixel patch: a bright corner block and an
attacker-chosen target label. Attacker clients hold a mix of clean and
poisoned samples; attack success is the fraction of triggered non-target
test samples the global model classifies as the target."""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from fedml_tpu_torch.data.base import FederatedDataset


@dataclasses.dataclass(frozen=True)
class PoisonSpec:
    target_label: int = 0
    poison_frac: float = 0.5  # fraction of each attacker shard poisoned
    trigger_size: int = 3  # corner patch side length
    trigger_value: float = 2.5  # written into every channel of the patch


def apply_trigger(x: np.ndarray, spec: PoisonSpec) -> np.ndarray:
    """Stamp the trigger patch onto a batch [N, H, W, C] (a flat [N, D]
    batch gets it on its first trigger_size**2 features)."""
    x = np.array(x, copy=True)
    t = spec.trigger_size
    if x.ndim >= 3:
        x[:, :t, :t, ...] = spec.trigger_value
    else:
        x[:, : t * t] = spec.trigger_value
    return x


def poison_clients(
    data: FederatedDataset,
    attacker_ids: Sequence[int],
    spec: PoisonSpec = PoisonSpec(),
    seed: int = 0,
) -> FederatedDataset:
    """A copy of ``data`` in which ``poison_frac`` of each attacker
    client's samples carry the trigger and the target label."""
    rng = np.random.default_rng(seed)
    client_x = [np.array(cx, copy=True) for cx in data.client_x]
    client_y = [np.array(cy, copy=True) for cy in data.client_y]
    for a in attacker_ids:
        n = len(client_y[a])
        k = max(1, int(round(spec.poison_frac * n)))
        idx = rng.choice(n, size=k, replace=False)
        client_x[a][idx] = apply_trigger(client_x[a][idx], spec)
        client_y[a][idx] = spec.target_label
    return dataclasses.replace(
        data, client_x=client_x, client_y=client_y, name=f"{data.name}_poisoned"
    )


def backdoor_test_set(
    data: FederatedDataset, spec: PoisonSpec = PoisonSpec()
) -> Tuple[np.ndarray, np.ndarray]:
    """Every non-target test sample with the trigger stamped, labelled as
    the attacker's target."""
    keep = np.asarray(data.test_y) != spec.target_label
    x = apply_trigger(np.asarray(data.test_x)[keep], spec)
    y = np.full(int(keep.sum()), spec.target_label, dtype=np.int32)
    return x, y


def attack_success_rate(model, variables, data, spec: PoisonSpec, eval_fn=None) -> float:
    """Fraction of triggered non-target test samples classified as the
    target: the backdoor accuracy."""
    from fedml_tpu_torch.train.evaluate import evaluate

    x, y = backdoor_test_set(data, spec)
    _, asr = evaluate(model, variables, x, y, eval_fn=eval_fn)
    return asr
