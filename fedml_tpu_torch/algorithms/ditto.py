"""Ditto — personalized federated learning (port of
``fedml_tpu/algorithms/ditto.py``, its single-device rounds; Li et al.,
MLSys 2021).

Every client keeps a personal model v_k beside the shared global model w.
The global model trains as FedAvg; the sampled clients also advance their
personal model by the local train on

    min_v  F_k(v) + λ/2 · ‖v − w_t‖²

with w_t the model the server broadcast at the round's start (the local
train's proximal term with ``prox_mu`` = λ, pulled toward an external
reference: ``make_local_train(..., external_prox=True)``). λ = 0 leaves the
personal models purely local; λ → ∞ pins them to w. The N personal models
are one [N, ...] stack per variable on the device, or the mmap spill tier
(algorithms/state_store.py ``ClientState``), initialised to w_0; only the
sampled rows change. ``personalized_test_on_clients`` evaluates v_k on
client k's own shard.

The personal train's shuffles come from ``personal_perm_fn``, its dropout
and augmentation from seeds of its own: the reference folds 0x0D1770 into
each client's round key, so the global and personal draws are
uncorrelated."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import make_fedavg_round, round_client_perms
from fedml_tpu_torch.algorithms.state_store import (
    ClientState, StatefulFedAvgAPI, resolve_state_store,
)
from fedml_tpu_torch.bridge import from_flax, to_flax_variables
from fedml_tpu_torch.device import fp32_math
from fedml_tpu_torch.models import ModelDef, split_stats
from fedml_tpu_torch.train.client import PermFn, make_local_train
from fedml_tpu_torch.train.evaluate import evaluate

PERSONAL_FOLD = 0x0D1770  # the tag of the personal stream


def seeded_personal_perm_fn(seed: int) -> PermFn:
    """The port's default personal shuffle source: the FedAvg source
    (``seeded_perm_fn``) of a seed derived from ``seed`` and the tag."""
    from fedml_tpu_torch.train.client import seeded_perm_fn

    return seeded_perm_fn(int(np.random.SeedSequence([seed, PERSONAL_FOLD]).generate_state(1)[0]))


def personal_step_seed(seed: int, round_idx: int, slot: int) -> int:
    """The dropout/augmentation seed of client slot ``slot``'s personal
    train in round ``round_idx``."""
    return int(np.random.SeedSequence([seed, round_idx, slot, 1, PERSONAL_FOLD])
               .generate_state(1)[0])


def make_ditto_personal_train(model: ModelDef, tc, epochs: int, lam: float,
                              task: str = "classification"):
    """The personal step ``(w_ref_params, v_vars, x, y, mask, epoch_perm,
    ...) -> (v_vars', metrics)``: the local train with ``prox_mu`` = λ
    pulled toward the external ``w_ref_params``, so λ = 0 is plain local
    training."""
    return make_local_train(model, dataclasses.replace(tc, prox_mu=lam), epochs, task=task,
                            external_prox=True)


def make_ditto_cohort_body(model: ModelDef, config, lam: float, task: str = "classification"):
    """The cohort-level round, ``(global_vars, v_rows, x, y, mask,
    num_samples, client_perms, step_seeds, personal_perms, personal_seeds)
    -> (global_vars', v_rows', metrics)``, shared by the device stack and the
    spill tier. The metrics are the global (FedAvg) training's."""
    fedavg_round = make_fedavg_round(model, config, task=task)
    personal = make_ditto_personal_train(model, config.train, config.fed.epochs, lam, task=task)

    def body(global_vars, v_rows, x, y, mask, num_samples, client_perms, step_seeds,
             personal_perms, personal_seeds):
        new_global, metrics = fedavg_round(global_vars, x, y, mask, num_samples, client_perms,
                                           step_seeds)
        w_ref, _ = split_stats(global_vars)  # the round-start (broadcast) model
        mask_host = mask.cpu()
        new_rows = {k: torch.empty_like(v) for k, v in v_rows.items()}
        for j in range(x.shape[0]):
            v_j, _ = personal(w_ref, {k: v[j] for k, v in v_rows.items()}, x[j], y[j], mask[j],
                              personal_perms[j], mask_host=mask_host[j],
                              step_seed=personal_seeds[j])
            for k, v in v_j.items():
                new_rows[k][j] = v
        return new_global, new_rows, metrics

    return body


class DittoAPI(StatefulFedAvgAPI):
    """Ditto simulator on the FedAvg skeleton, with the per-client personal
    models ``state`` (:class:`~fedml_tpu_torch.algorithms.state_store.ClientState`,
    every row w_0 at the start) and per-client personalized evaluation.
    ``personal_perm_fn`` is the personal trains' shuffle source (default
    :func:`seeded_personal_perm_fn`)."""

    def __init__(self, config, data, model: ModelDef, lam: float = 0.1,
                 personal_perm_fn: Optional[PermFn] = None, **kw):
        super().__init__(config, data, model, **kw)
        self.lam = float(lam)
        n = config.fed.client_num_in_total
        vbytes = sum(v.numel() * v.element_size() for v in self.global_vars.values())
        mode = resolve_state_store(config.fed, vbytes * n, n_clients=n,
                                   population=config.population)
        self.state = ClientState(self.global_vars, n, mode, config.fed.state_dir,
                                 config.population)
        self.personal_perm_fn = personal_perm_fn or seeded_personal_perm_fn(config.seed)
        self.body = make_ditto_cohort_body(model, config, self.lam, self.task)

    def train_round(self, round_idx: int):
        sampled = self._round_plan(round_idx)
        placed = self._place_batch(self._round_batch(sampled, round_idx), round_idx)
        C = len(sampled)
        personal = (round_client_perms(self.personal_perm_fn, round_idx, C),
                    [personal_step_seed(self.config.seed, round_idx, j) for j in range(C)])
        with fp32_math():
            v_rows = self.state.gather(round_idx, sampled)
            self.global_vars, new_rows, metrics = self.body(
                self.global_vars, v_rows, *placed, *personal
            )
            self.state.scatter(sampled, new_rows, round_idx + 1, self._next_cohort(round_idx))
        return sampled, metrics

    def train(self):
        final = dict(super().train() or {})
        personalized = self.personalized_test_on_clients()
        final.update(personalized)
        self.log_fn(personalized)
        return final

    def checkpoint_state(self):
        """The personal models (a resume without them would reset every
        client's personalization)."""
        return self.state.checkpoint_state("v", to_flax_variables)

    def restore_state(self, tree):
        self.state.restore_state(tree, "v", to_flax_variables, from_flax)

    def personalized_test_on_clients(self, batch_size: int = 256, max_clients: int = 256):
        """Each personal model on its client's own shard (the test shard
        where the dataset has one, else the train shard), beside the global
        model on the same shards; above ``max_clients`` clients a seeded
        subset. Returns ``Personalized/Acc``, ``Global/Acc`` and
        ``num_clients_evaluated``."""
        data = self.data
        has_test = data.client_test_x is not None
        ids = range(data.num_clients)
        if data.num_clients > max_clients:
            ids = np.random.default_rng(self.config.seed).choice(
                data.num_clients, size=max_clients, replace=False
            )
        per_rows, g_rows = [], []
        for i in ids:
            x = (data.client_test_x if has_test else data.client_x)[i]
            y = (data.client_test_y if has_test else data.client_y)[i]
            if len(y) == 0:
                continue
            _, acc_p = evaluate(self.model, self.state.row(int(i)), x, y, batch_size=batch_size,
                                task=self.task, eval_fn=self.eval_fn)
            _, acc_g = evaluate(self.model, self.global_vars, x, y, batch_size=batch_size,
                                task=self.task, eval_fn=self.eval_fn)
            per_rows.append(float(acc_p))
            g_rows.append(float(acc_g))
        return {
            "Personalized/Acc": float(np.mean(per_rows)),
            "Global/Acc": float(np.mean(g_rows)),
            "num_clients_evaluated": len(per_rows),
        }
