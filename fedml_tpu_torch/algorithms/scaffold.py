"""SCAFFOLD — stochastic controlled averaging (port of
``fedml_tpu/algorithms/scaffold.py``, its single-device rounds;
Karimireddy et al. 2020, Option II).

    server state: x (params), c (control variate, same tree)
    client i:     c_i (persists across rounds; zero at the start)
    local step:   y ← y − lr·(∇f_i(y) + c − c_i)
    after K steps: c_i⁺ = c_i − c + (x − y)/(K·lr)
    server:       x ← x + η_g·Σ w_i Δy_i,  c ← c + (|S|/N)·mean(Δc_i)

K counts the steps that carried data; a client with K = 0 keeps c_i. The
control variates stay float32 whatever ``compute_dtype`` is. The state is
N × |params|: one [N, ...] stack per leaf on the device while it fits
``FedConfig.state_budget_bytes`` (the cohort's rows gathered with
``index_select`` and written back in place with ``index_copy_``), else the
mmap spill tier (algorithms/state_store.py ``ClientState``); both run the
same cohort body (:func:`make_scaffold_cohort_body`), so the two modes
agree bit for bit.

Plain-SGD local steps only: the control-variate correction is defined on
the SGD update (momentum, Adam, ``prox_mu`` and ``wd`` are refused)."""

from __future__ import annotations

import torch

from fedml_tpu_torch.algorithms.fedavg import _METRIC_KEYS
from fedml_tpu_torch.algorithms.state_store import (
    ClientState, StatefulFedAvgAPI, resolve_state_store,
)
from fedml_tpu_torch.bridge import from_flax, to_flax
from fedml_tpu_torch.device import fp32_math
from fedml_tpu_torch.models import ModelDef, split_stats
from fedml_tpu_torch.train.client import EpochPerm, LocalTrain


class ScaffoldLocalTrain(LocalTrain):
    """One client's SCAFFOLD local train, ``(variables, c_server, c_i, x, y,
    mask, epoch_perm, mask_host=None, step_seed=0) -> (y_vars, c_i⁺,
    metrics)``: :class:`LocalTrain`'s loop (shuffles, skipped all-padding
    steps, running statistics) with the corrected SGD step. The correction
    c − c_i rides through the loop in the optimizer state's place."""

    def __init__(self, model: ModelDef, tc, epochs: int, task: str = "classification"):
        if tc.client_optimizer != "sgd" or tc.momentum:
            raise ValueError(
                "SCAFFOLD requires plain-SGD local steps "
                f"(got {tc.client_optimizer!r}, momentum={tc.momentum})"
            )
        if tc.prox_mu:
            raise ValueError("SCAFFOLD with prox_mu is not supported")
        if tc.wd:
            raise ValueError("SCAFFOLD with weight decay (wd) is not supported")
        super().__init__(model, tc, epochs, task=task)
        self.lr = tc.lr

    def _step(self, params, stats, correction, xb, yb, mb, prox_ref, step_seed):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        logits, new_stats = self.fwd.train(p, stats, xb, step_seed)
        loss, correct, total = self.task_loss(logits, yb, mb)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        with torch.no_grad():
            lr = self.lr
            new_params = {k: params[k] - lr * (grads[k] + correction[k]) for k in params}
            mets = torch.stack([loss * total, correct, total, torch.ones_like(total)])
        return new_params, new_stats, correction, mets

    def __call__(self, variables, c_server, c_i, x, y, mask, epoch_perm: EpochPerm,
                 mask_host=None, step_seed: int = 0):
        params0, _ = split_stats(variables)
        correction = {k: c_server[k] - c_i[k] for k in c_i}
        new_vars, _, mets = self.run_epochs(
            variables, correction, x, y, mask, epoch_perm, mask_host, step_seed
        )
        k_steps = mets[3]
        k_safe = torch.clamp(k_steps, min=1.0)
        with torch.no_grad():
            c_new = {
                k: torch.where(
                    k_steps > 0,
                    c_i[k] - c_server[k] + (params0[k].float() - new_vars[k].float())
                    / (k_safe * self.lr),
                    c_i[k],
                )
                for k in c_i
            }
        return new_vars, c_new, dict(zip(("loss_sum", "correct", "count", "steps"), mets))


def make_scaffold_cohort_body(model: ModelDef, config, task: str = "classification"):
    """The cohort-level round, ``(global_vars, c_server, c_rows, x, y, mask,
    num_samples, client_perms, step_seeds=None) -> (global_vars', c_server',
    c_rows', metric sums)``, shared by the device stack and the spill tier.
    A row with ``num_samples`` 0 (a padded client, all-zero mask) keeps its
    c_i and adds nothing to c."""
    local_train = ScaffoldLocalTrain(model, config.train, config.fed.epochs, task=task)
    eta_g = config.server.server_lr
    n_total = config.fed.client_num_in_total

    def body(global_vars, c_server, c_rows, x, y, mask, num_samples, client_perms,
             step_seeds=None):
        C = x.shape[0]
        mask_host = mask.cpu()
        y_vars, c_new, sums = {}, {k: torch.empty_like(v) for k, v in c_rows.items()}, None
        for j in range(C):
            yv, cn, mets = local_train(
                global_vars, c_server, {k: v[j] for k, v in c_rows.items()}, x[j], y[j],
                mask[j], client_perms[j], mask_host=mask_host[j],
                step_seed=0 if step_seeds is None else step_seeds[j],
            )
            for k, v in yv.items():
                if k not in y_vars:
                    y_vars[k] = torch.empty((C,) + tuple(v.shape), dtype=v.dtype, device=v.device)
                y_vars[k][j] = v
            for k, v in cn.items():
                c_new[k][j] = v
            vec = torch.stack([mets[k] for k in _METRIC_KEYS])
            sums = vec if sums is None else sums + vec
        w = num_samples / torch.clamp(torch.sum(num_samples), min=1e-9)
        params, _ = split_stats(y_vars)
        new_global = {}
        for k, s in y_vars.items():
            if k in params:
                g = global_vars[k].float()
                delta = torch.tensordot(w, s.float() - g[None], dims=1)
                new_global[k] = (g + eta_g * delta).to(global_vars[k].dtype)
            else:
                new_global[k] = torch.tensordot(w, s.float(), dims=1)
        # c ← c + Σ_incl Δc_i / N: |S| and the mean over the rows that hold
        # data, so a padded row inflates neither
        incl = (num_samples > 0).float()
        c_server_new = {
            k: cs + torch.tensordot(incl, c_new[k] - c_rows[k], dims=1) / n_total
            for k, cs in c_server.items()
        }
        return new_global, c_server_new, c_new, dict(zip(_METRIC_KEYS, sums))

    return body


class ScaffoldAPI(StatefulFedAvgAPI):
    """SCAFFOLD simulator on the FedAvg skeleton, with the server control
    variate ``c_server`` and the per-client store ``state``
    (:class:`~fedml_tpu_torch.algorithms.state_store.ClientState`: the
    device stack, or the mmap tier past ``state_budget_bytes`` or when
    ``state_store`` says so). ``checkpoint_state``/``restore_state`` write
    and read the reference's two forms, so either form resumes either mode
    in either package."""

    def __init__(self, config, data, model: ModelDef, **kw):
        super().__init__(config, data, model, **kw)
        params, _ = split_stats(self.global_vars)
        n = config.fed.client_num_in_total
        zeros = {k: torch.zeros(v.shape, dtype=torch.float32, device=self.device)
                 for k, v in params.items()}
        self.c_server = {k: v.clone() for k, v in zeros.items()}
        psize = sum(v.numel() for v in params.values())
        mode = resolve_state_store(config.fed, 4 * psize * n, n_clients=n,
                                   population=config.population)
        self.state = ClientState(zeros, n, mode, config.fed.state_dir, config.population)
        self.body = make_scaffold_cohort_body(model, config, self.task)

    def train_round(self, round_idx: int):
        sampled = self._round_plan(round_idx)
        placed = self._place_batch(self._round_batch(sampled, round_idx), round_idx)
        with fp32_math():
            c_rows = self.state.gather(round_idx, sampled)
            self.global_vars, self.c_server, c_new, metrics = self.body(
                self.global_vars, self.c_server, c_rows, *placed
            )
            self.state.scatter(sampled, c_new, round_idx + 1, self._next_cohort(round_idx))
        return sampled, metrics

    def checkpoint_state(self):
        """The control variates (a resume without them would restart c and
        every c_i at zero)."""
        out = {"c_server": to_flax(self.c_server)}
        out.update(self.state.checkpoint_state("c", to_flax))
        return out

    def restore_state(self, tree):
        self.c_server = {
            k: v.to(self.device, torch.float32)
            for k, v in from_flax(tree["c_server"]).items()
        }
        self.state.restore_state(tree, "c", to_flax, from_flax)
