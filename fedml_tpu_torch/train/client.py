"""Local (client) training (port of ``fedml_tpu/train/client.py``).

``make_local_train(model, tc, epochs)`` returns the per-client training
function ``(variables, x, y, mask, epoch_perm) -> (variables', metrics)``
with x [S, B, *feat], y [S, B], mask [S, B]; metrics are SUMS
{loss_sum, correct, count, steps} so they add up exactly across clients.
The reference runs the steps as a ``lax.scan``; here they are a Python loop
of eager steps, and an all-padding step is skipped on the host — a complete
no-op for params, optimizer state and metrics, as the reference's
``lax.cond`` skip branch is (``client.py:224-271``).

:class:`BatchedLocalTrain` is the batched ("vmap") schedule of the
reference's ``client_axis_map``: every client's step at once under
``torch.func.vmap``, one launch per op for the whole cohort. A client
whose step is all padding is gated per client, as the reference gates it
under vmap (``client.py:256-271``): its params and optimizer state keep
their old values (``torch.where``) and its metrics are multiplied by 0.

The epoch shuffle is a hook. The reference draws it from JAX's threefry
stream (``masked_epoch_perm``, ``client.py:141-154``), which PyTorch cannot
reproduce, so the port takes ``epoch_perm(epoch, mask_flat) -> perm`` from
the caller. The default, :func:`seeded_perm_fn`, keeps the reference's
contract with a seeded CPU ``torch.Generator``: one uniform key per slot,
``+inf`` on padded slots, stable argsort — valid samples fill the first
minibatches in a random order, padding sorts last."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from fedml_tpu_torch.models import ModelDef, split_stats
from fedml_tpu_torch.models.norms import AFFINE_NORMS
from fedml_tpu_torch.train import losses as L
from fedml_tpu_torch.train.optim import apply_updates, build_client_optimizer

# (epoch, mask_flat [S*B] float32 on the CPU) -> perm [S*B] int64 on the CPU
EpochPerm = Callable[[int, torch.Tensor], torch.Tensor]
# (round, client_slot, epoch, mask_flat) -> perm: a round-level source
PermFn = Callable[[int, int, int, torch.Tensor], torch.Tensor]


def masked_epoch_perm(generator: torch.Generator, m_flat: torch.Tensor) -> torch.Tensor:
    """The shuffle contract: a uniform key per slot from ``generator``,
    ``+inf`` on padded slots, stable argsort (padding sorts last)."""
    keys = torch.rand(m_flat.shape, generator=generator)
    keys = torch.where(m_flat > 0, keys, torch.full_like(keys, float("inf")))
    return torch.argsort(keys, stable=True)


def seeded_perm_fn(seed: int) -> PermFn:
    """The port's default shuffle source: a CPU generator seeded from
    (seed, round, client slot, epoch), so the stream is the same whichever
    device trains."""

    def perm_fn(round_idx, slot, epoch, m_flat):
        key = np.random.SeedSequence([seed, round_idx, slot, epoch]).generate_state(1)[0]
        return masked_epoch_perm(torch.Generator().manual_seed(int(key)), m_flat)

    return perm_fn


def make_task_loss(task: str) -> Callable:
    """task → (loss, correct, total): classification, nwp (next-word
    prediction over token windows), tag (multi-label, a sigmoid per
    label; every label of every example counts toward the accuracy) and
    segmentation (per-pixel CE; pixels labelled 255 count nowhere)."""

    def classification(logits, y, mask):
        loss = L.masked_softmax_ce(logits, y, mask)
        correct, total = L.masked_accuracy_stats(logits, y, mask)
        return loss, correct, total

    def nwp(logits, y, mask):
        loss = L.masked_seq_ce(logits, y, mask)
        correct, total = L.masked_seq_accuracy_stats(logits, y, mask)
        return loss, correct, total

    def tag(logits, y, mask):
        loss = L.masked_sigmoid_bce(logits, y, mask)
        pred = (logits > 0).to(torch.float32)
        correct = torch.sum((pred == y).to(torch.float32) * mask[:, None])
        total = torch.sum(mask) * y.shape[-1]
        return loss, correct, total

    def segmentation(logits, y, mask):
        loss = L.masked_pixel_ce(logits, y, mask)
        correct, total = L.masked_pixel_accuracy_stats(logits, y, mask)
        return loss, correct, total

    tasks = {"classification": classification, "nwp": nwp, "tag": tag,
             "segmentation": segmentation}
    if task not in tasks:
        raise NotImplementedError(
            f"task {task!r} is not ported yet (ROADMAP.md); the port has {sorted(tasks)}"
        )
    return tasks[task]


def cast_floats(tree: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Cast every floating leaf; integer leaves pass through."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tree.items()}


class _RoundTo(torch.autograd.Function):
    """x rounded to ``dtype``'s values but kept in x's type; the gradient
    passes through unchanged, as the transpose of the reference's cast
    passes on the float32 gradient its custom VJP returns. Its ops are
    plain torch, so ``torch.func.vmap`` batches it by its generated rule."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, dtype):
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None


def client_step_seed(seed: int, round_idx: int, key: int) -> int:
    """The ``step_seed`` of one client's local train in a round: ``key`` is
    its cohort slot in the simulator and its client index in the
    transport, as the reference keys its round keys."""
    return int(np.random.SeedSequence([seed, round_idx, key, 1]).generate_state(1)[0])


def step_generator(step_seed: int, stream: int, device=None) -> torch.Generator:
    """The generator of one local step's ``stream`` (0: dropout masks, on
    the data's device; 1: augmentation offsets, on the CPU)."""
    key = np.random.SeedSequence([step_seed, stream]).generate_state(1)[0]
    return torch.Generator(device=device if device is not None else "cpu").manual_seed(int(key))


class MixedForward:
    """The shared mixed-precision forward. The float32 master params and
    any float inputs are cast to ``tc.compute_dtype`` inside the
    differentiated function (the cast is linear, so the gradients come back
    in float32 on the master params); integer tokens are not cast; the
    logits are widened back to float32. The running statistics are never
    cast down: the norms take float32 statistics, and an EMA rounded to
    bf16 each step would lose its increments. In float32 every cast is a
    no-op. With ``tc.augment`` set, each step's batch is augmented first
    (train/augment.py), with offsets from the step's generator.

    The scale and bias of every BatchNorm, GroupNorm and LayerNorm are
    rounded to the compute type's values but stay float32: their custom
    backwards return float32 dγ and dβ, which the reference hands to the
    master params unrounded, while autograd would round them to the type of
    a cast γ and β.

    ``fwd(params, xb) -> logits`` for a model without running statistics
    or dropout; :meth:`train` is the whole step's forward."""

    def __init__(self, model: ModelDef, tc):
        from fedml_tpu_torch.train.augment import resolve_augment

        cdt = getattr(torch, tc.compute_dtype, None)
        if not isinstance(cdt, torch.dtype) or not cdt.is_floating_point:
            raise ValueError(f"unknown compute_dtype {tc.compute_dtype!r}")
        self.model, self.cdt = model, cdt
        self.augment = resolve_augment(getattr(tc, "augment", "none"))
        self.affine = set()
        if cdt != torch.float32:
            for name, mod in model.module.named_modules():
                if isinstance(mod, AFFINE_NORMS):
                    self.affine.update(f"{name}.{leaf}" if name else leaf for leaf in ("scale", "bias"))

    def __call__(self, params, xb):
        return self.train(params, {}, xb)[0]

    def train(self, params, stats, xb, step_seed: int = 0):
        """→ (float32 logits, new running statistics)."""
        cdt = self.cdt
        if self.augment is not None:
            xb = self.augment(step_generator(step_seed, 1), xb)
        xb_c = xb.to(cdt) if xb.is_floating_point() else xb
        params_c = cast_floats({k: v for k, v in params.items() if k not in self.affine}, cdt)
        params_c.update({k: _RoundTo.apply(params[k], cdt) for k in self.affine if k in params})
        gen = step_generator(step_seed, 0, xb.device) if self.model.has_dropout else None
        logits, new_vars = self.model.apply({**params_c, **stats}, xb_c, train=True, rng=gen)
        return logits.float(), {k: new_vars[k] for k in stats}


def make_mixed_forward(model: ModelDef, tc) -> MixedForward:
    """The forward of a local step (see :class:`MixedForward`)."""
    return MixedForward(model, tc)


class LocalTrain:
    """The per-client training function (see the module docstring).
    :meth:`run_epochs` is the same loop with the optimizer state in and
    out, for callers that carry it.

    Only the parameters are differentiated and stepped by the optimizer;
    after each real step the model's new running statistics replace the
    old, and an all-padding step keeps both. Each step's dropout masks and
    augmentation offsets come from generators of its own, seeded from the
    client's ``step_seed``, the epoch and the step."""

    def __init__(self, model: ModelDef, tc, epochs: int, task: str = "classification"):
        self.tc = tc
        self.epochs = epochs
        self.opt = build_client_optimizer(tc)
        self.task_loss = make_task_loss(task)
        self.fwd = make_mixed_forward(model, tc)
        self._random_steps = model.has_dropout or self.fwd.augment is not None

    def _step(self, params, stats, opt_state, xb, yb, mb, prox_ref, step_seed):
        tc = self.tc
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        logits, new_stats = self.fwd.train(p, stats, xb, step_seed)
        task_l, correct, total = self.task_loss(logits, yb, mb)
        loss = task_l
        if tc.prox_mu:
            loss = loss + 0.5 * tc.prox_mu * L.tree_sq_dist(p, prox_ref)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        with torch.no_grad():
            updates, opt_state = self.opt.update(grads, opt_state, params)
            new_params = apply_updates(params, updates)
            # task_l (not loss) feeds the metrics, as in the reference
            mets = torch.stack([task_l * total, correct, total, torch.ones_like(total)])
        return new_params, new_stats, opt_state, mets

    def run_epochs(
        self,
        variables: Dict[str, torch.Tensor],
        opt_state,
        x: torch.Tensor,
        y: torch.Tensor,
        mask: torch.Tensor,
        epoch_perm: EpochPerm,
        mask_host: Optional[torch.Tensor] = None,
        step_seed: int = 0,
        prox_ref: Optional[Dict[str, torch.Tensor]] = None,
    ):
        """→ (variables', opt_state', mets [4] = loss_sum, correct, count,
        steps). ``opt_state`` is over the parameters only. ``mask_host``
        is ``mask`` on the CPU when the caller has it (it decides, with the
        permutation, which steps hold data). The proximal term (``prox_mu``)
        pulls toward ``prox_ref``, by default the entry parameters."""
        params, stats = split_stats(variables)
        S, B = mask.shape[0], mask.shape[1]
        n_flat = S * B
        x_flat = x.reshape((n_flat,) + tuple(x.shape[2:]))
        y_flat = y.reshape((n_flat,) + tuple(y.shape[2:]))
        m_flat = mask.reshape(n_flat)
        m_host = (mask_host if mask_host is not None else mask).reshape(n_flat).cpu()
        if prox_ref is None:
            prox_ref = params
        prox_ref = {k: v.detach() for k, v in prox_ref.items()}
        mets = torch.zeros(4, dtype=torch.float32, device=mask.device)
        for epoch in range(self.epochs):
            perm_host = epoch_perm(epoch, m_host)
            has_data = (m_host[perm_host].reshape(S, B).sum(dim=1) > 0).tolist()
            perm = perm_host.to(mask.device)
            xe = x_flat[perm].reshape(x.shape)
            ye = y_flat[perm].reshape(y.shape)
            me = m_flat[perm].reshape(mask.shape)
            for s in range(S):
                if not has_data[s]:
                    continue  # all-padding step: a complete no-op
                seed = (
                    int(np.random.SeedSequence([step_seed, epoch, s]).generate_state(1)[0])
                    if self._random_steps else 0
                )
                params, stats, opt_state, step_mets = self._step(
                    params, stats, opt_state, xe[s], ye[s], me[s], prox_ref, seed
                )
                mets = mets + step_mets
        return {**params, **stats}, opt_state, mets

    def __call__(self, variables, x, y, mask, epoch_perm: EpochPerm, mask_host=None,
                 step_seed: int = 0):
        params, _ = split_stats(variables)
        new_vars, _, mets = self.run_epochs(
            variables, self.opt.init(params), x, y, mask, epoch_perm, mask_host, step_seed
        )
        # "steps" = effective local optimizer steps (all-padding steps are
        # skipped and not counted) — FedNova's τ_i normalizer
        metrics = {
            "loss_sum": mets[0],
            "correct": mets[1],
            "count": mets[2],
            "steps": mets[3],
        }
        return new_vars, metrics


class ExternalProxLocalTrain(LocalTrain):
    """:class:`LocalTrain` whose proximal term pulls toward an EXTERNAL
    reference, ``(prox_ref, variables, x, y, mask, epoch_perm, ...)``:
    Ditto's personal step, pulled toward the broadcast global parameters
    rather than the entry ones (the reference's ``external_prox=True``)."""

    def __call__(self, prox_ref, variables, x, y, mask, epoch_perm: EpochPerm, mask_host=None,
                 step_seed: int = 0):
        params, _ = split_stats(variables)
        new_vars, _, mets = self.run_epochs(
            variables, self.opt.init(params), x, y, mask, epoch_perm, mask_host, step_seed,
            prox_ref=prox_ref,
        )
        return new_vars, dict(zip(("loss_sum", "correct", "count", "steps"), mets))


def make_local_train(model: ModelDef, tc, epochs: int, task: str = "classification",
                     external_prox: bool = False) -> LocalTrain:
    """Build the per-client training function (see :class:`LocalTrain`;
    ``external_prox`` gives :class:`ExternalProxLocalTrain`)."""
    return (ExternalProxLocalTrain if external_prox else LocalTrain)(model, tc, epochs, task=task)


def client_axis_map(fn: Callable, n_broadcast: int = 1) -> Callable:
    """The reference's ``client_axis_map`` in its batched ("vmap") form:
    ``fn`` lifted over a leading client axis with ``torch.func.vmap``; the
    first ``n_broadcast`` positional args go to every client
    (``in_dims=None``), the rest carry the client axis. The sequential
    form is the loop of ``algorithms/fedavg.py`` ``train_clients``."""

    def vmapped(*args):
        in_dims = (None,) * n_broadcast + (0,) * (len(args) - n_broadcast)
        return torch.func.vmap(fn, in_dims=in_dims)(*args)

    return vmapped


def batched_schedule_refusal(model: ModelDef, tc=None) -> Optional[str]:
    """Why :class:`BatchedLocalTrain` cannot train ``model`` (None if it
    can). Running statistics leave ``ModelDef.apply`` through a side
    channel that batched tensors must not escape by; dropout and
    augmentation draw from one generator a client step; ``torch.lstm`` has
    no batching rule."""
    from fedml_tpu_torch.models.rnn import OptimizedLSTMCell
    from fedml_tpu_torch.train.augment import resolve_augment

    if model.has_batch_stats:
        return "running statistics"
    if model.has_dropout:
        return "dropout"
    if any(isinstance(m, OptimizedLSTMCell) for m in model.module.modules()):
        return "an LSTM"
    if tc is not None and resolve_augment(getattr(tc, "augment", "none")) is not None:
        return "augmentation"
    return None


def _batched_counts(state, clients: int, device):
    """An optimizer state with each host-int step count replaced by one
    count a client."""
    def leaf(v):
        if isinstance(v, int) and not isinstance(v, bool):
            return torch.full((clients,), v, dtype=torch.int64, device=device)
        return v

    return tree_map(leaf, state)


class BatchedLocalTrain:
    """Every client's local train from the same global variables at once:
    ``(global_vars, x, y, mask, client_perms, mask_host=None) ->
    (client_vars [C, ...], mets [C, 4])`` with x [C, S, B, *feat] and mets
    in (loss_sum, correct, count, steps) order, the numbers of
    :class:`LocalTrain` run client by client.

    Each step is ``torch.func.grad_and_value`` over
    :meth:`MixedForward.train` and the optimizer update, lifted over the
    clients by :func:`client_axis_map`; the proximal term pulls toward the
    broadcast global parameters (FedProx). Each client's shuffle comes from
    its own ``EpochPerm`` on the host; the shuffles are stacked to [C, S·B]
    and gathered outside the vmapped step. A step that is all padding for
    every client is skipped; one that is for some clients is computed for
    all and gated per client. The optimizer's step count is one count a
    client (train/optim.py ``_bias_correction``).

    The cohort is trained in groups of at most ``max_clients`` clients
    (None, the start: the whole cohort), each group's local train whole
    before the next; the clients are independent, so the grouping changes
    no number. A group the device's memory cannot hold (CUDA out of
    memory) is retried at half the size, and ``max_clients`` keeps that
    size for later calls: the cohort is sized to the card's free memory
    by what fits."""

    def __init__(self, model: ModelDef, tc, epochs: int, task: str = "classification"):
        reason = batched_schedule_refusal(model, tc)
        if reason is not None:
            raise NotImplementedError(
                f"the batched client schedule does not run a model with {reason} yet "
                "(ROADMAP.md §1 item 13)"
            )
        self.epochs = epochs
        self.max_clients: Optional[int] = None
        self.opt = opt = build_client_optimizer(tc)
        task_loss = make_task_loss(task)
        fwd = make_mixed_forward(model, tc)
        prox_mu = tc.prox_mu

        def loss_fn(params, prox_ref, xb, yb, mb):
            logits, _ = fwd.train(params, {}, xb)
            task_l, correct, total = task_loss(logits, yb, mb)
            loss = task_l
            if prox_mu:
                loss = loss + 0.5 * prox_mu * L.tree_sq_dist(params, prox_ref)
            return loss, (task_l, correct, total)

        grad_fn = torch.func.grad_and_value(loss_fn, has_aux=True)

        def step(prox_ref, params, opt_state, xb, yb, mb, has_data):
            grads, (_, (task_l, correct, total)) = grad_fn(params, prox_ref, xb, yb, mb)
            updates, new_state = opt.update(grads, opt_state, params)
            new_params = apply_updates(params, updates)

            def keep(new, old):
                return torch.where(has_data, new, old)

            # task_l (not loss) feeds the metrics, as in the reference
            mets = torch.stack([task_l * total, correct, total, torch.ones_like(total)])
            return (tree_map(keep, new_params, params), tree_map(keep, new_state, opt_state),
                    mets * has_data.to(mets.dtype))

        self._step = client_axis_map(step, n_broadcast=1)

    def __call__(self, global_vars: Dict[str, torch.Tensor], x, y, mask,
                 client_perms: List[EpochPerm], mask_host: Optional[torch.Tensor] = None):
        C = mask.shape[0]
        m_host = (mask_host if mask_host is not None else mask).cpu()
        parts, start = [], 0
        while start < C:
            size = min(C - start, self.max_clients or C)
            g = slice(start, start + size)
            part = self._group_or_none(global_vars, x[g], y[g], mask[g], client_perms[g],
                                       m_host[g])
            if part is None:  # out of device memory: retry the group at half its size
                if size == 1:
                    raise torch.cuda.OutOfMemoryError(
                        "one client's batched local train does not fit in device memory")
                torch.cuda.empty_cache()
                self.max_clients = size // 2
                continue
            parts.append(part)
            start += size
        if len(parts) == 1:
            return parts[0]
        return ({k: torch.cat([p[k] for p, _ in parts]) for k in parts[0][0]},
                torch.cat([m for _, m in parts]))

    def _group_or_none(self, *args):
        """:meth:`_train_group`, or None if the device ran out of memory
        (the failed group's tensors are freed when this returns)."""
        try:
            return self._train_group(*args)
        except torch.cuda.OutOfMemoryError:
            return None

    def _train_group(self, global_vars, x, y, mask, client_perms, m_host):
        C, S, B = mask.shape[0], mask.shape[1], mask.shape[2]
        dev = mask.device
        prox_ref = {k: v.detach() for k, v in global_vars.items()}
        params = {k: v.unsqueeze(0).expand((C,) + tuple(v.shape)).clone()
                  for k, v in prox_ref.items()}
        opt_state = _batched_counts(self.opt.init(params), C, dev)
        n_flat = S * B
        x_flat = x.reshape((C, n_flat) + tuple(x.shape[3:]))
        y_flat = y.reshape((C, n_flat) + tuple(y.shape[3:]))
        m_flat = mask.reshape(C, n_flat)
        m_host = m_host.reshape(C, n_flat)
        rows = torch.arange(C, device=dev)[:, None]
        mets = torch.zeros(C, 4, dtype=torch.float32, device=dev)
        for epoch in range(self.epochs):
            perm_host = torch.stack([client_perms[j](epoch, m_host[j]) for j in range(C)])
            has_data = torch.gather(m_host, 1, perm_host).reshape(C, S, B).sum(dim=2) > 0
            live = has_data.any(dim=0).tolist()
            perm = perm_host.to(dev)
            xe = x_flat[rows, perm].reshape(x.shape)
            ye = y_flat[rows, perm].reshape(y.shape)
            me = m_flat[rows, perm].reshape(mask.shape)
            gate = has_data.to(dev)
            for s in range(S):
                if not live[s]:
                    continue  # all padding for every client: a complete no-op
                params, opt_state, step_mets = self._step(
                    prox_ref, params, opt_state, xe[:, s], ye[:, s], me[:, s], gate[:, s]
                )
                mets = mets + step_mets
        return params, mets
