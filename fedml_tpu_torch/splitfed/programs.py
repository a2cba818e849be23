"""The split-learning and vertical-FL steps (port of
``fedml_tpu/splitfed/programs.py``) as plain functions on tensors.

- SplitNN: the fused simulator step over the joint ``{"bottom", "top"}``
  parameters (autograd through the composition is the activation-gradient
  exchange), and the boundary programs the transports run: the client's
  forward (activations cross the wire), the server's step (loss, top
  update, and ∂L/∂acts back), the client's backward (the forward
  recomputed, so the client keeps no tape across the wire wait), and eval.
- Vertical FL: the fused multi-party step over the list of party
  parameters (party 0, the guest, holds the labels), and its wire forms: a
  party's forward (its logit contribution), the guest's loss and
  ∂L/∂h_k for every party, and a party's backward and update.

The composition of the boundary programs over per-group optimizer states
equals the fused step over the joint parameters: both optimizer transforms
act leaf by leaf, and each program runs the same ops on the same values
(tests/test_torch_split_nn.py holds them bit-equal). The optimizer states
keep ``train/optim.py``'s layout with the joint parameters named
``bottom.<name>``/``top.<name>`` (SplitNN) or ``<party>.<name>`` (VFL);
:func:`merge_opt_state`/:func:`split_opt_state` and the party forms move a
state between the fused tree and the per-group trees, exactly. There is
no program cache: PyTorch runs these eagerly."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from fedml_tpu_torch.models.vfl import party_contribution
from fedml_tpu_torch.train import optim

Params = Dict[str, torch.Tensor]
GROUPS = ("bottom", "top")


def make_split_optimizer(lr: float, momentum: float, wd: float) -> optim.GradientTransformation:
    """The one split-learning optimizer: L2 added to the gradient, then
    SGD with momentum (the reference's SGD(0.1, momentum=0.9, wd=5e-4)),
    shared by the fused step, the boundary programs and the transports."""
    return optim.chain(optim.add_decayed_weights(wd), optim.sgd(lr, momentum=momentum))


def join(groups: Sequence[Params], names: Sequence[str]) -> Params:
    """Per-group dicts → one dict with ``<group>.`` prefixed names."""
    return {f"{n}.{k}": v for n, g in zip(names, groups) for k, v in g.items()}


def unjoin(flat: Params, names: Sequence[str]) -> List[Params]:
    """The inverse of :func:`join`."""
    out = {n: {} for n in names}
    for key, v in flat.items():
        n, _, k = key.partition(".")
        out[n][k] = v
    return [out[n] for n in names]


def _map_state(fn, *states):
    """``fn`` over the parameter dicts of optimizer states of one structure
    (tuples and NamedTuples of dicts); other leaves (counts) come from the
    first state."""
    s0 = states[0]
    if isinstance(s0, dict):
        return fn(*states)
    if isinstance(s0, tuple):
        parts = [_map_state(fn, *p) for p in zip(*states)]
        return type(s0)(*parts) if hasattr(s0, "_fields") else tuple(parts)
    return s0


def _with_grad(params: Params) -> Params:
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def _grads(out, leaves: Params, grad_out=None) -> Params:
    return dict(zip(leaves, torch.autograd.grad(out, list(leaves.values()), grad_out)))


def _update(opt, params: Params, grads: Params, state) -> Tuple[Params, object]:
    with torch.no_grad():
        updates, state = opt.update(grads, state, params)
        return optim.apply_updates(params, updates), state


def _ce(logits, y):
    """Mean softmax cross-entropy on integer labels, and the correct count."""
    return F.cross_entropy(logits, y), (logits.argmax(-1) == y).sum()


# -- SplitNN ------------------------------------------------------------------


def make_splitnn_fused_step(bottom, top, lr: float = 0.1, momentum: float = 0.9,
                            wd: float = 5e-4):
    """``(params, opt_state, x, y) -> (params, opt_state, loss, correct)``
    over ``params = {"bottom": vars, "top": vars}`` and the optimizer state
    of their :func:`join`."""
    opt = make_split_optimizer(lr, momentum, wd)

    def step(params, opt_state, x, y):
        flat = join([params[g] for g in GROUPS], GROUPS)
        leaves = _with_grad(flat)
        b, t = unjoin(leaves, GROUPS)
        acts, _ = bottom.apply(b, x, train=True)
        logits, _ = top.apply(t, acts, train=True)
        loss, correct = _ce(logits, y)
        new, opt_state = _update(opt, flat, _grads(loss, leaves), opt_state)
        return dict(zip(GROUPS, unjoin(new, GROUPS))), opt_state, loss.detach(), correct

    return step


def make_splitnn_client_forward(bottom):
    """The client's side of the cut: ``(bottom_params, x) -> acts``."""

    def forward(bottom_params, x):
        with torch.no_grad():
            return bottom.apply(bottom_params, x, train=True)[0]

    return forward


def make_splitnn_server_step(top, lr: float = 0.1, momentum: float = 0.9, wd: float = 5e-4):
    """The server's side: ``(top_params, top_opt_state, acts, y) ->
    (top_params, top_opt_state, loss, correct, acts_grad)``."""
    opt = make_split_optimizer(lr, momentum, wd)

    def step(top_params, top_opt_state, acts, y):
        leaves = _with_grad(top_params)
        a = acts.detach().requires_grad_(True)
        logits, _ = top.apply(leaves, a, train=True)
        loss, correct = _ce(logits, y)
        *gt, acts_grad = torch.autograd.grad(loss, [*leaves.values(), a])
        new, state = _update(opt, top_params, dict(zip(leaves, gt)), top_opt_state)
        return new, state, loss.detach(), correct, acts_grad

    return step


def make_splitnn_client_backward(bottom, lr: float = 0.1, momentum: float = 0.9,
                                 wd: float = 5e-4):
    """The client's backward with the returned activation gradients:
    ``(bottom_params, bottom_opt_state, x, acts_grad) -> (bottom_params,
    bottom_opt_state)``, the forward recomputed."""
    opt = make_split_optimizer(lr, momentum, wd)

    def step(bottom_params, bottom_opt_state, x, acts_grad):
        leaves = _with_grad(bottom_params)
        acts, _ = bottom.apply(leaves, x, train=True)
        return _update(opt, bottom_params, _grads(acts, leaves, acts_grad), bottom_opt_state)

    return step


def make_splitnn_eval(bottom, top):
    """``(bottom_params, top_params, x, y) -> correct`` (eval mode)."""

    def ev(bottom_params, top_params, x, y):
        with torch.no_grad():
            acts, _ = bottom.apply(bottom_params, x, train=False)
            logits, _ = top.apply(top_params, acts, train=False)
            return (logits.argmax(-1) == y).sum()

    return ev


def merge_opt_state(bottom_state, top_state):
    """Per-group optimizer states → the fused state over the joint
    parameters."""
    return _map_state(lambda b, t: join([b, t], GROUPS), bottom_state, top_state)


def split_opt_state(fused_state):
    """The fused state → ``(bottom_state, top_state)``: the inverse of
    :func:`merge_opt_state`."""
    return tuple(_map_state(lambda d, i=i: unjoin(d, GROUPS)[i], fused_state) for i in (0, 1))


# -- vertical FL ---------------------------------------------------------------


def _party_names(n: int) -> List[str]:
    return [str(i) for i in range(n)]


def _bce(logit, y):
    """Mean sigmoid binary cross-entropy on logits, and the correct count."""
    return F.binary_cross_entropy_with_logits(logit, y), ((logit > 0) == (y > 0.5)).sum()


def make_vfl_fused_step(lr: float = 0.05, momentum: float = 0.9):
    """``(all_params, opt_state, xs, y) -> (all_params, opt_state, loss,
    correct)`` over the list of party parameters and the optimizer state of
    their :func:`join` (names ``<party>.<name>``)."""
    opt = optim.sgd(lr, momentum=momentum)

    def step(all_params, opt_state, xs, y):
        names = _party_names(len(all_params))
        flat = join(all_params, names)
        leaves = _with_grad(flat)
        parts = unjoin(leaves, names)
        logit = sum(party_contribution(p, x) for p, x in zip(parts, xs)).reshape(-1)
        loss, correct = _bce(logit, y)
        new, opt_state = _update(opt, flat, _grads(loss, leaves), opt_state)
        return unjoin(new, names), opt_state, loss.detach(), correct

    return step


def vfl_party_forward(params: Params, x):
    """A party's logit contribution h_k, the value that crosses the wire."""
    with torch.no_grad():
        return party_contribution(params, x)


def vfl_guest_grad(contribs, y):
    """The guest's side of the cut: ``(contribs, y) -> (loss, correct,
    [∂L/∂h_k])`` over the summed contributions, party 0's first."""
    cs = [c.detach().requires_grad_(True) for c in contribs]
    loss, correct = _bce(sum(cs).reshape(-1), y)
    return loss.detach(), correct, list(torch.autograd.grad(loss, cs))


def make_vfl_party_update(lr: float = 0.05, momentum: float = 0.9):
    """A party's backward and update with its returned gradient:
    ``(params, opt_state, x, contrib_grad) -> (params, opt_state)``."""
    opt = optim.sgd(lr, momentum=momentum)

    def step(params, opt_state, x, contrib_grad):
        leaves = _with_grad(params)
        c = party_contribution(leaves, x)
        return _update(opt, params, _grads(c, leaves, contrib_grad), opt_state)

    return step


def split_party_opt_states(fused_state, n_parties: int) -> list:
    """The fused state over the parties' joint parameters → per-party
    states."""
    names = _party_names(n_parties)
    return [_map_state(lambda d, i=i: unjoin(d, names)[i], fused_state) for i in range(n_parties)]


def merge_party_opt_states(states) -> object:
    """Per-party states → the fused state: the inverse of
    :func:`split_party_opt_states`."""
    names = _party_names(len(states))
    return _map_state(lambda *ds: join(ds, names), *states)
