"""Model surface of the port (counterpart of ``fedml_tpu/models/__init__.py``).

Every model is wrapped in a :class:`ModelDef` giving the framework a
functional surface like the reference's: ``init(generator) -> variables``
and ``apply(variables, x, train) -> (outputs, variables)``. ``variables`` is
a plain ``{name: tensor}`` dict keyed like the module's ``state_dict``; the
``nn.Module`` itself only describes the computation
(``torch.func.functional_call``), so the federated loop can hold, stack and
average many copies of the weights without many modules.

Inputs keep the reference's layout (NHWC images, integer token windows),
so the two packages are fed the same arrays.

**Batch statistics and dropout.** ``variables`` stays one flat dict: the
parameters under their ``state_dict`` names, and the BatchNorm running
statistics (the module's buffers) under ``batch_stats.`` + their buffer
name, as the reference keeps them in its ``batch_stats`` collection
(leaves ``mean``/``var``). ``apply(..., train=True)`` returns the new
statistics in the variables it gives back, as flax's
``mutable=["batch_stats"]`` does: the layers hand them to the apply around
them (:func:`record_batch_stats`) and no buffer is written. Dropout draws
its masks from the ``torch.Generator`` passed as ``rng`` (on the inputs'
device), never from the global RNG."""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import math
import threading
from typing import Dict, Optional, Tuple

import torch
from torch import nn

Variables = Dict[str, torch.Tensor]

# flax's lecun_normal: a normal truncated to ±2σ, rescaled so the truncated
# distribution's stddev is sqrt(1/fan_in) (the constant is the stddev of a
# unit normal truncated to [-2, 2], jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init on a torch weight ([O, I, ...]: fan_in is
    the product of every dim but the first)."""
    fan_in = math.prod(t.shape[1:])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(
        t, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std, generator=generator
    )


def init_param_(module: nn.Module, leaf: str, t: torch.Tensor, generator: torch.Generator):
    """Fill ``t``, the parameter ``leaf`` of ``module``, with its flax
    initializer: a normal of the std in the module's own
    ``normal_init_std`` entry for ``leaf`` if it has one, an orthogonal
    matrix where the module lists ``leaf`` in ``orthogonal_init`` (flax's
    recurrent kernels), else by name — dense/conv ``weight``: lecun_normal;
    ``bias``: zeros; norm ``scale``: ones; ``embedding`` [V, C]: flax's
    ``default_embed_init``, an untruncated normal of std 1/√C."""
    if leaf in getattr(module, "orthogonal_init", ()):
        return nn.init.orthogonal_(t, generator=generator)
    std = getattr(module, "normal_init_std", {}).get(leaf)
    if leaf == "embedding":
        std = math.sqrt(1.0 / t.shape[-1])
    if std is not None:
        return nn.init.normal_(t, mean=0.0, std=std, generator=generator)
    if leaf == "weight" and t.dim() >= 2:
        return lecun_normal_(t, generator)
    if leaf == "bias":
        return t.zero_()
    if leaf == "scale":
        return t.fill_(1.0)
    raise ValueError(f"no flax initializer known for parameter {leaf!r} of {type(module).__name__}")


_SCOPE = threading.local()  # the apply in progress on this thread


class _ApplyScope:
    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator
        self.new_stats: Dict[nn.Module, Tuple[torch.Tensor, torch.Tensor]] = {}


@contextlib.contextmanager
def _apply_scope(generator):
    outer = getattr(_SCOPE, "current", None)
    _SCOPE.current = scope = _ApplyScope(generator)
    try:
        yield scope
    finally:
        _SCOPE.current = outer


def _current_scope(what: str) -> _ApplyScope:
    scope = getattr(_SCOPE, "current", None)
    if scope is None:
        raise RuntimeError(f"{what} in training mode runs only inside ModelDef.apply")
    return scope


def record_batch_stats(module: nn.Module, mean: torch.Tensor, var: torch.Tensor) -> None:
    """A BatchNorm's new running statistics, for the apply around it."""
    _current_scope("BatchNorm").new_stats[module] = (mean.detach(), var.detach())


def dropout_generator() -> torch.Generator:
    """The generator a training-mode dropout draws its mask from."""
    return _current_scope("Dropout").generator


STATS = "batch_stats."  # the key prefix of the running statistics


@dataclasses.dataclass
class ModelDef:
    module: nn.Module
    input_shape: Tuple[int, ...]  # per-example shape (no batch dim), NHWC
    num_classes: int
    name: str = "model"
    input_dtype: torch.dtype = torch.float32  # torch.int32 for token models
    has_dropout: bool = False
    has_batch_stats: bool = False

    def __post_init__(self):
        # batch_stats.<buffer> -> <buffer>, and each statistics owner's prefix
        self._buffer_of = {STATS + n: n for n, _ in self.module.named_buffers()}
        self._stat_owners = [
            (mod, f"{STATS}{name}.")
            for name, mod in self.module.named_modules()
            if any(True for _ in mod.buffers(recurse=False))
        ]
        self._takes_train = "train" in inspect.signature(self.module.forward).parameters

    def init(self, generator: torch.Generator) -> Variables:
        """Fresh float32 variables on the CPU, each parameter from its flax
        initializer (:func:`init_param_`), drawn in ``named_parameters``
        order from ``generator`` so a seed gives the same weights on every
        device; then the running statistics at their initial values."""
        out = {}
        for name, p in self.module.named_parameters():
            owner, _, leaf = name.rpartition(".")
            t = torch.empty(p.shape, dtype=torch.float32)
            init_param_(self.module.get_submodule(owner), leaf, t, generator)
            out[name] = t
        for name, b in self.module.named_buffers():
            out[STATS + name] = b.detach().float().clone()
        return out

    def apply(self, variables: Variables, x, train: bool = False, rng: Optional[torch.Generator] = None):
        """Returns (outputs, variables): in training, the variables carry the
        new running statistics. ``rng`` is the dropout generator of a
        training call; without one a model with dropout draws from a
        generator seeded 0, as the reference falls back to PRNGKey(0)."""
        tensors = {self._buffer_of.get(k, k): v for k, v in variables.items()}
        kwargs = {"train": train} if self._takes_train else {}
        if not (train and (self.has_dropout or self.has_batch_stats)):
            return torch.func.functional_call(self.module, tensors, (x,), kwargs), variables
        if rng is None and self.has_dropout:
            rng = torch.Generator(device=x.device).manual_seed(0)
        with _apply_scope(rng) as scope:
            out = torch.func.functional_call(self.module, tensors, (x,), kwargs)
        if not scope.new_stats:
            return out, variables
        new_vars = dict(variables)
        for mod, prefix in self._stat_owners:
            if mod in scope.new_stats:
                new_vars[prefix + "mean"], new_vars[prefix + "var"] = scope.new_stats[mod]
        return out, new_vars

    def num_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())


def split_stats(variables: Variables) -> Tuple[Variables, Variables]:
    """variables → (parameters, running statistics)."""
    params, stats = {}, {}
    for k, v in variables.items():
        (stats if k.startswith(STATS) else params)[k] = v
    return params, stats


def create_model(model_name: str, dataset_name: str, input_shape, num_classes, **kw) -> ModelDef:
    """Model-name × dataset → ModelDef dispatch."""
    from fedml_tpu_torch.models import registry

    return registry.create(model_name, dataset_name, input_shape, num_classes, **kw)
