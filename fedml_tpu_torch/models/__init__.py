"""Model surface of the port (counterpart of ``fedml_tpu/models/__init__.py``).

Every model is wrapped in a :class:`ModelDef` giving the framework a
functional surface like the reference's: ``init(generator) -> variables``
and ``apply(variables, x, train) -> (outputs, variables)``. ``variables`` is
a plain ``{name: tensor}`` dict keyed like the module's ``state_dict``; the
``nn.Module`` itself only describes the computation
(``torch.func.functional_call``), so the federated loop can hold, stack and
average many copies of the weights without many modules.

Inputs keep the reference's layout (NHWC images, integer token windows),
so the two packages are fed the same arrays."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

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
    ``normal_init_std`` entry for ``leaf`` if it has one, else by name —
    dense/conv ``weight``: lecun_normal; ``bias``: zeros; norm ``scale``:
    ones; ``embedding`` [V, C]: flax's ``default_embed_init``, an
    untruncated normal of std 1/√C."""
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


@dataclasses.dataclass
class ModelDef:
    module: nn.Module
    input_shape: Tuple[int, ...]  # per-example shape (no batch dim), NHWC
    num_classes: int
    name: str = "model"
    input_dtype: torch.dtype = torch.float32  # torch.int32 for token models

    def init(self, generator: torch.Generator) -> Variables:
        """Fresh float32 variables on the CPU, each from its flax
        initializer (:func:`init_param_`). Drawn in ``named_parameters``
        order from ``generator``, so a seed gives the same weights on
        every device."""
        out = {}
        for name, p in self.module.named_parameters():
            owner, _, leaf = name.rpartition(".")
            t = torch.empty(p.shape, dtype=torch.float32)
            init_param_(self.module.get_submodule(owner), leaf, t, generator)
            out[name] = t
        return out

    def apply(self, variables: Variables, x, train: bool = False, rng=None):
        """Returns (outputs, variables). ``train``/``rng`` are accepted for
        the reference's signature; the ported models have neither dropout
        nor batch statistics yet."""
        del train, rng
        out = torch.func.functional_call(self.module, variables, (x,))
        return out, variables

    def num_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())


def create_model(model_name: str, dataset_name: str, input_shape, num_classes, **kw) -> ModelDef:
    """Model-name × dataset → ModelDef dispatch."""
    from fedml_tpu_torch.models import registry

    return registry.create(model_name, dataset_name, input_shape, num_classes, **kw)
