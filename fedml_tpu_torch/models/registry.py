"""Model registry: model-name × dataset → ModelDef (port of
``fedml_tpu/models/registry.py``; only ``cnn`` is ported so far)."""

from __future__ import annotations

from typing import Tuple

from fedml_tpu_torch.models import ModelDef


def create(
    model_name: str,
    dataset_name: str,
    input_shape: Tuple[int, ...],
    num_classes: int,
    **kw,
) -> ModelDef:
    name = model_name.lower()
    if kw:
        raise NotImplementedError(
            f"create_model options {sorted(kw)} are not ported yet (ROADMAP.md)"
        )
    if name == "cnn":
        from fedml_tpu_torch.models.cnn import CNNOriginalFedAvg

        return ModelDef(
            CNNOriginalFedAvg(num_classes=num_classes, input_shape=tuple(input_shape)),
            tuple(input_shape), num_classes, name="cnn",
        )
    raise NotImplementedError(
        f"model {model_name!r} is not ported yet (ROADMAP.md); the port has: cnn"
    )
