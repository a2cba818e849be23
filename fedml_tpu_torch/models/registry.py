"""Model registry: model-name × dataset → ModelDef (port of
``fedml_tpu/models/registry.py``; ``lr``, ``cnn`` and ``transformer`` are
ported so far)."""

from __future__ import annotations

from typing import Tuple

import torch

from fedml_tpu_torch.models import ModelDef


def create(
    model_name: str,
    dataset_name: str,
    input_shape: Tuple[int, ...],
    num_classes: int,
    **kw,
) -> ModelDef:
    name = model_name.lower()
    if name == "lr":
        if kw:
            raise TypeError(f"the lr model takes no options; got {sorted(kw)}")
        from fedml_tpu_torch.models.linear import LogisticRegression

        return ModelDef(
            LogisticRegression(num_classes=num_classes, input_shape=tuple(input_shape)),
            tuple(input_shape), num_classes, name="lr",
        )
    if name == "cnn":
        if kw:
            raise TypeError(f"the cnn model takes no options; got {sorted(kw)}")
        from fedml_tpu_torch.models.cnn import CNNOriginalFedAvg

        return ModelDef(
            CNNOriginalFedAvg(num_classes=num_classes, input_shape=tuple(input_shape)),
            tuple(input_shape), num_classes, name="cnn",
        )
    if name == "transformer":
        # the federated causal LM: num_classes is the vocabulary; it trains
        # under task="nwp". Options (num_layers, num_heads, embed_dim,
        # max_len, attn_fn) go to TransformerLM; max_len defaults to the
        # window length.
        from fedml_tpu_torch.models.transformer import TransformerLM

        if kw.get("moe_experts"):
            raise ValueError(
                "MoE transformers return (logits, aux) and train through "
                "expert parallelism, not the federated ModelDef path"
            )
        kw.setdefault("max_len", int(input_shape[0]))
        return ModelDef(
            TransformerLM(vocab_size=num_classes, **kw),
            tuple(input_shape), num_classes, name="transformer", input_dtype=torch.int32,
        )
    raise NotImplementedError(
        f"model {model_name!r} is not ported yet (ROADMAP.md); the port has: lr, cnn, transformer"
    )
