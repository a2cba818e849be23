"""Model registry: model-name × dataset → ModelDef (port of
``fedml_tpu/models/registry.py``).

Ported: ``lr``, ``cnn``, ``cnn_dropout``, ``rnn`` (the dataset picks the
variant: ``RNNStackOverFlow`` for ``stackoverflow``/``stackoverflow_nwp``,
else ``RNNOriginalFedAvg``, per-position for ``fed_shakespeare``),
``transformer``, ``resnet56``, ``resnet110``, ``resnet18_gn`` …
``resnet152_gn``, ``mobilenet``, ``mobilenet_v3``, ``vgg11`` … ``vgg19``
and their ``_bn`` forms, ``efficientnet`` (options ``variant`` b0–b7 and
``drop_connect_rate``), ``segnet`` (FedSeg's encoder-decoder), ``darts``
(FedNAS's search network) and ``mnistgan`` (FedGAN's G + D), each with
the reference's ``has_batch_stats`` and ``has_dropout``; ``pretrained=``
pours a ``.pth`` or ``.npz`` checkpoint over the init
(models/pretrained.py). A name the reference does not know either
(``gkt_resnet``, ``vfl``: their algorithms build them) is a KeyError, as
there."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from fedml_tpu_torch.models import ModelDef

_VGG = ("vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn")
_RESNET_GN = ("resnet18_gn", "resnet34_gn", "resnet50_gn", "resnet101_gn", "resnet152_gn")


def _no_options(name: str, kw: dict) -> None:
    if kw:
        raise TypeError(f"the {name} model takes no options; got {sorted(kw)}")


def create(
    model_name: str,
    dataset_name: str,
    input_shape: Tuple[int, ...],
    num_classes: int,
    pretrained: str | None = None,
    **kw,
) -> ModelDef:
    name = model_name.lower()
    shape = tuple(input_shape)
    if pretrained is not None:
        # the reference's resnet56(pretrained=True, path=...): build the
        # model, then pour the checkpoint over its init
        return _with_pretrained(create(model_name, dataset_name, shape, num_classes, **kw),
                                pretrained)
    if name == "lr":
        _no_options(name, kw)
        from fedml_tpu_torch.models.linear import LogisticRegression

        return ModelDef(LogisticRegression(num_classes=num_classes, input_shape=shape),
                        shape, num_classes, name="lr")
    if name == "cnn":
        _no_options(name, kw)
        from fedml_tpu_torch.models.cnn import CNNOriginalFedAvg

        return ModelDef(CNNOriginalFedAvg(num_classes=num_classes, input_shape=shape),
                        shape, num_classes, name="cnn")
    if name == "cnn_dropout":
        from fedml_tpu_torch.models.cnn import CNNDropOut

        return ModelDef(CNNDropOut(num_classes=num_classes, input_shape=shape, **kw),
                        shape, num_classes, has_dropout=True, name=name)
    if name == "rnn":
        # the dataset picks the variant; num_classes is the model's own
        # vocabulary, as in the reference
        from fedml_tpu_torch.models import rnn

        ds = dataset_name.lower()
        if ds in ("stackoverflow_nwp", "stackoverflow"):
            m = rnn.RNNStackOverFlow(**kw)
            return ModelDef(m, shape, m.vocab_size + 3 + m.num_oov_buckets,
                            name="rnn_stackoverflow", input_dtype=torch.int32)
        m = rnn.RNNOriginalFedAvg(seq_output=ds == "fed_shakespeare", **kw)
        return ModelDef(m, shape, m.vocab_size, name="rnn", input_dtype=torch.int32)
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
        kw.setdefault("max_len", int(shape[0]))
        return ModelDef(TransformerLM(vocab_size=num_classes, **kw),
                        shape, num_classes, name="transformer", input_dtype=torch.int32)
    in_ch = int(shape[-1])
    if name in ("resnet56", "resnet110"):
        _no_options(name, kw)
        from fedml_tpu_torch.models import resnet

        return ModelDef(getattr(resnet, name)(num_classes, in_ch=in_ch),
                        shape, num_classes, has_batch_stats=True, name=name)
    if name in _RESNET_GN:
        from fedml_tpu_torch.models import resnet_gn

        ctor = getattr(resnet_gn, name[: -len("_gn")])
        cpg = kw.pop("channels_per_group", 2)
        return ModelDef(ctor(num_classes, channels_per_group=cpg, in_ch=in_ch, **kw),
                        shape, num_classes, has_batch_stats=(cpg == 0), name=name)
    if name == "mobilenet":
        from fedml_tpu_torch.models.mobilenet import MobileNet

        return ModelDef(MobileNet(num_classes=num_classes, in_ch=in_ch, **kw),
                        shape, num_classes, has_batch_stats=True, name=name)
    if name == "mobilenet_v3":
        from fedml_tpu_torch.models.mobilenet import MobileNetV3

        return ModelDef(MobileNetV3(num_classes=num_classes, in_ch=in_ch, **kw),
                        shape, num_classes, has_batch_stats=True, has_dropout=True, name=name)
    if name in _VGG:
        _no_options(name, kw)
        from fedml_tpu_torch.models.vgg import vgg

        bn = name.endswith("_bn")
        return ModelDef(vgg(name[:-3] if bn else name, num_classes, batch_norm=bn, in_ch=in_ch),
                        shape, num_classes, has_batch_stats=bn, has_dropout=True, name=name)
    if name == "efficientnet":
        from fedml_tpu_torch.models.efficientnet import EfficientNet

        return ModelDef(EfficientNet(num_classes=num_classes, in_ch=in_ch, **kw),
                        shape, num_classes, has_batch_stats=True, has_dropout=True, name=name)
    if name == "segnet":
        from fedml_tpu_torch.models.segnet import EncoderDecoder

        return ModelDef(EncoderDecoder(num_classes=num_classes, in_ch=in_ch, **kw),
                        shape, num_classes, has_batch_stats=True, name=name)
    if name == "darts":
        from fedml_tpu_torch.models.darts import DARTSNetwork

        return ModelDef(DARTSNetwork(num_classes=num_classes, in_ch=in_ch, **kw),
                        shape, num_classes, has_batch_stats=True, name=name)
    if name == "mnistgan":
        from fedml_tpu_torch.algorithms.fedgan import make_gan_model_def

        return make_gan_model_def(**kw)
    raise KeyError(
        f"unknown model {model_name!r}; available: lr, cnn, cnn_dropout, rnn, transformer, "
        "resnet56, resnet110, resnet18_gn..resnet152_gn, mobilenet, mobilenet_v3, "
        "vgg11..vgg19(_bn), efficientnet, segnet, darts, mnistgan"
    )


def _with_pretrained(model: ModelDef, path: str) -> ModelDef:
    """``model`` whose ``init`` returns the checkpoint's weights: ``.pth``
    through the torch-checkpoint importer, ``.npz`` through the
    save_pretrained recipe (models/pretrained.py)."""
    from fedml_tpu_torch.models import pretrained as P

    inner_init = model.init

    def init(generator):
        template = inner_init(generator)
        if str(path).endswith(".pth"):
            return P.load_torch_checkpoint(str(path), template)
        return P.load_pretrained(str(path), template)

    loaded = dataclasses.replace(model)
    loaded.init = init  # type: ignore[method-assign]
    return loaded
