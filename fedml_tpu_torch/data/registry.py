"""Dataset registry: name → FederatedDataset loader (port of
``fedml_tpu/data/registry.py``).

Ported: the synthetic datasets (``synthetic``, ``synthetic_<a>_<b>``,
``femnist_synth``, ``shakespeare_synth``, ``shakespeare_synth_lm``,
``seg_synth``), the
LEAF and TFF-h5 file loaders (``mnist``, ``shakespeare``, ``femnist``,
``fed_shakespeare``, ``fed_cifar100``, ``stackoverflow_lr``,
``stackoverflow_nwp``, ``imagenet`` in the ImageFolder layout,
``landmarks`` from its CSV mappings) and the centralised image sets with
their LDA/homo split (``cifar10``, ``cifar100``, ``cinic10``)."""

from __future__ import annotations

import importlib

from fedml_tpu_torch.data.base import FederatedDataset

# dataset → training task (selects the loss and metrics)
TASKS = {
    "mnist": "classification",
    "femnist": "classification",
    "femnist_synth": "classification",
    "shakespeare_synth": "classification",  # next-char from 80-char window
    "shakespeare_synth_lm": "nwp",  # per-position next-char (transformer LM)
    "shakespeare": "classification",  # next-char from 80-char window
    "fed_shakespeare": "nwp",
    "fed_cifar100": "classification",
    "cifar10": "classification",
    "cifar100": "classification",
    "cinic10": "classification",
    "stackoverflow_lr": "tag",
    "stackoverflow_nwp": "nwp",
    "synthetic": "classification",
    "seg_synth": "segmentation",
    "imagenet": "classification",
    "landmarks": "classification",
}

# datasets read from files on disk: name -> (module, loader); every loader
# takes (data_dir, max_clients=...)
_FILE_LOADERS = {
    "mnist": ("fedml_tpu_torch.data.leaf", "load_mnist"),
    "femnist": ("fedml_tpu_torch.data.tff_h5", "load_femnist"),
    "shakespeare": ("fedml_tpu_torch.data.leaf", "load_shakespeare"),
    "fed_shakespeare": ("fedml_tpu_torch.data.tff_h5", "load_fed_shakespeare"),
    "fed_cifar100": ("fedml_tpu_torch.data.tff_h5", "load_fed_cifar100"),
    "stackoverflow_lr": ("fedml_tpu_torch.data.stackoverflow", "load_stackoverflow_lr"),
    "stackoverflow_nwp": ("fedml_tpu_torch.data.stackoverflow", "load_stackoverflow_nwp"),
    "imagenet": ("fedml_tpu_torch.data.imagenet", "load_imagenet"),
    "landmarks": ("fedml_tpu_torch.data.landmarks", "load_landmarks"),
}


def task_for_dataset(name: str) -> str:
    base = name.lower()
    if base.startswith("synthetic"):
        return "classification"
    return TASKS.get(base, "classification")


def load(config) -> FederatedDataset:
    """``config`` is a RunConfig (uses .data.*, .fed.client_num_in_total
    and .seed)."""
    d = config.data
    name = d.dataset.lower()
    n_clients = config.fed.client_num_in_total

    if name == "synthetic":
        from fedml_tpu_torch.data.synthetic import synthetic_classification

        return synthetic_classification(
            num_clients=n_clients,
            partition_method=d.partition_method,
            partition_alpha=d.partition_alpha,
            seed=config.seed,
        )
    if name.startswith("synthetic_"):
        # synthetic_<alpha>_<beta>, e.g. synthetic_1_1
        from fedml_tpu_torch.data.synthetic import synthetic_fedprox

        parts = name.split("_")
        alpha, beta = float(parts[1]), float(parts[2])
        return synthetic_fedprox(alpha=alpha, beta=beta, num_clients=n_clients, seed=config.seed)
    if name == "seg_synth":
        from fedml_tpu_torch.data.synthetic import synthetic_segmentation

        return synthetic_segmentation(num_clients=n_clients, seed=config.seed)
    if name == "femnist_synth":
        from fedml_tpu_torch.data.femnist_synth import femnist_synthetic

        return femnist_synthetic(num_clients=n_clients, seed=config.seed)
    if name in ("shakespeare_synth", "shakespeare_synth_lm"):
        from fedml_tpu_torch.data.synthetic import synthetic_shakespeare

        return synthetic_shakespeare(
            num_clients=n_clients, seed=config.seed, seq_targets=name.endswith("_lm")
        )
    if name in _FILE_LOADERS:
        mod_name, fn_name = _FILE_LOADERS[name]
        fn = getattr(importlib.import_module(mod_name), fn_name)
        return fn(d.data_dir, max_clients=n_clients or None)
    if name in ("cifar10", "cifar100", "cinic10"):
        from fedml_tpu_torch.data.cifar import load_cifar_family

        return load_cifar_family(
            name,
            d.data_dir,
            num_clients=n_clients,
            partition_method=d.partition_method,
            partition_alpha=d.partition_alpha,
            seed=config.seed,
        )
    available = ", ".join(
        ["synthetic", "synthetic_<a>_<b>", "femnist_synth", "shakespeare_synth",
         "shakespeare_synth_lm"] + sorted(_FILE_LOADERS) + ["cifar10", "cifar100", "cinic10"]
    )
    raise KeyError(f"unknown dataset {d.dataset!r}; available: {available}")
