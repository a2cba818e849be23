"""fedml_tpu_torch — the PyTorch/CUDA port of ``fedml_tpu`` for one NVIDIA
H100.

The JAX package ``fedml_tpu`` is the reference: this package mirrors its
module paths and public names (``FedAvgAPI``, ``RobustFedAvgAPI``,
``make_local_train``, ``trimmed_mean_1d``, …) so each counterpart is easy
to find, and tests/test_torch_*.py hold the two against each other on the
same inputs. It imports ``torch`` and ``numpy`` only — never ``jax`` nor any
module of ``fedml_tpu``; what it needs from the reference's jax-free
modules it keeps as its own copy.

Entry points run on the card unless the caller passes ``device="cpu"``
(:func:`fedml_tpu_torch.device.resolve_device`). Every TPU (Pallas) kernel
on a ported path has a hand-written Hopper kernel under ``ops/csrc/``,
built at first use; importing this package builds nothing.

Like the reference's ``__init__``, this module imports nothing."""
