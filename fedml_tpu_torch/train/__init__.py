"""Client training, optimizers, losses and evaluation (port of
``fedml_tpu/train/``)."""
