"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (port of ``fedml_tpu/ops/``). K1 (robust_stats) is ported; the
flash-attention kernels K2–K4 are still to port (ROADMAP.md)."""
