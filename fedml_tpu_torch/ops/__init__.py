"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (port of ``fedml_tpu/ops/``): K1 (robust_stats) and the flash
attention forward and backward K2–K4 (flash_attention); plus the
custom-gradient LayerNorm ``ln_act`` (fused_groupnorm), plain torch ops as
in the reference."""
