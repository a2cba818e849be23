"""Device resolution and the fp32 math policy.

Entry points take an explicit ``device``. ``None`` means the card: the port
is written for one H100 and never drops to the CPU on its own — a caller
that wants the CPU (the tests, a parity check) says so."""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; raise ``RuntimeError`` when CUDA is asked for
    and there is no card (no silent CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fedml_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


_FP32_LOCK = threading.Lock()
_fp32_depth = 0
_fp32_saved = (True, False)


@contextlib.contextmanager
def fp32_math() -> Iterator[None]:
    """Within the block, float32 convolutions and matmuls run in full
    float32: cuDNN's TF32 (PyTorch's default for convolutions) and cuBLAS
    TF32 are switched off, then restored. TF32 keeps ~3 decimal digits,
    which would make "float32" on the card a different computation from
    float32 on the CPU and in the JAX reference. bfloat16 products (mixed
    precision) are not affected. No effect on the CPU.

    The switches are process-wide, and the transport's client actors enter
    this block from several threads at once: the first entry saves and
    clears them, the last exit restores them, so no thread's exit turns
    TF32 back on under another that is still inside."""
    global _fp32_depth, _fp32_saved
    with _FP32_LOCK:
        if _fp32_depth == 0:
            _fp32_saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _fp32_depth += 1
    try:
        yield
    finally:
        with _FP32_LOCK:
            _fp32_depth -= 1
            if _fp32_depth == 0:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = _fp32_saved
