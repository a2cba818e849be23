"""Rank-selection kernel K1 for the Byzantine-robust aggregators (port of
``fedml_tpu/ops/robust_stats.py``).

Coordinate-wise median and trimmed mean reduce a [C, D] stack of client
updates along the small client axis (C = cohort) independently per
coordinate (D = flattened model, millions). No sort is needed: per
coordinate only *which* values survive the trim window matters, and a
value's stable rank in a C-element column is a comparison count:

    rank_i = #{j : x_j < x_i} + #{j < i : x_j == x_i}
    out    = sum over i in index order of (k <= rank_i < C - k ? x_i : 0) / (C - 2k)

The stable tie-break keeps exactly the multiset a stable sort's
``s[k : C-k]`` window keeps. Median is the same at ``k = (C-1)//2`` (odd
C) or ``C//2 - 1`` (even C: the mean of the two middle values).

Three versions of one function:

- the CUDA kernels ``csrc/robust_stats.cu`` (Hopper, ``sm_90a``), launched
  by :func:`trimmed_mean_1d` for a CUDA tensor: these ranks for C <= 16;
  above, the two order statistics that bound the kept window found by radix
  select, then the same index-order sum;
- :func:`trimmed_mean_plain`, the same stable-rank compare-accumulate in
  PyTorch, vectorised over D, in the same order — bit-identical to the
  kernel; :func:`trimmed_mean_1d` uses it for a CPU tensor;
- :func:`trimmed_mean_sort`, the sort-based definition, for the tests.

``LAUNCHES`` counts kernel launches (only the CUDA branch of
:func:`trimmed_mean_1d` adds to it), so a run can show that it went
through the kernel."""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from fedml_tpu_torch.ops._build import count_launch, load_kernel_library

KERNEL_NAME = "robust_stats.trimmed_mean"
LAUNCHES: Dict[str, int] = {KERNEL_NAME: 0}


def _check(C: int, trim_k: int) -> None:
    if trim_k < 0 or 2 * trim_k >= C:
        raise ValueError(f"need 0 <= trim_k < C/2; got trim_k={trim_k}, C={C}")


def trimmed_mean_plain(x: torch.Tensor, trim_k: int) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, on x [C, D] fp32 on any device:
    stable ranks by comparison counts, kept values added in index order
    (0 added for a dropped one), one true division at the end."""
    C = x.shape[0]
    acc = torch.zeros(x.shape[1:], dtype=torch.float32, device=x.device)
    for i in range(C):
        xi = x[i]
        rank = (x[:i] <= xi).sum(dim=0) + (x[i + 1 :] < xi).sum(dim=0)
        keep = (rank >= trim_k) & (rank < C - trim_k)
        acc = acc + torch.where(keep, xi, torch.zeros_like(xi))
    # divide by a full tensor: a Python-scalar divisor may be turned into a
    # multiply by its reciprocal, which is not the kernel's IEEE division
    return acc / torch.full_like(acc, float(C - 2 * trim_k))


def trimmed_mean_sort(x: torch.Tensor, trim_k: int) -> torch.Tensor:
    """The definition: sort each column, average the ``s[k:C-k]`` window
    (its sum over a true division, so integer-valued inputs give the exact
    mean on every device: a CUDA ``mean`` multiplies by 1/n)."""
    C = x.shape[0]
    s = torch.sort(x.float(), dim=0).values[trim_k : C - trim_k].sum(dim=0)
    return s / torch.full_like(s, float(C - 2 * trim_k))


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind K1's C entry points."""
    lib = load_kernel_library("robust_stats")
    I = ctypes.c_int
    lib.fedml_trimmed_mean_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, I, ctypes.c_longlong, I, I, ctypes.c_void_p,
    ]
    lib.fedml_robust_stats_kernel_info.argtypes = [I, ctypes.POINTER(I)]
    for fn in (lib.fedml_trimmed_mean_f32, lib.fedml_robust_stats_kernel_info):
        fn.restype = I
    return lib


def kernel_info(C: int) -> Dict[str, int]:
    """The kernel that takes a cohort of C (the column in registers for
    C <= 16; above, the radix select of the column's two bounds, the column
    held in a shared-memory tile, or read from device memory where the tile
    would not fit) and what the compiler made of it: threads a
    block, registers and local-memory bytes a thread (spills land there),
    dynamic shared memory a block, and the blocks one SM holds at once."""
    out = (ctypes.c_int * 5)()
    err = _lib().fedml_robust_stats_kernel_info(C, out)
    if err != 0:
        raise RuntimeError(f"K1: no kernel info for C={C}: cudaError {err}")
    keys = ("threads", "registers", "local_bytes", "smem_bytes", "blocks_per_sm")
    return dict(zip(keys, out))


def _launch(x: torch.Tensor, trim_k: int) -> torch.Tensor:
    C, D = x.shape
    out = torch.empty(D, dtype=torch.float32, device=x.device)
    if D == 0:
        return out
    fn = _lib().fedml_trimmed_mean_f32
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), C, D, trim_k, sms, stream)
    if err != 0:
        raise RuntimeError(f"K1 trimmed_mean kernel launch failed: cudaError {err}")
    count_launch(LAUNCHES, KERNEL_NAME)
    return out


def trimmed_mean_1d(x: torch.Tensor, trim_k: int) -> torch.Tensor:
    """Per-coordinate trimmed mean of x [C, D] over axis 0: drop the
    ``trim_k`` largest and smallest values per coordinate, average the
    rest. Output [D] float32. Runs the CUDA kernel for a CUDA tensor and
    the plain version for a CPU tensor; nothing else."""
    C = x.shape[0]
    _check(C, trim_k)
    x = x.float().contiguous()
    if x.is_cuda:
        return _launch(x, trim_k)
    if x.device.type == "cpu":
        return trimmed_mean_plain(x, trim_k)
    raise ValueError(f"trimmed_mean_1d: unsupported device {x.device}")


def median_trim_k(C: int) -> int:
    """The trim window that makes :func:`trimmed_mean_1d` the median: keep
    the middle value (odd C) or average the two middle values (even C)."""
    return (C - 1) // 2 if C % 2 else C // 2 - 1


def median_1d(x: torch.Tensor) -> torch.Tensor:
    """Per-coordinate median of x [C, D] over axis 0."""
    C = x.shape[0]
    if C == 1:
        return x.float()[0]
    return trimmed_mean_1d(x, median_trim_k(C))
