"""Build and load the port's CUDA kernels at first use.

Each ``ops/csrc/<name>.cu`` has a plain C interface (no PyTorch headers, so
``nvcc`` takes seconds, not minutes). It is compiled for ``sm_90a`` by
``torch.utils.cpp_extension.load`` into ``ops/build/<name>/`` — listed in
.gitignore, rebuilt whenever the source changes — and its functions are
bound with ``ctypes``. Nothing is built when the package is imported:
only a wrapper called on a CUDA tensor gets here. A build failure raises;
there is no fallback to a plain version.

:func:`count_launch` is the one place a wrapper adds to its launch counter:
client actors of the cross-silo transport launch kernels from several
threads at once, and ``counts[name] += 1`` is a read-modify-write that a
thread switch can split, losing an increment."""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Hashable

_HERE = Path(__file__).resolve().parent
CSRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
_LAUNCH_LOCK = threading.Lock()


def count_launch(counts: Dict[Hashable, int], name: Hashable) -> None:
    """Add one launch of kernel ``name`` (a kernel's key in ``counts``) to
    ``counts``, atomically across threads."""
    with _LAUNCH_LOCK:
        counts[name] += 1


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing or stale, and load
    it. ``load`` serialises concurrent builds with a lock file in the build
    directory; callers bind the library once (functools.cache)."""
    from torch.utils.cpp_extension import load

    build_dir = BUILD_DIR / name
    build_dir.mkdir(parents=True, exist_ok=True)  # load does not create it
    path = load(
        name=f"fedml_tpu_torch_{name}",
        sources=[str(CSRC_DIR / f"{name}.cu")],
        build_directory=str(build_dir),
        extra_cuda_cflags=CUDA_FLAGS,
        is_python_module=False,
    )
    return ctypes.CDLL(path)
