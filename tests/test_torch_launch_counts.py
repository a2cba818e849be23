"""The kernel launch counters stay exact when several threads launch at
once, as the transport's client actors do: every wrapper adds to its
counter through ``ops._build.count_launch``, which holds a lock around the
read-modify-write."""

import sys
import threading

import pytest

from fedml_tpu_torch.ops import flash_attention as fa
from fedml_tpu_torch.ops import robust_stats as rs
from fedml_tpu_torch.ops._build import count_launch

THREADS, PER_THREAD = 8, 10_000


@pytest.mark.parametrize(
    "launches,name", [(rs.LAUNCHES, rs.KERNEL_NAME)] + [(fa.LAUNCHES, (n, "bfloat16")) for n in fa.KERNEL_NAMES],
    ids=[rs.KERNEL_NAME, *fa.KERNEL_NAMES],
)
def test_launch_count_is_exact_under_eight_threads(launches, name):
    saved = launches[name]
    launches[name] = 0
    barrier = threading.Barrier(THREADS)

    def work():
        barrier.wait()
        for _ in range(PER_THREAD):
            count_launch(launches, name)

    threads = [threading.Thread(target=work) for _ in range(THREADS)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the runtime allows
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert launches[name] == THREADS * PER_THREAD
    finally:
        sys.setswitchinterval(interval)
        launches[name] = saved
