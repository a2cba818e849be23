"""The port's RobustFedAvgAPI against the reference's on the CPU: three
rounds of the FedAvg slice from the same init with the same shuffles, for
the coordinate-wise median, the trimmed mean (one client trimmed from each
end) and norm-difference clipping. On the CPU the port's median and trimmed
mean run K1's plain version; the reference runs its sort path."""

import pytest

pytest.importorskip("jax")

from torch_parity import assert_slice_close, run_slice  # noqa: E402


@pytest.mark.parametrize(
    "robust",
    [
        {"defense_type": "median"},
        {"defense_type": "trimmed_mean", "num_byzantine": 1},
        {"defense_type": "norm_diff_clipping", "norm_bound": 0.5},
    ],
    ids=lambda r: r["defense_type"],
)
def test_robust_fedavg_three_rounds_match_reference(robust):
    japi, tapi = run_slice(robust)
    assert_slice_close(japi, tapi)
