"""The port's decentralized pieces against the reference's on the CPU: the
topology managers' mixing matrices and neighbor lists, DSGD and push-sum
over a symmetric and a directed topology (per-iteration losses, regret and
final params), and the base framework's central sum and loopback gossip.

Tolerances: the matrices exactly (the same float32 numpy arithmetic); the
runs rtol 1e-5, atol 1e-6 (60 float32 SGD steps and mixings in another
library); the central sum exactly; the gossip values to float64 rounding
(the same mixing order on both sides). Tests that start loopback actors
run under ``time_limit``."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from fedml_tpu.algorithms import base_framework as jbase  # noqa: E402
from fedml_tpu.algorithms.decentralized import DecentralizedAPI as JaxDecentralized  # noqa: E402
from fedml_tpu.models import ModelDef as JaxModelDef  # noqa: E402
from fedml_tpu.models.linear import LogisticRegression as JaxLR  # noqa: E402
from fedml_tpu.partition import topology as jtopo  # noqa: E402

from fedml_tpu_torch.algorithms import base_framework as tbase  # noqa: E402
from fedml_tpu_torch.algorithms.decentralized import DecentralizedAPI  # noqa: E402
from fedml_tpu_torch.bridge import from_flax, to_flax  # noqa: E402
from fedml_tpu_torch.core.loopback import LoopbackCommManager, LoopbackHub  # noqa: E402
from fedml_tpu_torch.models import create_model  # noqa: E402
from fedml_tpu_torch.partition import AsymmetricTopologyManager, SymmetricTopologyManager  # noqa: E402

from torch_parity import flat_params, private_reference_programs, time_limit  # noqa: E402

N, T, D = 8, 60, 6


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _topologies(n):
    out = {}
    for k in (2, 3, 4, n - 1):
        ref, port = jtopo.SymmetricTopologyManager(n, k), SymmetricTopologyManager(n, k)
        out[f"symmetric{k}"] = (ref, port)
    for seed in (0, 5):
        ref = jtopo.AsymmetricTopologyManager(n, 3, 3, seed=seed)
        out[f"directed{seed}"] = (ref, AsymmetricTopologyManager(n, 3, 3, seed=seed))
    for ref, port in out.values():
        ref.generate_topology()
        port.generate_topology()
    return out


@pytest.mark.parametrize("n", [5, 8, 13])
def test_topologies_match_reference(n):
    for name, (ref, port) in _topologies(n).items():
        assert np.array_equal(port.topology, ref.topology), name
        for i in range(n):
            assert port.get_in_neighbor_idx_list(i) == ref.get_in_neighbor_idx_list(i)
            assert port.get_out_neighbor_idx_list(i) == ref.get_out_neighbor_idx_list(i)
            assert np.array_equal(port.get_in_neighbor_weights(i), ref.get_in_neighbor_weights(i))


@pytest.mark.parametrize("variant,topo", [("dsgd", "symmetric4"), ("pushsum", "directed5"),
                                          ("dsgd", "directed0")])
def test_run_matches_reference(variant, topo):
    ref_topo, port_topo = _topologies(N)[topo]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(N, T, D)).astype(np.float32)
    y = (rng.uniform(size=(N, T)) < 0.5).astype(np.float32)
    ref = JaxDecentralized(JaxModelDef(JaxLR(num_classes=1), (D,), 1, name="lr"), ref_topo,
                           lr=0.1, wd=1e-3, variant=variant, seed=0)
    port = DecentralizedAPI(create_model("lr", "synthetic", (D,), 1), port_topo, lr=0.1, wd=1e-3,
                            variant=variant, seed=0, device="cpu")
    port.params = from_flax(jax.device_get(ref.params), 1)
    want, got = ref.run(x, y), port.run(x, y)
    for key in ("losses", "regret"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)
    assert got["regret"][-1] < got["regret"][0]
    w, g = flat_params(jax.device_get(ref.params)), flat_params(to_flax(port.params, 1))
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6, err_msg=k)


@time_limit(30)
def test_base_framework_sums_as_the_reference():
    values = [1.5, -2.25, 4.0, 0.125]
    assert tbase.run_base_framework(values) == jbase.run_base_framework(values) == sum(values)


def _gossip(base, hub, comm_cls, topo, values, rounds):
    import threading

    workers = [base.DecentralizedWorkerManager(comm_cls(hub, r), r, topo, values[r], rounds)
               for r in range(len(values))]
    threads = [threading.Thread(target=w.run, daemon=True) for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return np.stack([w.value for w in workers])


@time_limit(60)
def test_gossip_matches_reference_and_the_matrix_power():
    from fedml_tpu.core.loopback import LoopbackCommManager as JaxLoopback
    from fedml_tpu.core.loopback import LoopbackHub as JaxHub

    ref_topo, port_topo = _topologies(6)["symmetric2"]
    values = np.random.default_rng(2).normal(size=(6, 3))
    rounds = 4
    got = _gossip(tbase, LoopbackHub(), LoopbackCommManager, port_topo, values, rounds)
    want = _gossip(jbase, JaxHub(), JaxLoopback, ref_topo, values, rounds)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    W = port_topo.topology.astype(np.float64)
    np.testing.assert_allclose(got, np.linalg.matrix_power(W, rounds) @ values, rtol=1e-6)
    assert torch.from_numpy(got).isfinite().all()
