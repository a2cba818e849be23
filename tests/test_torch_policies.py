"""The power-of-choice policy and overprovisioning
(``scheduler/policies.py``) against ``fedml_tpu.scheduler`` on the CPU:
the same population, sample counts and loss reports give the same cohort
ids round for round (exact), the overprovisioned cohort size is the
reference's, and the scheduler's checkpoint state round-trips into either
package and re-selects the same cohorts. Then the simulator: FedAvgAPI
under power_of_choice feeds each client's own loss to the scheduler and
selects the reference simulator's cohorts over 4 rounds (logistic
regression; the CNN's, on the card, in chip_smoke.py phase 16)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from fedml_tpu.scheduler import ClientScheduler as JaxScheduler  # noqa: E402
from fedml_tpu.scheduler import overprovisioned_k as jax_overprovisioned_k  # noqa: E402

from fedml_tpu_torch.scheduler import ClientScheduler, overprovisioned_k  # noqa: E402

from torch_parity import jax_round_perm_fn, private_reference_programs, share_init  # noqa: E402

ROUNDS = 12
# the simulator's per-client losses: the same float32 steps of a logistic
# regression summed in another order
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _pair(policy, factor, n=40, k=6, seed=3, counts=True):
    sizes = np.random.default_rng(seed).integers(0, 90, size=n) if counts else None
    kw = dict(num_clients=n, k=k, policy=policy, seed=seed, overprovision_factor=factor,
              sample_counts=sizes)
    return JaxScheduler(**kw), ClientScheduler(**kw)


def _drive(scheds, rounds=ROUNDS, loss_seed=11):
    """Select round by round, reporting the same (seeded) losses for the
    selected clients to every scheduler; returns each one's cohorts."""
    rng = np.random.default_rng(loss_seed)
    out = [[] for _ in scheds]
    for r in range(rounds):
        sels = [np.asarray(s.select(r)) for s in scheds]
        for got, sel in zip(out, sels):
            got.append(sel.tolist())
        losses = {int(c): float(v) for c, v in zip(sels[0], rng.random(len(sels[0])))}
        # ties: two clients share a loss now and then
        if len(losses) > 2:
            a, b = list(losses)[:2]
            losses[b] = losses[a]
        for s in scheds:
            for c, v in losses.items():
                s.report_loss(c, v)
    return out


@pytest.mark.parametrize("policy,factor", [
    ("power_of_choice", 1.0), ("power_of_choice", 1.4), ("uniform", 1.4), ("weighted", 1.4),
    ("power_of_choice", 2.5),
])
@pytest.mark.parametrize("counts", [True, False])
def test_cohorts_equal_the_reference_over_rounds(policy, factor, counts):
    jax_s, port_s = _pair(policy, factor, counts=counts)
    want, got = _drive([jax_s, port_s])
    assert got == want
    k = overprovisioned_k(6, factor, 40)
    assert k == jax_overprovisioned_k(6, factor, 40) == port_s.cohort_size() == jax_s.cohort_size()
    assert all(len(c) == k and len(set(c)) == k for c in got)
    assert port_s.wants_client_losses == jax_s.wants_client_losses == (policy == "power_of_choice")


def test_power_of_choice_prefers_the_highest_known_losses():
    _, port_s = _pair("power_of_choice", 1.0, n=20, k=4)
    for c in range(20):
        port_s.report_loss(c, float(c))
    for r in range(5):
        # d = 8 candidates; the 4 with the highest losses are the top 4 ids
        # among them
        sel = port_s.select(r)
        from fedml_tpu_torch.scheduler.policies import _rng, _size_probs, _weighted_draw

        cands = _weighted_draw(_rng(port_s._ctx, r, salt=2), 20, 8, _size_probs(port_s._ctx))
        assert sorted(sel.tolist()) == sorted(sorted(cands.tolist())[-4:])


@pytest.mark.parametrize("factor", [1.0, 1.4])
def test_state_dict_round_trips_across_the_packages(factor):
    jax_s, port_s = _pair("power_of_choice", factor)
    _drive([jax_s, port_s], rounds=5)
    for src, dst_cls in ((port_s, JaxScheduler), (jax_s, ClientScheduler)):
        state = src.state_dict()
        dst = dst_cls(num_clients=40, k=6, policy="power_of_choice", seed=3,
                      overprovision_factor=factor, sample_counts=src._ctx.sample_counts)
        dst.load_state_dict(state)
        for key in ("rounds", "loss_ids", "loss_vals"):
            np.testing.assert_array_equal(dst.state_dict()[key], state[key])
        # the memo re-selects what was selected, and the next round follows
        # from the restored loss map alike
        assert [dst.select(r).tolist() for r in range(6)] == \
               [src.select(r).tolist() for r in range(6)]


def test_overprovision_below_one_and_unknown_policies_are_refused():
    from fedml_tpu_torch.scheduler import make_policy

    with pytest.raises(ValueError, match="overprovision factor must be >= 1.0"):
        make_policy("uniform", 0.5)
    with pytest.raises(ValueError, match="candidate_factor must be >= 1.0"):
        make_policy("power_of_choice", candidate_factor=0.5)
    with pytest.raises(ValueError, match="unknown selection policy"):
        make_policy("no_such_policy")
    # straggler_aware at the population tier's threshold is no refusal: it
    # rejection-samples the reference's cohort
    from fedml_tpu.scheduler.policies import SelectionContext as JaxContext
    from fedml_tpu.scheduler.policies import get_policy

    from fedml_tpu_torch.scheduler.policies import SelectionContext

    got = make_policy("straggler_aware").select(0, 2, SelectionContext(num_clients=8,
                                                                       ocohort_threshold=8))
    want = get_policy("straggler_aware").select(0, 2, JaxContext(num_clients=8, ocohort_threshold=8))
    assert got.tolist() == np.asarray(want).tolist()


def test_simulator_power_of_choice_selects_the_reference_cohorts():
    """FedAvgAPI on logistic regression over 12 synthetic non-IID clients,
    power_of_choice with overprovisioning 1.5 (5 of 12 a round), batch 16,
    4 rounds, from the reference's init with its shuffles: every round's
    cohort equals the reference simulator's (the round's per-client losses
    feed the next selection), and each client's reported loss is within
    LOSS_RTOL."""
    import fedml_tpu.config as jcfg
    from fedml_tpu.algorithms import FedAvgAPI as JaxFedAvg
    from fedml_tpu.data.synthetic import synthetic_classification as jax_synthetic
    from fedml_tpu.models import create_model as jax_create_model

    import fedml_tpu_torch.config as tcfg
    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.data.synthetic import synthetic_classification
    from fedml_tpu_torch.models import create_model

    def cfg(mod):
        return mod.RunConfig(
            data=mod.DataConfig(batch_size=16),
            fed=mod.FedConfig(client_num_in_total=12, client_num_per_round=3, comm_round=4,
                              selection="power_of_choice", overprovision_factor=1.5),
            train=mod.TrainConfig(lr=0.1), seed=0,
        )

    data_kw = dict(num_clients=12, num_classes=4, feat_shape=(6,), samples_per_client=30,
                   partition_method="hetero", seed=3)
    jrows, trows = [], []
    japi = JaxFedAvg(cfg(jcfg), jax_synthetic(**data_kw),
                     jax_create_model("lr", "synthetic", (6,), 4), log_fn=jrows.append)
    tapi = FedAvgAPI(cfg(tcfg), synthetic_classification(**data_kw),
                     create_model("lr", "synthetic", (6,), 4), device="cpu",
                     log_fn=trows.append, perm_fn=jax_round_perm_fn(0, 5))
    share_init(japi, tapi)
    japi.train()
    tapi.train()
    sel = lambda rows: {r["round"]: r["scheduler/selected"] for r in rows  # noqa: E731
                        if "scheduler/selected" in r}
    assert sel(trows) == sel(jrows) and len(sel(trows)) == 4
    assert all(len(c) == 5 for c in sel(trows).values())
    assert len({tuple(sorted(c)) for c in sel(trows).values()}) > 1
    want, got = japi.scheduler.state_dict(), tapi.scheduler.state_dict()
    np.testing.assert_array_equal(got["loss_ids"], want["loss_ids"])
    np.testing.assert_allclose(got["loss_vals"], want["loss_vals"], rtol=LOSS_RTOL)
    assert tapi._client_loss_rounds == set(range(4))
