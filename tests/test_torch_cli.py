"""``python -m fedml_tpu_torch`` against ``python -m fedml_tpu`` on the CPU.

(a) the parser knows every option of the reference's ``main`` with the
    same name, default, type and choices; (b) the reference's usage errors
    are usage errors (exit code 2), and what is not ported raises
    NotImplementedError naming ROADMAP.md; (c) from one checkpoint (the
    reference's init, written by the reference at round 0) both CLIs
    ``--resume`` for 3 rounds and write summary.json files with the same
    keys and values within ROW_TOL; (d) the port's kill-and-resume equals
    its uninterrupted run bit for bit; (e) a reference run of 2 rounds,
    resumed by the port for rounds 2-3, matches the reference's 4 straight
    rounds; DP-FedAvg, Krum and Multi-Krum, weak DP, the backdoor attack,
    power-of-choice, overprovisioning, fault plans, ``--eval_on_clients``,
    FedNova, q-FedAvg, hierarchical FedAvg, SCAFFOLD (device and mmap) and
    Ditto write the reference's rows, centralized and decentralized runs
    too (from the reference's init), and their usage errors are the
    reference's; (f) ``--selection weighted`` draws the reference's cohorts;
    (g) the entry point runs ``--help`` here and refuses to train without a
    card; (h) a loopback FedAdam run writes the reference's transport row
    keys. Besides: ``--enable_wandb`` names and feeds a wandb run as the
    reference does, and the CLI's north-star run equals the Python API's
    bit for bit.

The port's rounds take the reference's shuffles where the two are
compared: ``seeded_perm_fn``, the port's default shuffle source, is
patched to ``torch_parity.jax_round_perm_fn``."""

import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
click = pytest.importorskip("click")

from click.testing import CliRunner  # noqa: E402

from fedml_tpu import cli as jcli  # noqa: E402
from fedml_tpu.models import create_model as jax_create_model  # noqa: E402
from fedml_tpu.utils.checkpoint import load_checkpoint as jax_load  # noqa: E402
from fedml_tpu.utils.checkpoint import save_checkpoint as jax_save  # noqa: E402

import fedml_tpu_torch.__main__ as tmain  # noqa: E402
import fedml_tpu_torch.algorithms.ditto as tditto  # noqa: E402
import fedml_tpu_torch.algorithms.fedavg as tfedavg  # noqa: E402
from fedml_tpu_torch import cli as tcli  # noqa: E402
from fedml_tpu_torch.bridge import to_flax  # noqa: E402

from torch_parity import (  # noqa: E402
    flat_params, jax_ditto_personal_perm_fn, jax_noise_fn, jax_round_perm_fn,
    private_reference_programs, time_limit, torch_threads,
)

ROOT = Path(__file__).resolve().parents[1]
# |port - reference| <= ROW_TOL·max(1, |reference|) for every number of the
# rows: the same float32 steps, summed in another order by another
# library, over 3-4 rounds (measured: ≤ 5e-7 relative on these cases)
ROW_TOL = 1e-5
# summary.json keys only the reference writes, each with its reason:
# compile/* are its XLA program-cache counters (the port compiles nothing;
# its counterpart is ROADMAP.md §1 item 4), and fed/pipeline_rounds counts
# rounds its round pipeline prepared ahead (the port runs every --pipeline
# value serially; the reference's pipeline is byte-identical to serial)
REFERENCE_ONLY_PREFIXES = ("compile/", "fed/pipeline_rounds")
LR = ["--model", "lr", "--dataset", "synthetic"]
# the CNN slice on synthetic_classification's ten 64-sample clients: the
# registry's femnist_synth has ~226 samples a client, whose batch-20 rounds
# are chaotic (the two packages' last-bit differences reach ~1e-3 of
# Test/Loss by round 2) and whose full-batch rounds take the reference
# minutes on the CPU
CNN = ["--model", "cnn", "--dataset", "synthetic", "--client_num_per_round", "4",
       "--batch_size", "20", "--lr", "0.01"]
ALGOS = {
    "fedavg": ["--algorithm", "fedavg"],
    "fedadam": ["--algorithm", "fedopt", "--server_optimizer", "adam", "--server_lr", "0.05"],
    "median": ["--algorithm", "fedavg_robust", "--defense", "median"],
    "trimmed_mean": ["--algorithm", "fedavg_robust", "--defense", "trimmed_mean"],
}


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    # the port on one thread: under 6 test workers 8 threads a process spin
    # against each other
    with torch_threads(1), private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _ref(args):
    result = CliRunner().invoke(jcli.main, [str(a) for a in args], catch_exceptions=False)
    assert result.exit_code == 0, result.output
    return result


def _port(args):
    return tcli.main([str(a) for a in args], device="cpu")


def _arg(args, name, default):
    return type(default)(args[args.index(name) + 1]) if name in args else default


def _reference_shuffles(monkeypatch, args):
    cohort = _arg(args, "--client_num_per_round", 10)
    monkeypatch.setattr(tfedavg, "seeded_perm_fn", lambda seed: jax_round_perm_fn(seed, cohort))


def _reference_init_checkpoint(path: Path, args, algo_state=None) -> None:
    """The reference's init for the run's model, as a round-0 checkpoint."""
    classes = 10  # synthetic_classification's
    model = jax_create_model(_arg(args, "--model", "lr"), "synthetic", (28, 28, 1), classes)
    init = jax.device_get(model.init(jax.random.fold_in(jax.random.PRNGKey(0), 0)))
    jax_save(str(path), init, round_idx=0, algo_state=algo_state)


def _summary(log_dir: Path) -> dict:
    return json.loads((log_dir / "summary.json").read_text())


def _round_rows(log_dir: Path) -> list:
    rows = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    return [{k: v for k, v in r.items() if k not in ("_ts", "round_time_s", "t_s")}
            for r in rows if "Train/Loss" in r or "t_s" in r]


def _assert_close_rows(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (int, float)) and not isinstance(w, bool):
            assert abs(g - w) <= ROW_TOL * max(1.0, abs(w)), (k, g, w)
        else:
            assert g == w, (k, g, w)


# --------------------------------------------------------------- (a)


def test_flag_surface_equals_the_reference():
    parser = tcli.build_parser()
    actions = {s: a for a in parser._actions for s in a.option_strings}
    types = {"integer": int, "float": float, "text": str, "path": Path}
    seen = {"-h", "--help"}
    for p in jcli.main.params:
        for name in p.opts + p.secondary_opts:
            assert actions[name].dest == p.name, name
            seen.add(name)
        action = actions[p.opts[0]]
        assert action.default == p.default, p.name
        choices = getattr(p.type, "choices", None)
        assert (tuple(action.choices) if action.choices else None) == (
            tuple(choices) if choices else None), p.name
        if not p.is_flag and choices is None:
            assert (action.type or str) is types[p.type.name], p.name  # argparse: None is str
    assert set(actions) == seen  # no option of the port's own
    assert tcli.ALGORITHMS == jcli.ALGORITHMS and tcli.RUNTIMES == jcli.RUNTIMES


# --------------------------------------------------------------- (b)

REFUSED = {
    "secure_agg_on_vmap": ["--secure_agg", "--runtime", "vmap"],
    "min_clients_on_vmap": ["--min_clients", "3"],
    "min_clients_without_deadline": ["--min_clients", "3", "--runtime", "loopback"],
    "compression_on_vmap": ["--compression", "int8", "--runtime", "vmap"],
    "resume_without_checkpoint": ["--resume", "--comm_round", "1"],
    "error_feedback_without_lossy_codec": ["--error_feedback", "--runtime", "loopback"],
    "send_fault_without_retries": ["--send_fault_p", "0.1", "--runtime", "loopback"],
    "retries_on_vmap": ["--send_retries", "2"],
    "robust_over_transport": ["--algorithm", "fedavg_robust", "--runtime", "loopback"],
    "overprovision_below_one": ["--overprovision_factor", "0.5"],
    "variant_without_meaning": ["--variant", "dsgd"],
    "dropping_plan_without_deadline": ["--runtime", "loopback", "--fault_plan",
                                       '{"default": {"dropout_p": 0.5}}'],
    "bad_fault_plan": ["--fault_plan", "{not json"],
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_reference_usage_errors_are_usage_errors(case, tmp_path):
    args = REFUSED[case] + ["--log_dir", tmp_path / "log"]
    assert CliRunner().invoke(jcli.main, [str(a) for a in args]).exit_code == 2
    with pytest.raises(SystemExit) as e:
        _port(args)
    assert e.value.code == 2


def test_resume_over_a_transport_is_refused(tmp_path):
    args = ["--runtime", "loopback", "--resume", "--checkpoint_path", tmp_path / "ck",
            "--comm_round", "1"]
    with pytest.raises(SystemExit) as e:
        _port(args)
    assert e.value.code == 2


UNPORTED = {
    "mesh": ["--runtime", "mesh"],
    "grpc": ["--runtime", "grpc", "--rank", "0"],
    # fedbuff runs over loopback, shm and mqtt; one process per rank waits
    "fedbuff_over_loopback": ["--algorithm", "fedbuff", "--runtime", "grpc", "--rank", "0"],
    "warmup": ["--warmup"],
    "fused_rounds": ["--fused_rounds", "2"],
    # the batched schedule runs lr and the LM; a model with an LSTM waits
    "client_parallelism_vmap": ["--client_parallelism", "vmap", "--model", "rnn"],
    # straggler_aware runs; the gRPC straggler injection beside it waits
    "straggler_aware": ["--selection", "straggler_aware", "--straggle_ms", "50"],
    "telemetry_dir": ["--telemetry_dir", "telemetry"],
    "prom_port": ["--prom_port", "0"],
    "recompile_budget": ["--recompile_budget", "10"],
    # every model and dataset name is ported; what waits is the batched
    # schedule of a model with running statistics, on its own dataset too
    "model_zoo": ["--model", "efficientnet", "--client_parallelism", "vmap"],
    "dataset": ["--dataset", "seg_synth", "--model", "segnet", "--client_parallelism", "vmap"],
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_what_is_not_ported_raises(case, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _port(UNPORTED[case] + ["--comm_round", "1", "--log_dir", tmp_path])


# what earlier slices left unported and this one ports: each runs as the
# reference's CLI does on the same argv (LR = the logistic-regression model
# on synthetic data, 10 clients). "cohort" is the round's cohort size over
# which the reference splits its shuffle keys (None: full batch, where the
# shuffles do not matter); "noise" patches in the reference's noise draws.
DP_SECRET = (1 << 100) + 12345
PORTED = {
    "dp_fedavg": dict(args=["--algorithm", "dp_fedavg", "--client_num_per_round", "4",
                            "--dp_noise_multiplier", "0.1"], noise=True,
                      cohort=lambda r: _dp_cohort(r, 10, 4)),
    "eval_on_clients": dict(args=["--eval_on_clients", "--client_num_per_round", "4"], cohort=4),
    "power_of_choice": dict(args=["--selection", "power_of_choice", "--client_num_per_round", "3",
                                  "--comm_round", "3"], cohort=3),
    "overprovision": dict(args=["--overprovision_factor", "1.4", "--client_num_per_round", "4"],
                          cohort=6),
    "krum": dict(args=["--algorithm", "fedavg_robust", "--defense", "krum"], cohort=10),
    "multi_krum": dict(args=["--algorithm", "fedavg_robust", "--defense", "multi_krum",
                             "--num_byzantine", "2", "--multi_krum_m", "4"], cohort=10),
    "weak_dp": dict(args=["--algorithm", "fedavg_robust", "--defense", "weak_dp",
                          "--norm_bound", "1.0"], cohort=10, noise=True),
    "backdoor": dict(args=["--algorithm", "fedavg_robust", "--defense", "median", "--attack",
                           "backdoor", "--num_attackers", "2", "--client_num_per_round", "5",
                           "--attack_boost", "5"], cohort=5, noise=True),
    "fault_plan": dict(args=["--fault_plan", '{"seed": 4, "default": {"dropout_p": 0.3}}',
                             "--client_num_per_round", "5", "--batch_size", "-1"], cohort=None),
    # the stateful and drift-correcting algorithms: SCAFFOLD and Ditto resume
    # from the init checkpoint's state (the device stack's form; the mmap
    # run restores it into its spill tier), Ditto with the reference's
    # personal shuffles; hierarchical at full batch (its shuffles are keyed
    # per group and sub-round, and full batch makes them moot)
    "fednova": dict(args=["--algorithm", "fednova", "--client_num_per_round", "4"], cohort=4),
    "qfedavg": dict(args=["--algorithm", "qfedavg", "--qffl_q", "0.5",
                          "--client_num_per_round", "4"], cohort=4),
    "hierarchical": dict(args=["--algorithm", "hierarchical", "--group_num", "2",
                               "--group_comm_round", "2", "--client_num_per_round", "6",
                               "--batch_size", "-1"], cohort=None),
    "scaffold": dict(args=["--algorithm", "scaffold", "--client_num_per_round", "4"], cohort=4),
    "scaffold_mmap": dict(args=["--algorithm", "scaffold", "--client_num_per_round", "4",
                                "--state_store", "mmap"], cohort=4),
    "ditto": dict(args=["--algorithm", "ditto", "--ditto_lambda", "0.5",
                        "--client_num_per_round", "4"], cohort=4, personal=True),
}


def _stateful_init(args):
    """SCAFFOLD's and Ditto's state at round 0 in the reference's device
    form (zero control variates; every personal model w_0), for the init
    checkpoint's algo slot."""
    algorithm = _arg(args, "--algorithm", "fedavg")
    if algorithm not in ("scaffold", "ditto"):
        return None
    model = jax_create_model("lr", "synthetic", (28, 28, 1), 10)
    init = jax.device_get(model.init(jax.random.fold_in(jax.random.PRNGKey(0), 0)))
    n = _arg(args, "--client_num_in_total", 10)
    tree_map = jax.tree_util.tree_map
    stack = lambda tree: tree_map(lambda a: np.broadcast_to(a, (n,) + a.shape).copy(), tree)  # noqa: E731
    if algorithm == "ditto":
        return {"v_stack": stack(init)}
    zeros = tree_map(np.zeros_like, init["params"])
    return {"c_server": zeros, "c_stack": stack(zeros)}


def _dp_cohort(round_idx, n, per_round):
    from fedml_tpu_torch.privacy.dp_fedavg import bucket_cohort, poisson_client_sampling

    return bucket_cohort(len(poisson_client_sampling(DP_SECRET, round_idx, n, per_round / n)))


@pytest.mark.parametrize("case", sorted(PORTED))
def test_ported_options_match_the_reference(case, tmp_path, monkeypatch):
    """From one reference-written init checkpoint (with DP-FedAvg's ledger
    and secret in its algo slot), both CLIs --resume for the run with the
    reference's shuffles and noise: summary.json and every round row
    within ROW_TOL, the same keys (the port's lack only compile/*)."""
    spec = PORTED[case]
    args = LR + spec["args"] + ["--resume"]
    if "--comm_round" not in args:
        args += ["--comm_round", "2"]
    algo = None
    if case == "dp_fedavg":
        from fedml_tpu_torch.privacy.accountant import RdpAccountant
        from fedml_tpu_torch.privacy.dp_fedavg import _secret_to_words

        algo = {"dp_rdp": np.zeros(len(RdpAccountant().orders)), "dp_rounds": np.asarray(0),
                "dp_sample_secret": _secret_to_words(DP_SECRET)}
    else:
        algo = _stateful_init(args)
    _reference_init_checkpoint(tmp_path / "init", args, algo_state=algo)
    for side in ("ref", "port"):
        for ext in (".npz", ".json"):
            shutil.copy(tmp_path / f"init{ext}", tmp_path / f"{side}{ext}")
    _ref(args + ["--log_dir", tmp_path / "ref_log", "--checkpoint_path", tmp_path / "ref"])
    if spec["cohort"] is not None:
        monkeypatch.setattr(tfedavg, "seeded_perm_fn",
                            lambda seed: jax_round_perm_fn(seed, spec["cohort"]))
    if spec.get("noise"):
        monkeypatch.setattr(tfedavg, "seeded_noise_fn", lambda seed, device: jax_noise_fn(seed))
    if spec.get("personal"):
        monkeypatch.setattr(tditto, "seeded_personal_perm_fn",
                            lambda seed: jax_ditto_personal_perm_fn(seed, spec["cohort"]))
    api = _port(args + ["--log_dir", tmp_path / "port_log", "--checkpoint_path",
                        tmp_path / "port"])

    want, got = _summary(tmp_path / "ref_log"), _summary(tmp_path / "port_log")
    only_ref = set(want) - set(got)
    assert only_ref and all(k.startswith(REFERENCE_ONLY_PREFIXES) for k in only_ref), only_ref
    assert set(got) <= set(want)
    _assert_close_rows({k: got[k] for k in got if k != "round_time_s"},
                       {k: want[k] for k in got if k != "round_time_s"})
    ref_rows, port_rows = _round_rows(tmp_path / "ref_log"), _round_rows(tmp_path / "port_log")
    assert len(port_rows) == len(ref_rows) >= 2
    for g, w in zip(port_rows, ref_rows, strict=True):
        _assert_close_rows(g, w)
    key = {"dp_fedavg": "DP/epsilon", "backdoor": "Backdoor/ASR",
           "fault_plan": "faults/total", "ditto": "Personalized/Acc"}.get(case)
    if case.startswith("scaffold"):
        assert api.state.mode == _arg(args, "--state_store", "device")
    if key is not None:
        assert key in got
    if case == "eval_on_clients":
        assert "Train/Acc" in got and "Test/Acc" in got
    if case in ("dp_fedavg",):
        # the end-of-run checkpoint carries the ledger both packages resume
        ref_ck, port_ck = jax_load(str(tmp_path / "ref")), jax_load(str(tmp_path / "port"))
        assert int(port_ck[4]["dp_rounds"]) == int(ref_ck[4]["dp_rounds"]) == 2
        np.testing.assert_array_equal(port_ck[4]["dp_sample_secret"],
                                      ref_ck[4]["dp_sample_secret"])
        np.testing.assert_allclose(port_ck[4]["dp_rdp"], ref_ck[4]["dp_rdp"], rtol=1e-12)
        assert api.accountant.rounds == 2


@pytest.mark.parametrize("case", ["dp_with_scheduler", "dp_bad_clip", "dp_bad_noise",
                                  "dp_bad_delta", "attack_without_robust",
                                  "overprovision_with_secure_agg", "attackers_out_of_range"])
def test_new_usage_errors_are_the_reference_s(case, tmp_path):
    args = {
        "dp_with_scheduler": ["--algorithm", "dp_fedavg", "--selection", "weighted"],
        "dp_bad_clip": ["--algorithm", "dp_fedavg", "--dp_clip", "0"],
        "dp_bad_noise": ["--algorithm", "dp_fedavg", "--dp_noise_multiplier", "-1"],
        "dp_bad_delta": ["--algorithm", "dp_fedavg", "--dp_delta", "1.5"],
        "attack_without_robust": ["--attack", "backdoor"],
        "overprovision_with_secure_agg": ["--overprovision_factor", "1.5", "--secure_agg",
                                          "--runtime", "loopback"],
        "attackers_out_of_range": ["--algorithm", "fedavg_robust", "--attack", "backdoor",
                                   "--num_attackers", "10"],
    }[case] + ["--comm_round", "1", "--log_dir", tmp_path / "log"]
    result = CliRunner().invoke(jcli.main, [str(a) for a in args])
    assert result.exit_code == 2, result.output
    with pytest.raises(SystemExit) as e:
        _port(args)
    assert e.value.code == 2


@pytest.mark.parametrize("sub", ["serve", "status", "fleet", "trace"])
def test_subcommands_are_recognized_and_not_ported(sub, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["fedml_tpu_torch", sub, "--port", "0"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tmain._entry()


# --------------------------------------------------------------- (c)


@pytest.mark.parametrize("model,algo", [
    ("lr", "fedavg"), ("lr", "fedadam"), ("lr", "median"), ("lr", "trimmed_mean"),
    ("cnn", "median"), ("cnn", "fedadam"),
])
def test_summary_rows_match_the_reference(model, algo, tmp_path, monkeypatch):
    args = (LR if model == "lr" else CNN) + ALGOS[algo] + ["--comm_round", "3", "--resume"]
    _reference_init_checkpoint(tmp_path / "init", args)
    for side in ("ref", "port"):
        for ext in (".npz", ".json"):
            shutil.copy(tmp_path / f"init{ext}", tmp_path / f"{side}{ext}")
    _ref(args + ["--log_dir", tmp_path / "ref_log", "--checkpoint_path", tmp_path / "ref"])
    _reference_shuffles(monkeypatch, args)
    _port(args + ["--log_dir", tmp_path / "port_log", "--checkpoint_path", tmp_path / "port"])

    want, got = _summary(tmp_path / "ref_log"), _summary(tmp_path / "port_log")
    only_ref = set(want) - set(got)
    assert only_ref and all(k.startswith(REFERENCE_ONLY_PREFIXES) for k in only_ref), only_ref
    assert set(got) <= set(want)
    _assert_close_rows({k: got[k] for k in got if k != "round_time_s"},
                       {k: want[k] for k in got if k != "round_time_s"})
    ref_rows, port_rows = _round_rows(tmp_path / "ref_log"), _round_rows(tmp_path / "port_log")
    assert [r["round"] for r in port_rows] == [0, 1, 2]
    for g, w in zip(port_rows, ref_rows, strict=True):
        _assert_close_rows(g, w)
    # the end-of-run checkpoints, both read by the reference: vars and
    # server state within the rows' tolerance, the same cohorts and loss map
    ref_ck, port_ck = jax_load(str(tmp_path / "ref")), jax_load(str(tmp_path / "port"))
    assert ref_ck[1] == port_ck[1] == 3
    for slot in (0, 3):  # vars, opt
        want_leaves = jax.tree_util.tree_leaves(ref_ck[slot])
        got_leaves = jax.tree_util.tree_leaves(port_ck[slot])
        assert len(got_leaves) == len(want_leaves)
        for g, w in zip(got_leaves, want_leaves):
            np.testing.assert_allclose(g, w, rtol=ROW_TOL, atol=ROW_TOL)
    ref_sched, port_sched = ref_ck[5], port_ck[5]
    for key in ("rounds", "loss_ids"):
        np.testing.assert_array_equal(port_sched[key], ref_sched[key])
    assert [list(c) for c in port_sched["selections"]] == [list(c) for c in ref_sched["selections"]]
    np.testing.assert_allclose(port_sched["loss_vals"], ref_sched["loss_vals"], rtol=ROW_TOL)


# --------------------------------------------------------------- (d)


@pytest.mark.parametrize("model,algo", [("lr", "fedadam"), ("cnn", "median")])
def test_port_resume_is_bit_equal_to_its_uninterrupted_run(model, algo, tmp_path):
    common = (LR if model == "lr" else CNN) + ALGOS[algo]
    full = _port(common + ["--comm_round", "4", "--log_dir", tmp_path / "full"])
    ck = tmp_path / "ck"
    _port(common + ["--comm_round", "2", "--checkpoint_path", ck])
    resumed = _port(common + ["--comm_round", "4", "--checkpoint_path", ck, "--resume",
                              "--log_dir", tmp_path / "resumed"])
    assert [r["round"] for r in resumed.history] == [2, 3]
    strip = lambda r: {k: v for k, v in r.items() if k != "round_time_s"}  # noqa: E731
    assert [strip(r) for r in resumed.history] == [strip(r) for r in full.history[2:]]
    for k, v in full.global_vars.items():
        assert torch.equal(resumed.global_vars[k], v), k
    if algo == "fedadam":
        assert resumed.server_opt_state[0].count == full.server_opt_state[0].count == 4
        for k, v in full.server_opt_state[0].nu.items():
            assert torch.equal(resumed.server_opt_state[0].nu[k], v), k


# --------------------------------------------------------------- (e)


@pytest.mark.parametrize("algo", ["fedavg", "fedadam"])
def test_port_continues_a_reference_run(algo, tmp_path, monkeypatch):
    common = LR + ALGOS[algo] + ["--client_num_per_round", "5"]
    _ref(common + ["--comm_round", "4", "--log_dir", tmp_path / "straight",
                   "--checkpoint_path", tmp_path / "straight_ck"])
    _ref(common + ["--comm_round", "2", "--checkpoint_path", tmp_path / "ck"])
    _reference_shuffles(monkeypatch, common)
    api = _port(common + ["--comm_round", "4", "--resume", "--checkpoint_path", tmp_path / "ck",
                          "--log_dir", tmp_path / "resumed"])
    want = [r for r in _round_rows(tmp_path / "straight") if r["round"] >= 2]
    got = _round_rows(tmp_path / "resumed")
    assert [r["round"] for r in got] == [2, 3]
    for g, w in zip(got, want, strict=True):
        _assert_close_rows(g, w)
    ref_final = flat_params(jax_load(str(tmp_path / "straight_ck"))[0]["params"])
    port_final = flat_params(to_flax(api.global_vars))
    assert port_final.keys() == ref_final.keys()
    for k in ref_final:
        np.testing.assert_allclose(port_final[k], ref_final[k], rtol=ROW_TOL, atol=ROW_TOL, err_msg=k)


# --------------------------------------------------------------- (f)


def test_weighted_selection_draws_the_reference_cohorts(tmp_path):
    args = LR + ["--selection", "weighted", "--client_num_in_total", "12",
                 "--client_num_per_round", "3", "--comm_round", "6",
                 "--frequency_of_the_test", "6"]
    _ref(args + ["--log_dir", tmp_path / "ref"])
    _port(args + ["--log_dir", tmp_path / "port"])

    def cohorts(log_dir):
        rows = [json.loads(x) for x in (log_dir / "metrics.jsonl").read_text().splitlines()]
        sel = {r["round"]: r["scheduler/selected"] for r in rows if "scheduler/selected" in r}
        assert {r["scheduler/policy"] for r in rows if "scheduler/policy" in r} == {"weighted"}
        return sel

    want = cohorts(tmp_path / "ref")
    assert cohorts(tmp_path / "port") == want and sorted(want) == list(range(6))
    assert len({tuple(c) for c in want.values()}) > 1


# --------------------------------------------------------------- (g)


@time_limit(60)
def test_entry_point_has_no_cpu_fallback(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card, wherever this runs
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "fedml_tpu_torch", *a], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=50)
    help_ = run("--help")
    assert help_.returncode == 0 and "--algorithm" in help_.stdout
    train = run("--comm_round", "1", "--log_dir", str(tmp_path / "log"))
    assert train.returncode != 0
    assert "runs on a CUDA device by default and none is available" in train.stderr
    assert train.stdout.strip() == "" and not (tmp_path / "log").exists()


# --------------------------------------------------------------- (h)


@time_limit(90)
def test_loopback_fedadam_writes_the_reference_transport_rows(tmp_path):
    args = LR + ALGOS["fedadam"] + ["--runtime", "loopback", "--comm_round", "2",
                                    "--client_num_per_round", "4"]
    _ref(args + ["--log_dir", tmp_path / "ref"])
    api = _port(args + ["--log_dir", tmp_path / "port", "--checkpoint_path", tmp_path / "ck"])
    want, got = _summary(tmp_path / "ref"), _summary(tmp_path / "port")
    only_ref = set(want) - set(got)
    assert all(k.startswith(REFERENCE_ONLY_PREFIXES) for k in only_ref), only_ref
    assert set(got) <= set(want) and {"t_s", "Test/Acc", "scheduler/selected"} <= set(got)
    assert [r["round"] for r in _round_rows(tmp_path / "port")] == [0, 1]
    assert all(np.isfinite(r["Test/Loss"]) for r in _round_rows(tmp_path / "port"))
    # the end-of-run checkpoint holds the server's FedAdam moments
    _, round_idx, _, opt_state, _, sched = jax_load(str(tmp_path / "ck"))
    assert round_idx == 2 and sched is None and int(opt_state[0][0]) == 2
    assert api.server_opt_state[0].count == 2


# --------------------------------------------------------------- wandb


def _fake_wandb(calls: dict) -> types.ModuleType:
    """A stand-in for the wandb module: records init's arguments and the
    logged rows."""
    mod = types.ModuleType("wandb")
    mod.run = None

    def init(project, name, config):
        calls["init"] = {"project": project, "name": name, "config_keys": sorted(config)}
        mod.run = object()
        return mod.run

    mod.init = init
    mod.log = lambda row: calls.setdefault("rows", []).append(row)
    return mod


@pytest.mark.parametrize("installed", [True, False])
def test_enable_wandb_mirrors_the_rows_as_the_reference(installed, tmp_path, monkeypatch):
    """--enable_wandb starts a run named as the reference names it and
    mirrors every row to it; without wandb it changes nothing."""
    args = LR + ["--comm_round", "2", "--enable_wandb"]
    calls = {"ref": {}, "port": {}}
    for side in ("ref", "port"):
        monkeypatch.setitem(sys.modules, "wandb", _fake_wandb(calls[side]) if installed else None)
        log_dir = tmp_path / side
        (_ref if side == "ref" else _port)(args + ["--log_dir", log_dir])
        assert [r["round"] for r in _round_rows(log_dir)] == [0, 1]
    if not installed:
        assert calls == {"ref": {}, "port": {}}
        return
    assert calls["port"]["init"] == calls["ref"]["init"]
    lines = (tmp_path / "port" / "metrics.jsonl").read_text().splitlines()
    rows = [{k: v for k, v in json.loads(x).items() if not k.startswith("_")} for x in lines]
    assert calls["port"]["rows"] == rows and len(rows) >= 2


# ------------------------------------------------ the CLI drives the API


@pytest.mark.parametrize("algo", ["median", "fedadam"])
def test_cli_runs_what_the_python_api_runs(algo, tmp_path):
    """The north-star options (chip_smoke.py's phase_cli), at 12 clients:
    the CLI's rows and final vars equal, bit for bit, those of the API built
    by hand from RunConfig's defaults, so no default of build_config drifts
    from the Python API's."""
    from fedml_tpu_torch.algorithms import FedOptAPI, RobustFedAvgAPI
    from fedml_tpu_torch.config import DataConfig, FedConfig, RunConfig, ServerConfig, TrainConfig
    from fedml_tpu_torch.data.femnist_synth import femnist_synthetic
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.robustness import RobustConfig

    clients, per_round, rounds = 12, 4, 2
    cfg = RunConfig(
        data=DataConfig(batch_size=20),
        fed=FedConfig(client_num_in_total=clients, client_num_per_round=per_round,
                      comm_round=rounds, epochs=1),
        train=TrainConfig(lr=0.1), model="cnn", seed=0,
    )
    data = femnist_synthetic(num_clients=clients, seed=0)
    model = create_model("cnn", "femnist", (28, 28, 1), 62)
    if algo == "median":
        direct = RobustFedAvgAPI(cfg, data, model, robust=RobustConfig(defense_type="median"),
                                 device="cpu")
    else:
        cfg = cfg.replace(server=ServerConfig(server_optimizer="adam", server_lr=0.05))
        direct = FedOptAPI(cfg, data, model, device="cpu")
    direct.train()
    via_cli = _port(ALGOS[algo] + [
        "--model", "cnn", "--dataset", "femnist_synth", "--client_num_in_total", clients,
        "--client_num_per_round", per_round, "--batch_size", "20", "--epochs", "1",
        "--lr", "0.1", "--comm_round", rounds, "--log_dir", tmp_path])
    strip = lambda r: {k: v for k, v in r.items() if k != "round_time_s"}  # noqa: E731
    assert [strip(r) for r in via_cli.history] == [strip(r) for r in direct.history]
    assert len(direct.history) == rounds
    for k, v in direct.global_vars.items():
        assert torch.equal(via_cli.global_vars[k], v), k


# --------------------------------------------------------------- imports


def test_no_port_module_imports_click_or_h5py():
    """click and h5py are absent on the card's machine: importing any module
    of the port loads neither (the TFF loaders import h5py when they open a
    file)."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import fedml_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(fedml_tpu_torch.__path__, "
        "'fedml_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps([len(mods), 'fedml_tpu_torch.cli' in mods, "
        "[m for m in sys.modules if m.split('.')[0] in ('click', 'h5py')]]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    n, has_cli, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert n > 50 and has_cli and loaded == []


# ------------------------------- the algorithms with loops of their own


def _reference_lr_init(monkeypatch):
    """The port's models start from the reference's init for the run's
    model (these algorithms take no --resume)."""
    import fedml_tpu_torch.models as tmodels
    from fedml_tpu_torch.bridge import from_flax

    model = jax_create_model("lr", "synthetic", (28, 28, 1), 10)
    init = from_flax(jax.device_get(model.init(jax.random.fold_in(jax.random.PRNGKey(0), 0))))
    create = tmodels.create_model

    def create_with_reference_init(*a, **kw):
        m = create(*a, **kw)
        m.init = lambda generator: {k: v.clone() for k, v in init.items()}
        return m

    monkeypatch.setattr(tmodels, "create_model", create_with_reference_init)


def _reference_worker_init(monkeypatch, n: int, feat: int):
    """Each decentralized worker from the reference's per-worker key
    (``split(PRNGKey(seed), N)``)."""
    import fedml_tpu_torch.algorithms.decentralized as tdec
    from fedml_tpu.models import ModelDef as JaxModelDef
    from fedml_tpu.models.linear import LogisticRegression as JaxLR

    from fedml_tpu_torch.bridge import from_flax

    model = JaxModelDef(JaxLR(num_classes=1), (feat,), 1, name="lr")
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    params = from_flax(jax.device_get(jax.vmap(lambda k: model.init(k)["params"])(keys)), 1)

    class WithReferenceInit(tdec.DecentralizedAPI):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.params = {k: v.to(self.device) for k, v in params.items()}

    monkeypatch.setattr(tdec, "DecentralizedAPI", WithReferenceInit)


@pytest.mark.parametrize("case", ["centralized", "dsgd", "pushsum"])
def test_longtail_algorithms_match_the_reference(case, tmp_path, monkeypatch):
    """Both CLIs from the reference's init: summary.json and every row
    within ROW_TOL, with the same keys (the port's lack only compile/*)."""
    if case == "centralized":
        args = LR + ["--algorithm", "centralized", "--comm_round", "2", "--batch_size", "16"]
        _reference_lr_init(monkeypatch)
    else:
        args = LR + ["--algorithm", "decentralized", "--variant", case]
        _reference_worker_init(monkeypatch, 10, 28 * 28)
    _ref(args + ["--log_dir", tmp_path / "ref_log"])
    api = _port(args + ["--log_dir", tmp_path / "port_log"])
    want, got = _summary(tmp_path / "ref_log"), _summary(tmp_path / "port_log")
    assert set(got) <= set(want)
    assert all(k.startswith(REFERENCE_ONLY_PREFIXES) for k in set(want) - set(got))
    _assert_close_rows(got, {k: want[k] for k in got})
    rows = lambda d: [json.loads(line) for line in (d / "metrics.jsonl").read_text().splitlines()]  # noqa: E731
    ref_rows = [r for r in rows(tmp_path / "ref_log") if "Train/Loss" in r or "final_regret" in r]
    port_rows = [r for r in rows(tmp_path / "port_log") if "Train/Loss" in r or "final_regret" in r]
    assert len(port_rows) == len(ref_rows) >= 1
    for g, w in zip(port_rows, ref_rows, strict=True):
        _assert_close_rows({k: v for k, v in g.items() if k != "_ts"},
                           {k: v for k, v in w.items() if k != "_ts"})
    if case != "centralized":
        assert api.variant == case and got["iterations"] > 1


@pytest.mark.parametrize("case", [
    "centralized_with_selection", "decentralized_over_loopback", "centralized_resume",
    "centralized_checkpoint", "decentralized_bad_variant", "scaffold_over_loopback",
    "fednova_with_variant", "ditto_over_shm",
])
def test_longtail_usage_errors_are_the_reference_s(case, tmp_path):
    args = {
        "centralized_with_selection": ["--algorithm", "centralized", "--selection", "weighted"],
        "decentralized_over_loopback": ["--algorithm", "decentralized", "--runtime", "loopback"],
        "centralized_resume": ["--algorithm", "centralized", "--resume", "--checkpoint_path",
                               tmp_path / "ck"],
        "centralized_checkpoint": ["--algorithm", "centralized", "--checkpoint_path",
                                   tmp_path / "ck"],
        "decentralized_bad_variant": ["--algorithm", "decentralized", "--variant", "gossip"],
        "scaffold_over_loopback": ["--algorithm", "scaffold", "--runtime", "loopback"],
        "fednova_with_variant": ["--algorithm", "fednova", "--variant", "dsgd"],
        "ditto_over_shm": ["--algorithm", "ditto", "--runtime", "shm"],
    }[case] + ["--comm_round", "1", "--log_dir", tmp_path / "log"]
    result = CliRunner().invoke(jcli.main, [str(a) for a in args])
    assert result.exit_code == 2, result.output
    with pytest.raises(SystemExit) as e:
        _port(args)
    assert e.value.code == 2
