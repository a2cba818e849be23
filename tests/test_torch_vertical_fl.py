"""Vertical FL in the port against the reference on the CPU
(fedml_tpu_torch/algorithms/vertical_fl.py, splitfed/programs.py,
data/vertical.py, the ``vertical_fl`` runner of cli.py).

The port's party weights are carried into the reference's ``VFLAPI``
through ``bridge.party_to_flax`` (its optimizer state re-initialized over
them), so both start from one state. Reference runs go through
``torch_parity.reference_record`` under ``private_reference_programs``.

Tolerances: after two epochs of SGD-momentum steps, params within 1e-5 of
each tensor's largest magnitude, losses rtol 1e-5 (float32 matmuls summed
in other orders, and optax's log-sigmoid form of the binary cross-entropy
against torch's max-shifted one; measured ≤ 1e-6), accuracy within one
sample; the loaders' arrays exactly; the port's message-boundary gradients
against its fused step bit for bit."""

import csv
import json

import numpy as np
import pytest
import torch

from fedml_tpu_torch.algorithms.vertical_fl import VFLAPI
from fedml_tpu_torch.bridge import party_from_flax, party_to_flax
from fedml_tpu_torch.splitfed import programs as P

from torch_parity import private_reference_programs, reference_record, torch_threads, variables_digest

SPLITS, N, BATCH, LR = (4, 3, 3), 48, 8, 0.1
PARAM_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _isolated(tmp_path_factory):
    with torch_threads(1), private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _data(seed=9):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((N, d)).astype(np.float32) for d in SPLITS]
    return xs, rng.integers(0, 2, size=N).astype(np.float32)


def _close(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k in want:
        g, w = got[k].detach().numpy(), want[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= PARAM_TOL * scale, (what, k)


def _digest(params):
    return variables_digest({f"{i}.{k}": v for i, p in enumerate(params) for k, v in p.items()})


def _carried_reference(jvfl, init):
    """A reference VFLAPI whose parties hold ``init`` (flax party trees)."""
    api = jvfl.VFLAPI(feature_splits=list(SPLITS), lr=LR, seed=0)
    api.params = [dict(p) for p in init]
    api.opt_state = api.opt.init(api.params)
    return api


def test_train_epoch_matches_the_reference():
    xs, y = _data()
    api = VFLAPI(list(SPLITS), lr=LR, seed=4, device="cpu")
    init = [party_to_flax(p) for p in api.params]

    def run():
        import jax

        import fedml_tpu.algorithms.vertical_fl as jvfl

        japi = _carried_reference(jvfl, init)
        stats = [japi.train_epoch(xs, y, batch_size=BATCH) for _ in range(2)]
        return {"stats": stats, "params": jax.device_get(japi.params)}

    want = reference_record("vfl_epochs", {"digest": _digest(api.params)}, run)
    for s, w in zip([api.train_epoch(xs, y, batch_size=BATCH) for _ in range(2)], want.stats):
        np.testing.assert_allclose(s["loss"], w["loss"], rtol=1e-5)
        assert abs(s["acc"] - w["acc"]) <= 1 / N
    for i, (p, w) in enumerate(zip(api.params, want.params)):
        _close(p, party_from_flax(w), f"party {i}")


def test_guest_host_split_step_equals_the_fused_gradients():
    """The message-boundary gradients equal the fused step's, bit for bit
    (one step from zero traces leaves the gradient as the trace), and the
    reference's boundary gradients within PARAM_TOL."""
    xs, y = _data(3)
    api = VFLAPI(list(SPLITS), lr=LR, seed=1, device="cpu")
    init = [party_to_flax(p) for p in api.params]
    split = api.guest_host_split_step(xs, y)
    step = P.make_vfl_fused_step(lr=LR)
    _, state, _, _ = step(api.params, api.opt_state, [torch.from_numpy(x) for x in xs],
                          torch.from_numpy(y))
    fused = P.unjoin(state[0].trace, [str(i) for i in range(len(SPLITS))])
    for i, (g, f) in enumerate(zip(split, fused)):
        assert set(g) == set(f)
        for k in g:
            assert torch.equal(g[k], f[k]), (i, k)

    def run():
        import jax

        import fedml_tpu.algorithms.vertical_fl as jvfl

        return {"grads": jax.device_get(_carried_reference(jvfl, init).guest_host_split_step(xs,
                                                                                           y))}

    want = reference_record("vfl_split_step", {"digest": _digest(api.params)}, run)
    for i, (g, w) in enumerate(zip(split, want.grads)):
        _close(g, party_from_flax(w), f"party {i} gradients")


def test_party_weights_cross_the_bridge():
    """A party's flat port dict ⇄ the reference's party tree: the leaves'
    paths, shapes and types are the reference VFLParty's (the guest's head
    with a bias, the hosts' without), and the round trip is exact."""
    import jax

    from fedml_tpu.algorithms.vertical_fl import VFLParty as JaxParty

    api = VFLAPI(list(SPLITS), lr=LR, seed=5, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), len(SPLITS))
    for i, (p, d) in enumerate(zip(api.params, SPLITS)):
        tree = party_to_flax(p)
        want = JaxParty(d, 16, 1, keys[i], has_labels=(i == 0)).params
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want)
        for g, w in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want)):
            assert g.shape == w.shape and g.dtype == w.dtype
        back = party_from_flax(tree)
        assert set(back) == set(p) and all(torch.equal(back[k], p[k]) for k in p)


def test_party_opt_state_partition_round_trips():
    api = VFLAPI(list(SPLITS), lr=LR, seed=2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    fused = api.opt_state
    fused = (fused[0]._replace(trace={k: torch.randn(v.shape, generator=gen)
                                      for k, v in fused[0].trace.items()}), fused[1])
    states = P.split_party_opt_states(fused, len(SPLITS))
    assert len(states) == 3
    for st, p in zip(states, api.params):
        assert list(st[0].trace) == list(p)
    merged = P.merge_party_opt_states(states)
    assert list(merged[0].trace) == list(fused[0].trace)
    for k, v in fused[0].trace.items():
        assert torch.equal(merged[0].trace[k], v), k


def _write_nus(root, n_train, n_test, rng):
    labels = ("buildings", "grass", "animal")
    (root / "Groundtruth" / "TrainTestLabels").mkdir(parents=True)
    (root / "Low_Level_Features").mkdir()
    (root / "NUS_WID_Tags").mkdir()
    for split, n in (("Train", n_train), ("Test", n_test)):
        concept = rng.integers(0, len(labels), size=n)
        for j, name in enumerate(labels):
            np.savetxt(root / "Groundtruth" / "TrainTestLabels" / f"Labels_{name}_{split}.txt",
                       (concept == j).astype(int), fmt="%d")
        for kind, width in (("CH", 5), ("EDH", 4)):
            np.savetxt(root / "Low_Level_Features" / f"{split}_Normalized_{kind}.dat",
                       rng.standard_normal((n, width)), fmt="%.6f", delimiter=" ")
        np.savetxt(root / "NUS_WID_Tags" / f"{split}_Tags1k.dat",
                   rng.integers(0, 2, size=(n, 6)), fmt="%d", delimiter="\t")
    return labels


def _write_lending(path, n, rng):
    cols = ["annual_inc", "emp_length", "home_ownership", "verification_status", "grade",
            "loan_amnt", "int_rate", "installment", "term", "purpose", "dti", "total_pymnt",
            "total_rec_int", "total_rec_prncp", "last_pymnt_amnt", "loan_status"]
    choice = {"emp_length": ["", "< 1 year", "3 years", "10+ years"],
              "home_ownership": ["RENT", "MORTGAGE", "OWN", "OTHER"],
              "verification_status": ["Not Verified", "Verified", "Source Verified"],
              "grade": list("ABCDEFG"), "term": [" 36 months", " 60 months"],
              "purpose": ["car", "credit_card", "small_business", "wedding"],
              "loan_status": ["Fully Paid", "Charged Off", "Current", "Late (16-30 days)"]}
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        for _ in range(n):
            w.writerow({c: (rng.choice(choice[c]) if c in choice else f"{rng.uniform(0, 1e4):.2f}")
                        for c in cols})


@pytest.mark.parametrize("parties", [2, 3])
def test_load_nus_wide_matches_the_reference(tmp_path, parties):
    from fedml_tpu.data.vertical import load_nus_wide as jax_load

    from fedml_tpu_torch.data.vertical import load_nus_wide

    labels = _write_nus(tmp_path, 30, 12, np.random.default_rng(parties))
    kw = dict(selected_labels=labels, target_label_idx=1, parties=parties)
    got, want = load_nus_wide(str(tmp_path), **kw), jax_load(str(tmp_path), **kw)
    assert got.feature_splits == want.feature_splits
    for a, b in zip(got.train_xs + got.test_xs + [got.train_y, got.test_y],
                    want.train_xs + want.test_xs + [want.train_y, want.test_y]):
        np.testing.assert_array_equal(a, b)


def test_load_lending_club_matches_the_reference(tmp_path):
    from fedml_tpu.data.vertical import load_lending_club as jax_load

    from fedml_tpu_torch.data.vertical import load_lending_club, zscore

    path = tmp_path / "loans.csv"
    _write_lending(path, 40, np.random.default_rng(0))
    got, want = load_lending_club(str(path), seed=3), jax_load(str(path), seed=3)
    assert got.feature_splits == want.feature_splits == [5, 6, 4]
    for a, b in zip(got.train_xs + got.test_xs + [got.train_y, got.test_y],
                    want.train_xs + want.test_xs + [want.train_y, want.test_y]):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(1).standard_normal((7, 3))
    from fedml_tpu.data.vertical import zscore as jax_zscore

    np.testing.assert_array_equal(zscore(x), jax_zscore(x))


def test_cli_row_matches_the_reference_runner(tmp_path, capsys, monkeypatch):
    """``--algorithm vertical_fl`` through both command lines on the
    registry's synthetic set split in three (261, 261, 262 of 784
    features), the reference's VFLAPI handed the port's init: the rows'
    keys are the reference's, Train/Loss within 1e-5·max(1, |reference|)
    (test_torch_cli.py's ROW_TOL: the synthetic labels' parity is learnt
    within an epoch, and a loss near 1e-4 from two forms of the
    cross-entropy differs in its fifth digit), Train/Acc within one
    sample."""
    pytest.importorskip("click")
    from click.testing import CliRunner

    from fedml_tpu import cli as jcli
    from fedml_tpu_torch import cli as tcli

    args = ["--algorithm", "vertical_fl", "--dataset", "synthetic", "--comm_round", "2",
            "--client_num_in_total", "4", "--batch_size", "20", "--lr", "0.05"]
    tcli.main(args + ["--log_dir", str(tmp_path / "port")], device="cpu")
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    port = VFLAPI([261, 261, 262], lr=0.05, seed=0, device="cpu")
    init = [party_to_flax(p) for p in port.params]

    def run():
        import fedml_tpu.algorithms.vertical_fl as jvfl

        original = jvfl.VFLAPI.__init__

        def carried(self, *a, **kw):
            original(self, *a, **kw)
            self.params = [dict(p) for p in init]
            self.opt_state = self.opt.init(self.params)

        monkeypatch.setattr(jvfl.VFLAPI, "__init__", carried)
        result = CliRunner().invoke(jcli.main, args + ["--log_dir", str(tmp_path / "ref")],
                                    catch_exceptions=False)
        assert result.exit_code == 0, result.output
        return {"row": json.loads(result.output.strip().splitlines()[-1])}

    want = reference_record("vfl_cli", {"args": args, "digest": _digest(port.params)}, run).row
    assert set(got) == set(want) == {"round", "Train/Loss", "Train/Acc"}
    assert got["round"] == want["round"]
    assert abs(got["Train/Loss"] - want["Train/Loss"]) <= 1e-5 * max(1.0, abs(want["Train/Loss"]))
    assert abs(got["Train/Acc"] - want["Train/Acc"]) <= 1 / 640
