"""The model-bound algorithms through the port's command line on the CPU:
fedseg, fedgkt, fedgan and fednas (both architects) each for 1 round, with
the row keys of the reference's runners (fedml_tpu/cli.py ``_run_fedseg``,
``_run_fedgkt``, ``_run_fedgan``, ``_run_fednas``), fedseg's best-mIoU
checkpoint read by the reference's loader, the usage errors both CLIs
give (exit code 2), and the model registry's names against the
reference's."""

import json

import numpy as np
import pytest
import torch

from fedml_tpu_torch import cli as tcli
from fedml_tpu_torch.models import create_model

from torch_parity import torch_threads

click = pytest.importorskip("click")

from click.testing import CliRunner  # noqa: E402

from fedml_tpu import cli as jcli  # noqa: E402
from fedml_tpu.models import create_model as jax_create_model  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


SMALL = ["--comm_round", "1", "--client_num_in_total", "3", "--client_num_per_round", "2"]
RUNS = {
    "fedseg": ["--model", "segnet", "--dataset", "seg_synth", "--batch_size", "8"],
    "fedgkt": ["--dataset", "synthetic", "--batch_size", "16", "--client_num_per_round", "1"],
    "fedgan": ["--model", "mnistgan", "--dataset", "synthetic", "--batch_size", "16",
               "--lr", "2e-4"],
    "fednas": ["--dataset", "synthetic", "--batch_size", "16"],
    "fednas_second": ["--dataset", "synthetic", "--batch_size", "16", "--variant", "second",
                      "--client_num_per_round", "1"],
}
# the rows of the reference's runners
ROW_KEYS = {
    "fedseg": {"round", "Train/Loss", "Train/Acc", "Test/mIoU", "Test/FWIoU", "Test/Acc",
               "Test/Acc_class"},
    "fedgkt": {"round", "Test/Acc"},
    "fedgan": {"round", "Train/G_Loss", "Train/D_Loss"},
    "fednas": {"round", "Test/Acc", "genotype"},
}


def _port(args):
    return tcli.main([str(a) for a in args], device="cpu")


@pytest.mark.parametrize("case", sorted(RUNS))
def test_model_bound_algorithms_run_through_the_cli(case, tmp_path, capsys):
    algo = case.split("_")[0]
    _port(["--algorithm", algo, "--log_dir", tmp_path] + SMALL + RUNS[case])
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(final) == ROW_KEYS[algo]
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    logged = [{k: r[k] for k in ROW_KEYS[algo]} for r in rows if set(r) >= ROW_KEYS[algo]]
    assert logged == [final]
    for key, v in final.items():
        if key not in ("round", "genotype"):
            assert np.isfinite(v), key
    if algo == "fednas":
        assert final["genotype"].startswith("[(")


def test_fedseg_cli_writes_the_best_miou_checkpoint(tmp_path, capsys):
    from fedml_tpu.utils.checkpoint import load_checkpoint as jax_load

    ckpt = tmp_path / "best"
    _port(["--algorithm", "fedseg", "--checkpoint_path", ckpt] + SMALL + RUNS["fedseg"])
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    variables, round_idx, *_ = jax_load(str(ckpt))
    assert round_idx == 0 and set(variables) == {"params", "batch_stats"}
    assert json.load(open(str(ckpt) + ".json"))["best_miou"] == final["Test/mIoU"]


REFUSED = {
    "fedgkt_checkpoint": ["--algorithm", "fedgkt", "--checkpoint_path", "{tmp}/c"],
    "fedgan_checkpoint": ["--algorithm", "fedgan", "--checkpoint_path", "{tmp}/c"],
    "fednas_checkpoint": ["--algorithm", "fednas", "--checkpoint_path", "{tmp}/c"],
    "fedseg_resume": ["--algorithm", "fedseg", "--checkpoint_path", "{tmp}/c", "--resume"],
    "fedseg_variant": ["--algorithm", "fedseg", "--variant", "first"],
    "fednas_bad_variant": ["--algorithm", "fednas", "--variant", "third"],
    "fedgan_loopback": ["--algorithm", "fedgan", "--runtime", "loopback"],
    "fednas_selection": ["--algorithm", "fednas", "--selection", "weighted"],
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_usage_errors_match_the_reference(case, tmp_path):
    args = [a.replace("{tmp}", str(tmp_path)) for a in REFUSED[case]] + SMALL
    result = CliRunner().invoke(jcli.main, args)
    assert result.exit_code == 2, result.output
    with pytest.raises(SystemExit) as e:
        _port(args)
    assert e.value.code == 2


@pytest.mark.parametrize("name", ["segnet", "darts", "mnistgan"])
def test_registry_builds_the_model_bound_models(name):
    shape, classes = ((28, 28, 1), 1) if name == "mnistgan" else ((16, 16, 3), 4)
    m, jm = create_model(name, "x", shape, classes), jax_create_model(name, "x", shape, classes)
    assert (m.name, m.has_batch_stats, m.has_dropout) == (jm.name, jm.has_batch_stats,
                                                          jm.has_dropout)
    assert all(v.dtype == torch.float32 for v in m.init(torch.Generator().manual_seed(0)).values())


@pytest.mark.parametrize("name", ["gkt_resnet", "vfl"])
def test_names_the_reference_does_not_know_are_key_errors(name):
    with pytest.raises(KeyError, match="unknown model"):
        jax_create_model(name, "cifar10", (32, 32, 3), 10)
    with pytest.raises(KeyError, match="segnet, darts, mnistgan"):
        create_model(name, "cifar10", (32, 32, 3), 10)
