"""The port stands alone: no module of ``fedml_tpu_torch`` (nor chip_smoke.py,
which runs where there is no JAX) imports jax, flax, optax or any module of
``fedml_tpu``; its entry points default to the card and refuse to drop to
the CPU on their own; its copy of the run configuration matches the
reference's field for field."""

import ast
import dataclasses
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import fedml_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(fedml_tpu_torch.__file__).resolve().parent
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax")


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return (
        root in FORBIDDEN_ROOTS
        or root.startswith("jax")
        or name == "fedml_tpu"
        or name.startswith("fedml_tpu.")
    )


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], prefix="fedml_tpu_torch.")
    )


def test_importing_every_port_module_loads_no_jax_or_reference_module():
    mods = ["fedml_tpu_torch"] + _port_modules()
    assert "fedml_tpu_torch.ops.robust_stats" in mods
    assert "fedml_tpu_torch.ops.flash_attention" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120, check=True,
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(mods) <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_source_names_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert bad == [], f"{path.name} imports {bad}"


def test_the_import_guard_tells_the_port_from_the_reference():
    assert _forbidden("fedml_tpu") and _forbidden("fedml_tpu.ops.robust_stats")
    assert _forbidden("jax.numpy") and _forbidden("jaxlib") and _forbidden("optax")
    assert not _forbidden("fedml_tpu_torch") and not _forbidden("fedml_tpu_torch.ops")


def _tiny_api_args():
    from fedml_tpu_torch.config import DataConfig, FedConfig, RunConfig
    from fedml_tpu_torch.data.femnist_synth import femnist_synthetic
    from fedml_tpu_torch.models import create_model

    data = femnist_synthetic(num_clients=3, mean_samples=20)
    cfg = RunConfig(
        data=DataConfig(batch_size=10),
        fed=FedConfig(client_num_in_total=3, client_num_per_round=2, comm_round=1),
    )
    return cfg, data, create_model("cnn", "femnist", (28, 28, 1), 62)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from fedml_tpu_torch.algorithms import FedAvgAPI, RobustFedAvgAPI
    from fedml_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _tiny_api_args()
    for api in (FedAvgAPI, RobustFedAvgAPI):
        with pytest.raises(RuntimeError, match="CUDA"):
            api(*args)
        with pytest.raises(RuntimeError, match="CUDA"):
            api(*args, device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_config_copy_matches_the_reference():
    jcfg = pytest.importorskip("fedml_tpu.config")
    import fedml_tpu_torch.config as tcfg

    jclasses = {n for n, v in vars(jcfg).items() if dataclasses.is_dataclass(v)}
    tclasses = {n for n, v in vars(tcfg).items() if dataclasses.is_dataclass(v)}
    assert jclasses == tclasses and "RunConfig" in tclasses
    for name in sorted(jclasses):
        jfields = {f.name: f for f in dataclasses.fields(getattr(jcfg, name))}
        tfields = {f.name: f for f in dataclasses.fields(getattr(tcfg, name))}
        assert list(jfields) == list(tfields), name
        jdef, tdef = getattr(jcfg, name)(), getattr(tcfg, name)()
        for f in jfields:
            jv, tv = getattr(jdef, f), getattr(tdef, f)
            if dataclasses.is_dataclass(jv):
                jv, tv = dataclasses.asdict(jv), dataclasses.asdict(tv)
            assert jv == tv, f"{name}.{f}"
