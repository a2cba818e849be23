"""The port's centralized trainer against the reference's on the CPU: the
pooled logistic-regression fixture, 3 epochs of minibatches with the
optimizer's state (momentum, Adam's moments) carried across epochs, the
reference's per-epoch shuffles and rows.

Tolerance: rtol 1e-5, atol 1e-6 on the params and 1e-5 on the rows — the
same float32 steps (12 a epoch) in another library. Besides: every entry
point of this slice (the five APIs, the centralized trainer, the
decentralized driver) runs on the card by default and raises without one."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import fedml_tpu.config as jcfg  # noqa: E402
from fedml_tpu.data.synthetic import synthetic_classification as jax_synthetic  # noqa: E402
from fedml_tpu.train.centralized import CentralizedTrainer as JaxCentralized  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.bridge import from_flax, to_flax  # noqa: E402
from fedml_tpu_torch.data.synthetic import synthetic_classification  # noqa: E402
from fedml_tpu_torch.train.centralized import CentralizedTrainer  # noqa: E402

from torch_parity import (  # noqa: E402
    flat_params, jax_lr_model, lr_config, lr_data, private_reference_programs, torch_lr_model,
)


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


@pytest.mark.parametrize("train", [
    {"lr": 0.1}, {"lr": 0.1, "momentum": 0.9}, {"client_optimizer": "adam", "lr": 0.01},
])
def test_epochs_match_reference(train):
    import dataclasses

    def cfg(mod):
        c = lr_config(mod, train, batch_size=4)
        return c.replace(fed=dataclasses.replace(c.fed, frequency_of_the_test=2))

    jrows, trows = [], []
    ref = JaxCentralized(cfg(jcfg), lr_data(jax_synthetic), jax_lr_model(), log_fn=jrows.append)
    model = torch_lr_model()
    init = from_flax(jax.device_get(ref.global_vars))
    model.init = lambda generator: {k: v.clone() for k, v in init.items()}
    port = CentralizedTrainer(cfg(tcfg), lr_data(synthetic_classification), model, device="cpu",
                              log_fn=trows.append)
    assert ref.train().keys() == port.train().keys()
    want = flat_params(jax.device_get(ref.params))
    got = flat_params(to_flax(port.global_vars))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert len(trows) == len(jrows) == 3
    for t, j in zip(trows, jrows, strict=True):
        assert t.keys() == j.keys()
        for k in j:
            assert abs(t[k] - j[k]) <= 1e-5, (k, t[k], j[k])


def test_mesh_form_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 11"):
        CentralizedTrainer(lr_config(tcfg, {"lr": 0.1}), lr_data(synthetic_classification),
                           torch_lr_model(), mesh=object(), device="cpu")


def test_full_batch_is_one_step_an_epoch():
    trainer = CentralizedTrainer(lr_config(tcfg, {"lr": 0.1}), lr_data(synthetic_classification),
                                 torch_lr_model(), device="cpu")
    assert trainer.batch_size == sum(len(y) for y in trainer.data.client_y)
    before = {k: v.clone() for k, v in trainer.global_vars.items()}
    row = trainer.train_epoch(0)
    assert row["epoch"] == 0 and 0.0 <= row["Train/Acc"] <= 1.0
    assert any(not torch.equal(before[k], v) for k, v in trainer.global_vars.items())


def test_this_slice_s_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """Every entry point this slice adds runs on the card unless the caller
    asks for the CPU, and has no CPU fallback."""
    from fedml_tpu_torch.algorithms import (
        DittoAPI, FedNovaAPI, HierarchicalFedAvgAPI, QFedAvgAPI, ScaffoldAPI,
    )
    from fedml_tpu_torch.algorithms.decentralized import DecentralizedAPI
    from fedml_tpu_torch.partition import SymmetricTopologyManager

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (lr_config(tcfg, {"lr": 0.1}), lr_data(synthetic_classification), torch_lr_model())
    for api in (FedNovaAPI, QFedAvgAPI, HierarchicalFedAvgAPI, ScaffoldAPI, DittoAPI,
                CentralizedTrainer):
        with pytest.raises(RuntimeError, match="CUDA"):
            api(*args)
    topo = SymmetricTopologyManager(4)
    topo.generate_topology()
    with pytest.raises(RuntimeError, match="CUDA"):
        DecentralizedAPI(torch_lr_model(), topo)
