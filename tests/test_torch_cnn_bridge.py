"""The port's FedAvg CNN and the weight bridge: with the reference's init
carried across, both packages give the same logits on the same NHWC batch;
the bridge round-trips exactly; the port's own init follows flax's
defaults."""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from fedml_tpu.models import create_model as jax_create_model  # noqa: E402

from fedml_tpu_torch.bridge import from_flax, to_flax  # noqa: E402
from fedml_tpu_torch.models import create_model  # noqa: E402

SHAPE, CLASSES = (28, 28, 1), 62


def _jax_params(seed=0):
    model = jax_create_model("cnn", "femnist", SHAPE, CLASSES)
    params = model.init(jax.random.PRNGKey(seed))["params"]
    return model, {layer: {k: np.array(v) for k, v in leaves.items()} for layer, leaves in params.items()}


def test_logits_match_reference_with_bridged_params():
    jmodel, params = _jax_params()
    x = np.random.default_rng(0).normal(size=(7,) + SHAPE).astype(np.float32)
    want, _ = jmodel.apply({"params": params}, jax.numpy.asarray(x), train=False)
    tmodel = create_model("cnn", "femnist", SHAPE, CLASSES)
    got, _ = tmodel.apply(from_flax(params), torch.from_numpy(x))
    assert got.shape == (7, CLASSES)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_bridge_round_trip_is_exact():
    _, params = _jax_params(1)
    back = to_flax(from_flax(params))
    assert back.keys() == params.keys()
    for layer in params:
        assert back[layer].keys() == params[layer].keys()
        for leaf in params[layer]:
            assert back[layer][leaf].dtype == params[layer][leaf].dtype
            np.testing.assert_array_equal(back[layer][leaf], params[layer][leaf])


def test_bridge_yields_the_module_state_layout():
    _, params = _jax_params()
    tmodel = create_model("cnn", "femnist", SHAPE, CLASSES)
    state = from_flax(params)
    want = {k: tuple(v.shape) for k, v in tmodel.module.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == want


def test_parameter_count_at_62_classes():
    tmodel = create_model("cnn", "femnist", SHAPE, CLASSES)
    assert tmodel.num_params() == 1_690_046
    _, params = _jax_params()
    assert sum(a.size for leaves in params.values() for a in leaves.values()) == 1_690_046


def test_port_init_follows_flax_defaults():
    tmodel = create_model("cnn", "femnist", SHAPE, CLASSES)
    v = tmodel.init(torch.Generator().manual_seed(0))
    again = tmodel.init(torch.Generator().manual_seed(0))
    for name, t in v.items():
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        torch.testing.assert_close(t, again[name], rtol=0, atol=0)
        if name.endswith("bias"):
            assert not t.any(), name
            continue
        # lecun normal: truncated to two of its (pre-truncation) stddevs,
        # rescaled so the kept values have stddev sqrt(1 / fan_in)
        target = math.sqrt(1.0 / math.prod(t.shape[1:]))
        assert abs(t.std().item() / target - 1) < 0.05, name
        assert t.abs().max().item() <= 2 * target / 0.87962566103423978 + 1e-6, name
