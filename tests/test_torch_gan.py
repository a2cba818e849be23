"""FedGAN in the port against the reference on the CPU: the generator and
discriminator (train-mode outputs, gradients, the generator's new running
statistics) and two FedGANAPI rounds with the reference's latent draws
injected through ``z_fn``, from one initial state (the port's seeded init,
handed to the reference's ModelDef), and ``generate``'s range.

Tolerances: the nets' outputs atol 2e-5 and gradients rtol 1e-4 / atol
1e-5 of the largest (float32 matmuls summed in another order; BatchNorm's
1/σ); the loss rows rtol 1e-5 (measured 1.1e-6). After the rounds,
params atol 1e-4 and the generator's statistics atol 1e-4 (measured
4.7e-5 and 2.2e-5), except the biases of G's fc2, fc3 and fc4: the
BatchNorm after each cancels its bias, so the bias's gradient is zero up
to rounding, and Adam, which divides a gradient by its root mean square,
turns that rounding into steps of up to ~lr = 2e-4 of either sign. Those
three are held to 2·lr a local step (LOOSE_BIAS; measured 9.4e-5), and
their effect on the running means (which average the pre-BN
activations, bias included) stays inside the statistics' 1e-4."""

import numpy as np
import pytest
import torch

import fedml_tpu_torch.config as tcfg
from fedml_tpu_torch.algorithms.fedgan import FedGANAPI, make_gan_model_def
from fedml_tpu_torch.bridge import to_flax_variables
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.models import ModelDef, split_stats
from fedml_tpu_torch.models.gan import Discriminator, Generator

from torch_parity import (
    flat_params, private_reference_programs, reference_record, torch_threads, variables_digest,
)

FED = dict(clients=3, samples=24, per_round=2, batch=8, rounds=2, lr=2e-4, seed=0, z_dim=100)
# 2·lr for each of the 3 local steps of each round
LOOSE_BIAS = 2 * FED["lr"] * 3 * FED["rounds"]
PRE_BN_BIASES = ("params/netg/fc2/bias", "params/netg/fc3/bias", "params/netg/fc4/bias")


@pytest.fixture(autouse=True, scope="module")
def _isolated(tmp_path_factory):
    """The port on one thread; the reference with a program cache and an
    executable store of its own (torch_parity.private_reference_programs)."""
    with torch_threads(1), private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _data(make):
    rng = np.random.default_rng(3)
    xs = [np.tanh(rng.normal(0, 1, (FED["samples"], 28, 28, 1))).astype(np.float32)
          for _ in range(FED["clients"])]
    return make(name="mnist_gan", client_x=xs,
                client_y=[np.zeros(FED["samples"], np.int32) for _ in xs],
                test_x=np.zeros((8, 28, 28, 1), np.float32), test_y=np.zeros(8, np.int32),
                num_classes=1)


def _config(cfg_mod):
    return cfg_mod.RunConfig(
        data=cfg_mod.DataConfig(batch_size=FED["batch"]),
        fed=cfg_mod.FedConfig(client_num_in_total=FED["clients"],
                              client_num_per_round=FED["per_round"], comm_round=FED["rounds"],
                              epochs=1),
        train=cfg_mod.TrainConfig(lr=FED["lr"]),
        seed=FED["seed"],
    )


def _jax_z(round_idx, slot, step, shape):
    """The reference's latent draw of (round, cohort slot, step):
    normal(fold_in(split(fold_in(PRNGKey(seed), round + 1), C)[slot], step))."""
    import jax

    key = jax.random.fold_in(jax.random.PRNGKey(FED["seed"]), round_idx + 1)
    key = jax.random.fold_in(jax.random.split(key, FED["per_round"])[slot], step)
    return np.asarray(jax.random.normal(key, shape))


def _inputs():
    rng = np.random.default_rng(4)
    return (rng.normal(size=(6, FED["z_dim"])).astype(np.float32),
            np.tanh(rng.normal(size=(6, 28, 28, 1))).astype(np.float32))


@pytest.fixture(scope="module")
def ref():
    """The reference's G and D outputs and gradients on one batch, and its
    2-round FedGANAPI run, from the port's initial variables."""
    init = make_gan_model_def().init(torch.Generator().manual_seed(1))
    flax_init = to_flax_variables(init)

    def run():
        import jax
        import jax.numpy as jnp
        import optax

        import fedml_tpu.config as jcfg
        from fedml_tpu.algorithms.fedgan import FedGANAPI as JaxGAN
        from fedml_tpu.algorithms.fedgan import make_gan_model_def as jax_gan_def
        from fedml_tpu.data.base import FederatedDataset as JaxDataset
        from fedml_tpu.models.gan import Discriminator as JD
        from fedml_tpu.models.gan import Generator as JG

        z, x = (jnp.asarray(a) for a in _inputs())
        g_vars = {"params": flax_init["params"]["netg"],
                  "batch_stats": flax_init["batch_stats"]["netg"]}
        d_params = flax_init["params"]["netd"]

        def g_loss(params):
            fake, new = JG().apply({**g_vars, "params": params}, z, train=True,
                                   mutable=["batch_stats"])
            return jnp.sum(fake * fake), (fake, new["batch_stats"])

        def d_loss(params):
            logits = JD().apply({"params": params}, x, train=False)
            return optax.sigmoid_binary_cross_entropy(logits, jnp.ones_like(logits)).mean(), logits

        def both(gp, dp):  # one program: one compile
            return (jax.value_and_grad(g_loss, has_aux=True)(gp),
                    jax.value_and_grad(d_loss, has_aux=True)(dp))

        ((_, g_out), g_grads), ((_, d_out), d_grads) = jax.jit(both)(g_vars["params"], d_params)
        model = jax_gan_def()
        model.init = lambda rng: flax_init
        api = JaxGAN(_config(jcfg), _data(JaxDataset), model)
        api.train()
        return dict(g_out=jax.device_get(g_out), g_grads=jax.device_get(g_grads),
                    d_out=d_out, d_grads=jax.device_get(d_grads),
                    global_vars=jax.device_get(api.global_vars), history=list(api.history))

    rec = reference_record("fedgan", dict(FED, init=variables_digest(init)), run)
    rec.init = init
    return rec


def _grads_close(grads, want):
    want = flat_params(want)
    got = flat_params(to_flax_variables(grads)["params"])
    assert got.keys() == want.keys()
    scale = max(float(np.abs(g).max()) for g in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5 * scale, err_msg=k)


def test_generator_and_discriminator_match_the_reference(ref):
    z, x = (torch.from_numpy(a) for a in _inputs())
    g = ModelDef(Generator(), (FED["z_dim"],), 784, has_batch_stats=True)
    g_vars = {k[len("netg."):]: v for k, v in ref.init.items() if k.startswith("netg.")}
    g_vars.update({"batch_stats." + k[len("batch_stats.netg."):]: v
                   for k, v in ref.init.items() if k.startswith("batch_stats.netg.")})
    params, stats = split_stats(g_vars)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    fake, new_vars = g.apply({**p, **stats}, z, train=True)
    assert fake.shape == (6, 28, 28, 1)
    grads = dict(zip(p, torch.autograd.grad(torch.sum(fake * fake), list(p.values()))))
    np.testing.assert_allclose(fake.detach().numpy(), ref.g_out[0], atol=2e-5)
    got_s = flat_params(to_flax_variables({k: new_vars[k] for k in stats})["batch_stats"])
    for k, want in flat_params(ref.g_out[1]).items():
        np.testing.assert_allclose(got_s[k], want, atol=1e-5, err_msg=k)
    _grads_close(grads, ref.g_grads)
    d = Discriminator()
    d_params = {k[len("netd."):]: v.clone().requires_grad_(True)
                for k, v in ref.init.items() if k.startswith("netd.")}
    logits = torch.func.functional_call(d, d_params, (x,))
    loss = torch.nn.functional.binary_cross_entropy_with_logits(logits, torch.ones_like(logits))
    np.testing.assert_allclose(logits.detach().numpy(), ref.d_out, atol=2e-5)
    _grads_close(dict(zip(d_params, torch.autograd.grad(loss, list(d_params.values())))),
                 ref.d_grads)


def test_fedgan_rounds_match_the_reference(ref):
    api = FedGANAPI(_config(tcfg), _data(FederatedDataset), device="cpu",
                    z_fn=lambda r, slot, step, shape: torch.from_numpy(_jax_z(r, slot, step, shape)))
    assert api.global_vars.keys() == ref.init.keys()
    api.global_vars = {k: v.clone() for k, v in ref.init.items()}
    api.train()
    want = flat_params(ref.global_vars)
    got = flat_params(to_flax_variables(api.global_vars))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=LOOSE_BIAS if k in PRE_BN_BIASES
                                   else 1e-4, err_msg=k)
    assert len(api.history) == FED["rounds"]
    for g, w in zip(api.history, ref.history):
        assert g.keys() == w.keys() == {"round", "Train/G_Loss", "Train/D_Loss"}
        for key in ("Train/G_Loss", "Train/D_Loss"):
            assert np.isfinite(g[key])
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=key)
    fake = api.generate(16)
    assert fake.shape == (16, 28, 28, 1) and float(fake.abs().max()) <= 1.0
    assert torch.equal(api.generate(4, seed=3), api.generate(4, seed=3))


def test_default_z_is_seeded_and_the_model_registered():
    from fedml_tpu_torch.models import create_model

    from fedml_tpu.models import create_model as jax_create_model

    m, jm = create_model("mnistgan", "femnist", (28, 28, 1), 1), jax_create_model(
        "mnistgan", "femnist", (28, 28, 1), 1)
    assert (m.name, m.has_batch_stats, m.has_dropout, m.input_shape) == (
        jm.name, jm.has_batch_stats, jm.has_dropout, tuple(jm.input_shape))
    runs = []
    for _ in range(2):
        api = FedGANAPI(_config(tcfg), _data(FederatedDataset), device="cpu")
        api.global_vars = {k: v.clone() for k, v in make_gan_model_def().init(
            torch.Generator().manual_seed(1)).items()}
        api.train_round(0)
        runs.append(api.global_vars)
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k
