"""FedGKT in the port against the reference on the CPU: the T²·KL loss, both
GKT nets (train-mode outputs, gradients and new statistics) and two
FedGKTAPI rounds at client ``blocks=1``, server ``layers=(1, 1)`` on 8×8
inputs — round 0 on CE alone, round 1 distilling the server's logits —
both from one set of initial variables: the port's seeded init, handed to
the port's API through its ``client_init_fn`` and ``server_init`` hooks
and to the reference's API as its state (the reference's own init costs
~15 s of XLA compiles on the CPU).

Tolerances: kl_loss rtol 1e-5 (float32 softmax and log in another
order); the nets' outputs atol 2e-5 and gradients rtol 1e-4 / atol 1e-5 of
the largest (convolutions summed in another order, amplified by
BatchNorm's 1/σ); after the rounds, variables atol 2e-5 and the
server-logit cache atol 5e-5 (12 client and 8 server SGD-momentum steps
carry the rounding of every step; measured 9.5e-7 and 3.7e-6), and the
end-to-end accuracy within one test sample."""

import numpy as np
import pytest
import torch

from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI, kl_loss
from fedml_tpu_torch.bridge import from_flax, to_flax_variables
from fedml_tpu_torch.models import ModelDef, split_stats
from fedml_tpu_torch.models.gkt_resnet import GKTClientResNet, GKTServerResNet

from torch_parity import (
    flat_params, private_reference_programs, reference_record, torch_threads, variables_digest,
)

H, CLASSES, N, BATCH, LR = 8, 3, 32, 16, 0.05
ROUNDS = 2


@pytest.fixture(autouse=True, scope="module")
def _isolated(tmp_path_factory):
    """The port on one thread; the reference with a program cache and an
    executable store of its own (torch_parity.private_reference_programs)."""
    with torch_threads(1), private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def test_kl_loss_matches_the_reference():
    import jax.numpy as jnp

    from fedml_tpu.algorithms.fedgkt import kl_loss as jax_kl

    rng = np.random.default_rng(0)
    s, t = (rng.normal(size=(6, 5)).astype(np.float32) * 3 for _ in range(2))
    for temp in (1.0, 3.0):
        got = float(kl_loss(torch.from_numpy(s), torch.from_numpy(t), temp))
        want = float(jax_kl(jnp.asarray(s), jnp.asarray(t), temp))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float(kl_loss(torch.from_numpy(s), torch.from_numpy(s))) < 1e-5


def _clients():
    rng = np.random.default_rng(2)
    means = rng.normal(0, 2, size=(CLASSES, H * H * 3))
    out = []
    for _ in range(2):
        y = rng.integers(0, CLASSES, N)
        x = (means[y] + rng.normal(0, 0.5, (N, H * H * 3))).astype(np.float32)
        out.append((x.reshape(-1, H, H, 3), y.astype(np.int32)))
    return out


def _batch():
    rng = np.random.default_rng(3)
    return (rng.normal(size=(5, H, H, 3)).astype(np.float32),
            rng.integers(0, CLASSES, 5).astype(np.int32),
            rng.normal(size=(5, CLASSES)).astype(np.float32))


def _inits():
    """(a client's initial variables, by client index; the server's): the
    port's defaults for seed 0."""
    api = FedGKTAPI(num_classes=CLASSES, input_shape=(H, H, 3), client_blocks=1,
                    server_layers=(1, 1), device="cpu")
    return api.client_init_fn, api.server_vars


@pytest.fixture(scope="module")
def ref():
    """The reference's nets' train-mode outputs and gradients on one batch,
    and 2 rounds' caches, variables and accuracy of its API, from the
    port's initial variables."""
    client_init_fn, server_init = _inits()
    clients = _clients()
    client_init = [to_flax_variables(client_init_fn(ci)) for ci in range(len(clients))]
    server_init = to_flax_variables(server_init)

    def run():
        import contextlib

        import jax
        import jax.numpy as jnp
        import optax

        from fedml_tpu.algorithms.fedgkt import FedGKTAPI as JaxGKT
        from fedml_tpu.algorithms.fedgkt import kl_loss as jax_kl
        from fedml_tpu.models.gkt_resnet import GKTServerResNet as JaxServer

        # the constructor's server init returns the shared variables
        with contextlib.ExitStack() as stack:
            stack.callback(setattr, JaxServer, "init", JaxServer.init)
            JaxServer.init = lambda self, *a, **kw: server_init
            api = JaxGKT(num_classes=CLASSES, input_shape=(H, H, 3), client_blocks=1,
                         server_layers=(1, 1), lr=LR)
        api.client_vars.update(enumerate(client_init))
        x, y, teacher = (jnp.asarray(a) for a in _batch())

        def client_loss(params):
            (feats, logits), new = api.client_net.apply(
                {**client_init[0], "params": params}, x, train=True, mutable=["batch_stats"])
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
            return ce + jax_kl(logits, teacher, 3.0), (feats, logits, new["batch_stats"])

        def server_loss(params, feats):
            logits, new = api.server_net.apply(
                {**server_init, "params": params}, feats, train=True, mutable=["batch_stats"])
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
            return ce + jax_kl(logits, teacher, 3.0), (logits, new["batch_stats"])

        def both(cp, sp):  # one program: one compile
            (_, c_out), c_grads = jax.value_and_grad(client_loss, has_aux=True)(cp)
            return (c_out, c_grads), jax.value_and_grad(server_loss, has_aux=True)(sp, c_out[0])

        (c_out, c_grads), ((_, s_out), s_grads) = jax.jit(both)(
            client_init[0]["params"], server_init["params"])
        caches, cache = [], None
        for _ in range(ROUNDS):
            cache = api.train_round(clients, batch_size=BATCH, server_logits_cache=cache)
            caches.append(cache)
        return dict(
            client_out=jax.device_get(c_out), client_grads=jax.device_get(c_grads),
            server_out=jax.device_get(s_out), server_grads=jax.device_get(s_grads),
            caches=[{str(k): v for k, v in c.items()} for c in caches],
            client_vars=[jax.device_get(api.client_vars[ci]) for ci in range(len(clients))],
            server_vars=jax.device_get(api.server_vars),
            acc=api.evaluate(clients[0][0], clients[0][1], client_id=0),
        )

    rec = reference_record("fedgkt", dict(
        H=H, classes=CLASSES, n=N, batch=BATCH, lr=LR, rounds=ROUNDS,
        init=[variables_digest(client_init_fn(ci)) for ci in range(len(clients))] + [variables_digest(
            from_flax(server_init))]), run)
    rec.client_init, rec.server_init = client_init, server_init
    return rec


def _assert_tree_close(got, want, atol, rtol=0.0, what=""):
    want, got = flat_params(want), flat_params(got)
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def _step_outputs(model, variables, x, loss_of):
    params, stats = split_stats(variables)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    out, new_vars = model.apply({**p, **stats}, x, train=True)
    grads = dict(zip(p, torch.autograd.grad(loss_of(out), list(p.values()))))
    return out, grads, {k: new_vars[k] for k in stats}


def _assert_grads(grads, want):
    scale = max(float(np.abs(g).max()) for g in flat_params(want).values())
    _assert_tree_close(to_flax_variables(grads)["params"], want, 1e-5 * scale, 1e-4, "grads")


def test_gkt_nets_match_the_reference(ref):
    x, y, teacher = (torch.from_numpy(a) for a in _batch())
    y = y.long()
    client = ModelDef(GKTClientResNet(CLASSES, blocks=1), (H, H, 3), CLASSES,
                      has_batch_stats=True)
    server = ModelDef(GKTServerResNet(CLASSES, layers=(1, 1)), (H, H, 16), CLASSES,
                      has_batch_stats=True)
    ce_kl = lambda logits: (torch.nn.functional.cross_entropy(logits, y)
                            + kl_loss(logits, teacher, 3.0))
    (feats, logits), grads, stats = _step_outputs(
        client, from_flax(ref.client_init[0]), x, lambda out: ce_kl(out[1]))
    assert feats.shape == (5, H, H, 16)
    np.testing.assert_allclose(feats.detach().numpy(), ref.client_out[0], atol=2e-5)
    np.testing.assert_allclose(logits.detach().numpy(), ref.client_out[1], atol=2e-5)
    _assert_tree_close(to_flax_variables(stats)["batch_stats"], ref.client_out[2], 2e-5)
    _assert_grads(grads, ref.client_grads)
    s_logits, grads, stats = _step_outputs(
        server, from_flax(ref.server_init), torch.from_numpy(ref.client_out[0]), ce_kl)
    np.testing.assert_allclose(s_logits.detach().numpy(), ref.server_out[0], atol=2e-5)
    _assert_tree_close(to_flax_variables(stats)["batch_stats"], ref.server_out[1], 2e-5)
    _assert_grads(grads, ref.server_grads)


def test_fedgkt_rounds_match_the_reference(ref):
    clients = _clients()
    api = FedGKTAPI(num_classes=CLASSES, input_shape=(H, H, 3), client_blocks=1,
                    server_layers=(1, 1), lr=LR, device="cpu",
                    client_init_fn=lambda ci: from_flax(ref.client_init[ci]),
                    server_init=from_flax(ref.server_init))
    assert not api.client_vars  # each client's init is drawn at its first round
    cache = None
    for r in range(ROUNDS):
        cache = api.train_round(clients, batch_size=BATCH, server_logits_cache=cache)
        assert set(cache) == {0, 1}
        for ci in cache:
            assert cache[ci].shape == (N, CLASSES)
            np.testing.assert_allclose(cache[ci], ref.caches[r][str(ci)], atol=5e-5,
                                       err_msg=f"round {r} client {ci}")
    assert set(api.stage_s) == {"clients", "server", "logits_back"}
    for ci in range(len(clients)):
        _assert_tree_close(to_flax_variables(api.client_vars[ci]), ref.client_vars[ci], 2e-5,
                           what=f"client {ci}")
    _assert_tree_close(to_flax_variables(api.server_vars), ref.server_vars, 2e-5, what="server")
    acc = api.evaluate(clients[0][0], clients[0][1], client_id=0)
    assert abs(acc - ref.acc) <= 1.0 / N
