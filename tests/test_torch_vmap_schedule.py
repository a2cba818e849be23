"""The batched ("vmap") client schedule of the port on the CPU
(fedml_tpu_torch/train/client.py ``BatchedLocalTrain``,
algorithms/fedavg.py ``resolve_client_parallelism``, the vmap rules of
ops/flash_attention.py and the norms' Functions).

- ``resolve_client_parallelism("auto", …)`` equals the reference's for
  every model name both registries build (its readings kept in
  tests/reference_model_facts.json), and which of them the port batches
  is pinned;
- the batched schedule equals the loop within the reference's own oracle
  tolerance (rtol 1e-5, atol 1e-6; tests/test_fedavg_oracle.py
  ``test_scan_and_vmap_client_schedules_agree``) on ``lr`` + Adam over
  ragged hetero shards, where padding steps occur, with and without
  ``prox_mu`` and under FedAdam; and equals the reference's vmap schedule within the same
  tolerance (float32 summed in other orders: observed ≤ 1.2e-7);
- the cohort trained in groups of clients (``max_clients``, or the size
  a device out of memory leaves) equals the whole cohort bit for bit;
- the narrow LM under vmap equals the loop and the reference, and its
  flash attention runs one folded K2 a layer a batched step;
- ``torch.func.vmap`` of flash attention, forward and ``grad``, equals
  the per-client loop bit for bit on the plain path;
- an explicit "vmap" the port cannot batch raises NotImplementedError
  naming ROADMAP.md §1 item 13; an "auto" that resolves to vmap on such a
  model runs the loop."""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch import cli as tcli  # noqa: E402
from fedml_tpu_torch.algorithms import FedAvgAPI, FedOptAPI  # noqa: E402
from fedml_tpu_torch.algorithms.fedavg import client_schedule, resolve_client_parallelism  # noqa: E402
from fedml_tpu_torch.config import DataConfig, FedConfig, RunConfig, TrainConfig  # noqa: E402
from fedml_tpu_torch.data.synthetic import synthetic_classification  # noqa: E402
from fedml_tpu_torch.models import create_model  # noqa: E402
from fedml_tpu_torch.ops import flash_attention as fa  # noqa: E402
from fedml_tpu_torch.ops.fused_groupnorm import gn_act, ln_act  # noqa: E402
from fedml_tpu_torch.train import optim  # noqa: E402
from fedml_tpu_torch.train.client import batched_schedule_refusal  # noqa: E402

from torch_parity import (  # noqa: E402
    LM_SLICE, REGISTRY_CASES, case_id, flat_params, jax_round_perm_fn, port_model,
    private_reference_programs, reference_model_facts, reference_record, run_lm_slice,
    torch_threads,
)

ORACLE_TOL = dict(rtol=1e-5, atol=1e-6)
# every registry name once (EfficientNet at its default variant)
NAMES = [c for c in REGISTRY_CASES if not c[0].startswith("efficientnet_")
         or c[0] == "efficientnet_b0"]
# the models the batched schedule trains; every other name runs the loop,
# for the reason given
REFUSALS = {
    "lr": None, "cnn": None, "transformer": None,
    "resnet18_gn": None, "resnet34_gn": None, "resnet50_gn": None, "resnet101_gn": None,
    "resnet152_gn": None,
    "cnn_dropout": "dropout", "vgg11": "dropout", "vgg13": "dropout", "vgg16": "dropout",
    "vgg19": "dropout", "rnn": "an LSTM",
    "resnet56": "running statistics", "resnet110": "running statistics",
    "mobilenet": "running statistics", "mobilenet_v3": "running statistics",
    "vgg11_bn": "running statistics", "vgg13_bn": "running statistics",
    "vgg16_bn": "running statistics", "vgg19_bn": "running statistics",
    "efficientnet_b0": "running statistics", "segnet": "running statistics",
    "darts": "running statistics", "mnistgan": "running statistics",
}


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    """The reference compiles into a program cache and an executable store
    of its own (torch_parity.private_reference_programs)."""
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


@pytest.fixture(scope="module")
def facts():
    return reference_model_facts(NAMES)


@pytest.mark.parametrize("case", NAMES, ids=case_id)
def test_auto_resolution_matches_reference_and_the_batched_list_is_pinned(case, facts):
    model = port_model(case)
    mode = resolve_client_parallelism("auto", model)
    assert mode == facts[case_id(case)]["mode"]
    assert batched_schedule_refusal(model, TrainConfig()) == REFUSALS[case[0]]
    batched = REFUSALS[case[0]] is None
    assert client_schedule(mode, model, TrainConfig()) == ("vmap" if batched and mode == "vmap"
                                                           else "loop")
    assert client_schedule("vmap", model, TrainConfig()) == ("vmap" if batched else "loop")
    assert client_schedule("scan", model, TrainConfig()) == "loop"


def _oracle(cfg_mod, schedule, prox_mu, server=None):
    """The reference's schedule-agreement oracle: lr on ragged hetero
    shards of 8 clients, 5 a round, batch 8, E=2, Adam lr 0.05, 3 rounds
    (``server``: a FedOpt server optimizer)."""
    return cfg_mod.RunConfig(
        data=cfg_mod.DataConfig(batch_size=8),
        fed=cfg_mod.FedConfig(client_num_in_total=8, client_num_per_round=5, comm_round=3,
                              epochs=2, frequency_of_the_test=10_000,
                              client_parallelism=schedule),
        train=cfg_mod.TrainConfig(client_optimizer="adam", lr=0.05, prox_mu=prox_mu),
        server=cfg_mod.ServerConfig(**(server or {})),
        seed=0,
    )


def _oracle_data(synthetic):
    return synthetic(num_clients=8, num_classes=3, feat_shape=(6,), samples_per_client=16,
                     partition_method="hetero", ragged=False, seed=0)


def _port_rounds(schedule, prox_mu, init=None, perm_fn=None, server=None):
    model = create_model("lr", "synthetic", (6,), 3)
    if init is not None:
        model.init = lambda generator: {k: v.clone() for k, v in init.items()}
    api = (FedOptAPI if server else FedAvgAPI)(
        _oracle(tcfg, schedule, prox_mu, server), _oracle_data(synthetic_classification), model,
        device="cpu", perm_fn=perm_fn)
    rows = []
    for r in range(3):
        _, mets = api.train_round(r)
        rows.append({k: float(v) for k, v in mets.items()})
    return api, rows


FEDADAM = dict(server_optimizer="adam", server_lr=0.05)


@pytest.mark.parametrize("prox_mu,server", [(0.0, None), (0.1, None), (0.0, FEDADAM)],
                         ids=["fedavg", "fedprox", "fedadam"])
def test_vmap_schedule_equals_the_loop(prox_mu, server):
    vm, vm_rows = _port_rounds("vmap", prox_mu, server=server)
    lp, lp_rows = _port_rounds("scan", prox_mu, server=server)
    assert (vm._client_mode, vm._client_schedule) == ("vmap", "vmap")
    assert (lp._client_mode, lp._client_schedule) == ("scan", "loop")
    for k in lp.global_vars:
        np.testing.assert_allclose(vm.global_vars[k].numpy(), lp.global_vars[k].numpy(),
                                   err_msg=k, **ORACLE_TOL)
    # the counts are exact; "steps" counts only the real (unpadded) steps
    for a, b in zip(vm_rows, lp_rows):
        assert (a["count"], a["steps"], a["correct"]) == (b["count"], b["steps"], b["correct"])
        np.testing.assert_allclose(a["loss_sum"], b["loss_sum"], rtol=1e-6)
    assert lp_rows[0]["steps"] < 5 * 2 * 3  # some client had padding steps


@pytest.mark.parametrize("prox_mu", [0.0, 0.1])
def test_vmap_schedule_matches_the_reference_vmap(prox_mu):
    def run():
        import fedml_tpu.config as jcfg
        from fedml_tpu.algorithms import FedAvgAPI as JaxFedAvg
        from fedml_tpu.data.synthetic import synthetic_classification as jax_synthetic
        from fedml_tpu.models import create_model as jax_create_model

        japi = JaxFedAvg(_oracle(jcfg, "vmap", prox_mu), _oracle_data(jax_synthetic),
                         jax_create_model("lr", "synthetic", (6,), 3))
        assert japi._client_mode == "vmap"
        init = jax.device_get(japi.global_vars)
        for r in range(3):
            japi.train_round(r)
        return dict(init=init, global_vars=jax.device_get(japi.global_vars))

    from fedml_tpu_torch.bridge import from_flax

    ref = reference_record("oracle_vmap", dict(prox_mu=prox_mu), run)
    api, _ = _port_rounds("vmap", prox_mu, init=from_flax(ref.init),
                          perm_fn=jax_round_perm_fn(0, 5))
    assert api._client_schedule == "vmap"
    want = from_flax(ref.global_vars)
    for k in want:
        np.testing.assert_allclose(api.global_vars[k].numpy(), want[k].numpy(), err_msg=k,
                                   **ORACLE_TOL)


def test_narrow_lm_under_vmap_matches_the_loop_and_the_reference(monkeypatch):
    """The LM slice (2 layers, 2 heads, 32 wide, flash attention in blocks
    of 32, SGD lr 0.1, float32) with the port's clients batched: within
    the LM slice's own tolerance of the reference (tests/
    test_torch_fed_transformer.py), and of the port's loop within the
    oracle's. Every flash forward of a train step takes the whole cohort
    folded into BH: C·B·H rows."""
    calls = []
    real = fa.flash_forward

    def counted(q, *a, **k):
        calls.append(q.shape[0])
        return real(q, *a, **k)

    monkeypatch.setattr(fa, "flash_forward", counted)
    with torch_threads(2):
        ref, tapi, _ = run_lm_slice("float32", "sgd", 0.1, port_schedule="vmap")
        monkeypatch.setattr(fa, "flash_forward", real)
        _, loop, _ = run_lm_slice("float32", "sgd", 0.1, port_schedule="scan")
    assert (tapi._client_mode, tapi._client_schedule) == ("vmap", "vmap")
    from fedml_tpu_torch.bridge import to_flax

    got, want = flat_params(to_flax(tapi.global_vars)), flat_params(ref.global_vars["params"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    for k in tapi.global_vars:
        np.testing.assert_allclose(tapi.global_vars[k].numpy(), loop.global_vars[k].numpy(),
                                   err_msg=k, **ORACLE_TOL)
    for a, b in zip(tapi.history, loop.history):
        assert abs(a["Train/Loss"] - b["Train/Loss"]) <= 1e-6
    s = LM_SLICE
    folded = s["num_clients"] * s["batch"] * s["heads"]
    steps = s["rounds"] * -(-s["samples_per_client"] // s["batch"])  # equal shards
    assert calls.count(folded) == s["layers"] * steps


def _qkv(C, shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((C,) + shape, generator=g).to(dtype) for _ in range(4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_under_vmap_equals_the_per_client_loop_bit_for_bit(dtype):
    C, shape = 3, (2, 32, 2, 16)  # [C, B, T, H, D]
    q, k, v, w = _qkv(C, shape, dtype, 0)
    attn = functools.partial(fa.flash_attention_bthd, block_q=16, block_k=16)

    def loss(q, k, v, w):
        return torch.sum(attn(q, k, v).float() * w.float())

    out = torch.func.vmap(attn)(q, k, v)
    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(q, k, v, w)
    # k and v broadcast to every client (in_dims None): folded by expanding
    out_b = torch.func.vmap(attn, in_dims=(0, None, None))(q, k[0], v[0])
    for i in range(C):
        assert torch.equal(out[i], attn(q[i], k[i], v[i]))
        assert torch.equal(out_b[i], attn(q[i], k[0], v[0]))
        qi, ki, vi = (t[i].clone().requires_grad_(True) for t in (q, k, v))
        want = torch.autograd.grad(loss(qi, ki, vi, w[i]), (qi, ki, vi))
        for got_g, want_g in zip(grads, want):
            assert torch.equal(got_g[i], want_g)


def test_norm_functions_batch_under_vmap():
    """LayerNorm (the LM's), GroupNorm and the bf16 rounding of the norms'
    affine parameters, forward and gradient, under vmap against the loop."""
    from fedml_tpu_torch.train.client import _RoundTo

    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 4, 6, 8, generator=g)
    gamma, beta = torch.randn(3, 8, generator=g), torch.randn(3, 8, generator=g)
    xc = torch.randn(3, 2, 4, 5, 5, generator=g)  # NCHW for GroupNorm on axis 1

    def ln(x, gm, b):
        return torch.sum(ln_act(x, _RoundTo.apply(gm, torch.bfloat16), b, 1e-6, True) ** 2)

    def gn(x, gm, b):
        return torch.sum(gn_act(x, gm[:4], b[:4], 2, 1e-6, True, channel_axis=1) ** 2)

    for f, xs in ((ln, x), (gn, xc)):
        got = torch.func.vmap(torch.func.grad_and_value(f, argnums=(0, 1, 2)))(xs, gamma, beta)
        for i in range(3):
            want = torch.func.grad_and_value(f, argnums=(0, 1, 2))(xs[i], gamma[i], beta[i])
            torch.testing.assert_close(got[1][i], want[1], rtol=1e-6, atol=1e-6)
            for a, b in zip(got[0], want[0]):
                torch.testing.assert_close(a[i], b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("grouping", ["max_clients", "out_of_memory"])
def test_batched_cohort_in_groups_equals_the_whole_cohort(grouping):
    """The cohort trained in groups of clients gives the whole cohort's
    numbers bit for bit: lr + Adam, E=2, on ragged shards (padding steps)
    of 5 clients, in groups of 2, 2 and 1, set by ``max_clients`` or left
    by a device that runs out of memory on more than 2 clients at once (the
    group is retried at half its size, and the size is kept)."""
    from fedml_tpu_torch.algorithms.fedavg import round_client_perms
    from fedml_tpu_torch.train.client import BatchedLocalTrain, seeded_perm_fn

    C, S, B, F = 5, 3, 4, 6
    model = create_model("lr", "synthetic", (F,), 3)
    init = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(C, S, B, F, generator=g)
    y = torch.randint(0, 3, (C, S, B), generator=g)
    n = torch.tensor([12, 7, 3, 1, 9])
    mask = (torch.arange(S * B)[None] < n[:, None]).float().reshape(C, S, B)
    perms = round_client_perms(seeded_perm_fn(0), 0, C)
    tc = TrainConfig(client_optimizer="adam", lr=0.05)
    whole = BatchedLocalTrain(model, tc, 2)(init, x, y, mask, perms)
    grouped = BatchedLocalTrain(model, tc, 2)
    if grouping == "max_clients":
        grouped.max_clients, sizes = 2, None
    else:
        sizes = []
        real = grouped._train_group

        def fits_two(global_vars, x, *rest):
            sizes.append(x.shape[0])
            if x.shape[0] > 2:
                raise torch.cuda.OutOfMemoryError("more than 2 clients")
            return real(global_vars, x, *rest)

        grouped._train_group = fits_two
    got = grouped(init, x, y, mask, perms)
    assert grouped.max_clients == 2
    if sizes is not None:
        assert sizes == [5, 2, 2, 1]  # 5 fails, then 2, 2 and the last 1
    for k in whole[0]:
        assert torch.equal(got[0][k], whole[0][k]), k
    assert torch.equal(got[1], whole[1])
    assert whole[1][:, 3].tolist() == [6, 4, 2, 2, 6]  # real steps only: ⌈n/B⌉ an epoch


def test_per_client_adam_counts_take_the_host_products():
    """The batched schedule's per-client step counts gather 1 − βⁿ from a
    table: bit-equal to the loop's host products for every count (of a
    table longer than 1,000: every 7th, and the last 50), past the table's
    end included, and under vmap."""
    for decay in (0.9, 0.99, 0.999):
        n_max = optim._bias_table(decay).shape[0] + 5
        counts = torch.arange(n_max)
        if n_max > 1000:
            counts = torch.cat([counts[:-50:7], counts[-50:]])
        got = optim._bias_correction(decay, counts, "cpu")
        vm = torch.func.vmap(lambda c: optim._bias_correction(decay, c, "cpu"))(counts)
        want = torch.stack([optim._bias_correction(decay, int(n), "cpu") for n in counts])
        assert torch.equal(got, want) and torch.equal(vm, want)


def test_explicit_vmap_refusals_and_auto_fallback():
    data = synthetic_classification(num_clients=4, num_classes=3, feat_shape=(8, 8, 3),
                                    samples_per_client=4, seed=0)

    def cfg(mode):
        return RunConfig(data=DataConfig(batch_size=2),
                         fed=FedConfig(client_num_in_total=4, client_num_per_round=2,
                                       comm_round=1, client_parallelism=mode))

    for name in ("cnn_dropout", "resnet56", "vgg11_bn"):
        with torch.device("meta"):
            model = create_model(name, "cifar10", (8, 8, 3), 3)
        with pytest.raises(NotImplementedError, match="item 13"):
            FedAvgAPI(cfg("vmap"), data, model, device="cpu")
    # an algorithm whose round runs the loop refuses an explicit vmap too
    from fedml_tpu_torch.algorithms.fedavg_robust import RobustFedAvgAPI
    from fedml_tpu_torch.robustness.robust_aggregation import RobustConfig

    flat = synthetic_classification(num_clients=4, num_classes=3, feat_shape=(6,),
                                    samples_per_client=4, seed=0)
    lr_model = create_model("lr", "synthetic", (6,), 3)
    with pytest.raises(NotImplementedError, match="item 13"):
        RobustFedAvgAPI(cfg("vmap"), flat, lr_model, robust=RobustConfig(defense_type="median"),
                        device="cpu")
    assert RobustFedAvgAPI(cfg("auto"), flat, lr_model, robust=RobustConfig(defense_type="median"),
                           device="cpu")._client_schedule == "loop"
    # "auto" resolving to vmap on a model the port cannot batch: the loop
    text = synthetic_classification(num_clients=4, num_classes=3, feat_shape=(8, 8, 3),
                                    samples_per_client=4, seed=0)
    seg = create_model("segnet", "seg_synth", (8, 8, 3), 3, width=4)
    api = FedAvgAPI(cfg("auto"), text, seg, device="cpu")
    assert (api._client_mode, api._client_schedule) == ("vmap", "loop")


def test_cli_runs_the_batched_schedule(tmp_path):
    """``--client_parallelism vmap`` through ``python -m fedml_tpu_torch``'s
    main: the same rounds as ``scan`` within the oracle's tolerance."""
    apis = {}
    for mode in ("vmap", "scan"):
        apis[mode] = tcli.main(["--client_parallelism", mode, "--comm_round", "2",
                                "--client_num_per_round", "4", "--batch_size", "4",
                                "--log_dir", str(tmp_path / mode)], device="cpu")
    assert apis["vmap"]._client_schedule == "vmap" and apis["scan"]._client_schedule == "loop"
    for k, v in apis["scan"].global_vars.items():
        np.testing.assert_allclose(apis["vmap"].global_vars[k].numpy(), v.numpy(), err_msg=k,
                                   **ORACLE_TOL)
