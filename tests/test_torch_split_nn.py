"""Split learning in the port against the reference on the CPU
(fedml_tpu_torch/algorithms/split_nn.py, splitfed/programs.py).

The port's init is carried to the reference through the weight bridge
(``bridge.split_to_flax``), and so are the SGD-momentum traces, so both
packages start from one state. Reference runs go through
``torch_parity.reference_record`` under ``private_reference_programs``.

Tolerances: the fused step over 5 SGD-momentum steps (lr 0.1, momentum
0.9, wd 5e-4), params and traces within 1e-5 of each tensor's largest
magnitude and losses rtol 1e-5: the two packages sum the same float32
convolutions and matmuls in other orders, and momentum carries each step's
rounding on (measured ≤ 1e-6). A ring round and its eval: params within
1e-5 of the largest, Test/Acc within one test sample (a logit pair that
close may rank the other way). The boundary composition against the
port's own fused step: bit-equal, as the reference pins its own."""

import numpy as np
import pytest
import torch

from fedml_tpu_torch.algorithms.split_nn import (
    SplitNNAPI,
    default_split_models,
    init_split_vars,
    split_step_with_boundary,
)
from fedml_tpu_torch.bridge import split_from_flax, split_to_flax
from fedml_tpu_torch.splitfed import programs as P

from torch_parity import private_reference_programs, reference_record, torch_threads, variables_digest

LR, MOM, WD = 0.1, 0.9, 5e-4
PARAM_TOL = 1e-5  # of each tensor's largest magnitude
SHAPES = {"flat": (10,), "image": (6, 6, 1)}


@pytest.fixture(autouse=True, scope="module")
def _isolated(tmp_path_factory):
    with torch_threads(1), private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _close(got: dict, want: dict, what: str, tol: float = PARAM_TOL):
    assert set(got) == set(want), what
    for k in want:
        g, w = got[k].detach().cpu().numpy(), np.asarray(want[k])
        assert g.shape == w.shape, (what, k)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale, (what, k, float(np.abs(g - w).max()))


def _equal(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k in want:
        assert torch.equal(got[k], want[k]), (what, k)


def _batches(shape, classes, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8) + shape).astype(np.float32)
    y = rng.integers(0, classes, size=(n, 8)).astype(np.int32)
    return x, y


def _traces(groups, seed):
    """Nonzero momentum traces for a state carried into both packages."""
    gen = torch.Generator().manual_seed(seed)
    return {g: {k: 0.01 * torch.randn(v.shape, generator=gen) for k, v in d.items()}
            for g, d in groups.items()}


@pytest.mark.parametrize("shape", [(10,), (8, 8, 1), (9, 9, 2), (11, 7, 3), (28, 28, 1)])
def test_cut_width_and_layout_match_the_reference(shape):
    """The top's input width (read by running the bottom on a zero batch)
    and every leaf's name and shape, in flax layout, are the reference's
    (its width from an abstract eval of the cut, its leaves from
    ``jax.eval_shape`` of the init: nothing is compiled)."""
    import jax

    from fedml_tpu.algorithms.split_nn import default_split_models as jax_models

    bottom, top = default_split_models(shape, 62)
    jb, jt = jax_models(shape, 62)
    assert top.input_shape == jt.input_shape
    b, t = init_split_vars(bottom, top, 0)
    flax = split_to_flax({"bottom": b, "top": t})
    back = split_from_flax(flax)
    _equal(back["bottom"], b, "bridge bottom")
    _equal(back["top"], t, "bridge top")
    for half, model in (("bottom", jb), ("top", jt)):
        want = jax.eval_shape(model.init, jax.random.PRNGKey(0))["params"]
        assert jax.tree_util.tree_structure(flax[half]) == jax.tree_util.tree_structure(want)
        for g, w in zip(jax.tree_util.tree_leaves(flax[half]), jax.tree_util.tree_leaves(want)):
            assert g.shape == w.shape and g.dtype == w.dtype
    with torch.no_grad():
        acts = bottom.module(torch.zeros((2,) + shape))
        assert top.module(acts).shape == (2, 62)


def _jax_split_state(jb, jt, groups, traces):
    """The reference's fused optimizer state over the carried params, with
    the carried traces."""
    import optax

    from fedml_tpu.splitfed.programs import make_split_optimizer

    opt = make_split_optimizer(LR, MOM, WD)
    state = opt.init(groups)
    decay, (trace, sgd_rest) = state
    return opt, (decay, (trace._replace(trace=traces), sgd_rest)), optax


@pytest.mark.parametrize("geometry", sorted(SHAPES))
def test_fused_step_matches_the_reference_over_five_steps(geometry):
    shape, classes = SHAPES[geometry], 3
    bottom, top = default_split_models(shape, classes)
    b, t = init_split_vars(bottom, top, 1)
    traces = _traces({"bottom": b, "top": t}, 2)
    xs, ys = _batches(shape, classes, 5, 3)

    def run():
        import jax

        from fedml_tpu.algorithms.split_nn import default_split_models as jax_models
        from fedml_tpu.splitfed.programs import make_splitnn_fused_step

        jb, jt = jax_models(shape, classes)
        params = split_to_flax({"bottom": b, "top": t})
        _, state, _ = _jax_split_state(jb, jt, params, split_to_flax(traces))
        step = make_splitnn_fused_step(jb, jt, lr=LR, momentum=MOM, wd=WD)
        losses = []
        for x, y in zip(xs, ys):
            params, state, loss, _ = step(params, state, x, y)
            losses.append(float(loss))
        return {"params": jax.device_get(params), "trace": jax.device_get(state[1][0].trace),
                "losses": losses}

    want = reference_record("splitnn_fused_5", {"shape": shape, "digest": variables_digest(
        {**{"b." + k: v for k, v in b.items()}, **{"t." + k: v for k, v in t.items()}})}, run)
    step = P.make_splitnn_fused_step(bottom, top, lr=LR, momentum=MOM, wd=WD)
    opt = P.make_split_optimizer(LR, MOM, WD)
    state = opt.init(P.join([b, t], P.GROUPS))
    state = (state[0], (state[1][0]._replace(trace=P.join([traces["bottom"], traces["top"]],
                                                           P.GROUPS)), state[1][1]))
    params, losses = {"bottom": b, "top": t}, []
    for x, y in zip(xs, ys):
        params, state, loss, _ = step(params, state, torch.from_numpy(x),
                                      torch.from_numpy(y).long())
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want.losses, rtol=1e-5)
    want_p = split_from_flax(want.params)
    want_t = split_from_flax(want.trace)
    got_t = dict(zip(P.GROUPS, P.unjoin(state[1][0].trace, P.GROUPS)))
    for g in P.GROUPS:
        _close(params[g], {k: v.numpy() for k, v in want_p[g].items()}, f"{g} params")
        _close(got_t[g], {k: v.numpy() for k, v in want_t[g].items()}, f"{g} trace")


@pytest.mark.parametrize("geometry", sorted(SHAPES))
def test_boundary_composition_equals_the_fused_step_bitwise(geometry):
    """client_forward → server_step → client_backward over per-group
    optimizer states, with the activations and their gradients crossing as
    numpy, equals the fused step over the joint params, bit for bit; and
    ``split_step_with_boundary`` gives the fused gradients."""
    shape, classes = SHAPES[geometry], 3
    bottom, top = default_split_models(shape, classes)
    bp, tp = init_split_vars(bottom, top, 0)
    fused = P.make_splitnn_fused_step(bottom, top, lr=LR, momentum=MOM, wd=WD)
    fwd = P.make_splitnn_client_forward(bottom)
    srv = P.make_splitnn_server_step(top, LR, MOM, WD)
    bwd = P.make_splitnn_client_backward(bottom, LR, MOM, WD)
    opt = P.make_split_optimizer(LR, MOM, WD)
    params = {"bottom": bp, "top": tp}
    fused_state = opt.init(P.join([bp, tp], P.GROUPS))
    b_state, t_state = P.split_opt_state(fused_state)
    xs, ys = _batches(shape, classes, 4, 3)
    for x, y in zip(xs, ys):
        x, y = torch.from_numpy(x), torch.from_numpy(y).long()
        params, fused_state, loss_f, _ = fused(params, fused_state, x, y)
        acts = fwd(bp, x).numpy()
        tp, t_state, loss_b, _, acts_grad = srv(tp, t_state, torch.from_numpy(acts), y)
        bp, b_state = bwd(bp, b_state, x, torch.from_numpy(acts_grad.numpy()))
        assert torch.equal(loss_f, loss_b)
        _equal(params["bottom"], bp, "bottom")
        _equal(params["top"], tp, "top")
    merged = P.merge_opt_state(b_state, t_state)
    _equal(merged[1][0].trace, fused_state[1][0].trace, "merged trace")
    # one fused step from zero traces leaves the gradient as its trace
    b0, t0 = init_split_vars(bottom, top, 0)
    state0 = opt.init(P.join([b0, t0], P.GROUPS))
    x, y = torch.from_numpy(xs[0]), torch.from_numpy(ys[0]).long()
    _, state1, _, _ = fused({"bottom": b0, "top": t0}, state0, x, y)
    _, bg, tg = split_step_with_boundary(bottom, top, b0, t0, x, y)
    g_b, g_t = P.unjoin(state1[1][0].trace, P.GROUPS)
    # the trace is g + wd·p: the boundary gradients plus the same decay
    _equal(g_b, {k: bg[k] + WD * b0[k] for k in bg}, "bottom gradients")
    _equal(g_t, {k: tg[k] + WD * t0[k] for k in tg}, "top gradients")


def test_merge_and_split_opt_state_round_trip():
    bottom, top = default_split_models((8, 8, 1), 3)
    b, t = init_split_vars(bottom, top, 0)
    traces = _traces({"bottom": b, "top": t}, 5)
    opt = P.make_split_optimizer(LR, MOM, WD)
    b_state = opt.init(b)
    b_state = (b_state[0], (b_state[1][0]._replace(trace=traces["bottom"]), b_state[1][1]))
    t_state = opt.init(t)
    t_state = (t_state[0], (t_state[1][0]._replace(trace=traces["top"]), t_state[1][1]))
    fused = P.merge_opt_state(b_state, t_state)
    assert list(fused[1][0].trace) == list(P.join([b, t], P.GROUPS))
    b2, t2 = P.split_opt_state(fused)
    assert type(b2) is type(b_state) and type(b2[1][0]) is type(b_state[1][0])
    _equal(b2[1][0].trace, traces["bottom"], "bottom")
    _equal(t2[1][0].trace, traces["top"], "top")
    _equal(P.merge_opt_state(b2, t2)[1][0].trace, fused[1][0].trace, "merged again")


def _ring_clients(shape, classes, seed, n=3, samples=20):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((samples,) + shape).astype(np.float32),
             rng.integers(0, classes, size=samples).astype(np.int32)) for _ in range(n)]


def test_train_ring_and_evaluate_match_the_reference():
    shape, classes = (8, 8, 1), 3
    bottom, top = default_split_models(shape, classes)
    clients = _ring_clients(shape, classes, 7)
    rng = np.random.default_rng(8)
    tx = rng.standard_normal((50,) + shape).astype(np.float32)
    ty = rng.integers(0, classes, size=50).astype(np.int32)
    api = SplitNNAPI(bottom, top, lr=LR, momentum=MOM, wd=WD, seed=3, device="cpu")
    init = split_to_flax({"bottom": api.bottom_vars, "top": api.top_vars})

    def run():
        import jax

        from fedml_tpu.algorithms.split_nn import SplitNNAPI as JaxSplit
        from fedml_tpu.algorithms.split_nn import default_split_models as jax_models

        jb, jt = jax_models(shape, classes)
        jb.init = lambda rng: {"params": init["bottom"]}
        jt.init = lambda rng: {"params": init["top"]}
        japi = JaxSplit(jb, jt, lr=LR, momentum=MOM, wd=WD, seed=3)
        stats = japi.train_ring(clients, batch_size=8)
        return {"stats": [s["loss"] for s in stats], "acc": japi.evaluate(tx, ty),
                "params": {"bottom": jax.device_get(japi.bottom_vars["params"]),
                           "top": jax.device_get(japi.top_vars["params"])}}

    want = reference_record("splitnn_ring", {"digest": variables_digest(
        {**api.bottom_vars, **{"top." + k: v for k, v in api.top_vars.items()}})}, run)
    stats = api.train_ring(clients, batch_size=8)
    np.testing.assert_allclose([s["loss"] for s in stats], want.stats, rtol=1e-5)
    assert abs(api.evaluate(tx, ty) - want.acc) <= 1 / len(ty)
    want_p = split_from_flax(want.params)
    _close(api.bottom_vars, {k: v.numpy() for k, v in want_p["bottom"].items()}, "bottom")
    _close(api.top_vars, {k: v.numpy() for k, v in want_p["top"].items()}, "top")


def test_cli_row_matches_the_reference_runner(tmp_path, capsys, monkeypatch):
    """``--algorithm split_nn`` through the port's command line and the
    reference's, both from the port's seeded init (the reference's
    ``default_split_models`` hands its ModelDefs that init), on the
    registry's synthetic set: the rows' keys are the reference's, Test/Acc
    within one test sample."""
    import json

    click = pytest.importorskip("click")  # noqa: F841
    from click.testing import CliRunner

    from fedml_tpu import cli as jcli
    from fedml_tpu_torch import cli as tcli
    from fedml_tpu_torch.data import registry

    args = ["--algorithm", "split_nn", "--dataset", "synthetic", "--comm_round", "2",
            "--client_num_in_total", "4", "--client_num_per_round", "2", "--batch_size", "20"]
    tcli.main(args + ["--log_dir", str(tmp_path / "port")], device="cpu")
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    from fedml_tpu_torch.config import DataConfig, FedConfig, RunConfig

    data = registry.load(RunConfig(data=DataConfig(dataset="synthetic"),
                                   fed=FedConfig(client_num_in_total=4)))
    bottom, top = default_split_models(tuple(data.client_x[0].shape[1:]), data.num_classes)
    init = split_to_flax(dict(zip(P.GROUPS, init_split_vars(bottom, top, 0))))

    def run():
        import fedml_tpu.algorithms.split_nn as jsplit

        original = jsplit.default_split_models

        def carried(*a, **kw):
            jb, jt = original(*a, **kw)
            jb.init = lambda rng: {"params": init["bottom"]}
            jt.init = lambda rng: {"params": init["top"]}
            return jb, jt

        monkeypatch.setattr(jsplit, "default_split_models", carried)
        result = CliRunner().invoke(jcli.main, args + ["--log_dir", str(tmp_path / "ref")],
                                    catch_exceptions=False)
        assert result.exit_code == 0, result.output
        return {"row": json.loads(result.output.strip().splitlines()[-1])}

    want = reference_record("splitnn_cli", {"args": args, "digest": variables_digest(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         split_from_flax(init)["bottom"].items()})}, run).row
    assert set(got) == set(want) == {"round", "Test/Acc"}
    assert got["round"] == want["round"]
    assert abs(got["Test/Acc"] - want["Test/Acc"]) <= 1 / len(data.test_y)
