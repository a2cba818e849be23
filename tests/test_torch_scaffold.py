"""The port's SCAFFOLD against the reference's on the CPU: 3 rounds on the
CNN slice (params, rows, the server control variate and every client's
row), only the sampled rows updated, a padded client ignored, the control
variates float32 under bfloat16 compute, the refusals, and checkpoints
resumed across the packages in both forms (the device stack ``c_stack``,
and the spilled store's touched rows ``c_rows_idx`` + ``c_rows_<i>``).

Tolerances: the slice's params and rows as the FedAvg slice is held (rtol
1e-4, atol 1e-5; 1e-4); the control variates atol 1e-4: c_i⁺ carries
(x − y)/(K·lr), which scales the params' float32 differences by 1/(K·lr)
(up to 10 at lr 0.1); after a checkpoint the LR fixture's one full-batch
round agrees to float32 rounding (atol 1e-6)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from fedml_tpu.algorithms.scaffold import ScaffoldAPI as JaxScaffold  # noqa: E402
from fedml_tpu.utils.checkpoint import load_checkpoint as jax_load  # noqa: E402
from fedml_tpu.utils.checkpoint import save_checkpoint as jax_save  # noqa: E402

import fedml_tpu_torch.config as tcfg  # noqa: E402
from fedml_tpu_torch.algorithms.scaffold import ScaffoldAPI, make_scaffold_cohort_body  # noqa: E402
from fedml_tpu_torch.bridge import from_flax, to_flax  # noqa: E402
from fedml_tpu_torch.data.synthetic import synthetic_classification  # noqa: E402
from fedml_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402

from torch_parity import (  # noqa: E402
    assert_slice_close, flat_params, lr_config, lr_data, lr_pair,
    port_api, private_reference_programs, torch_lr_model, trained_pair,
)

C_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _private_programs(tmp_path_factory):
    with private_reference_programs(tmp_path_factory.mktemp("exec_cache")):
        yield


def _port_stack(tapi) -> dict:
    """The port's whole [N, ...] control store in the reference's layout."""
    n = tapi.config.fed.client_num_in_total
    if tapi.state.stack is not None:
        return flat_params(to_flax(tapi.state.stack, 1))
    rows = tapi.state.store.gather(np.arange(n))
    return flat_params(to_flax(rows, 1))


def _reference_stack(japi) -> dict:
    if japi.c_stack is not None:
        return flat_params(jax.device_get(japi.c_stack))
    return flat_params(japi._c_store.gather(np.arange(japi._c_store.n)))


def _reference_control(japi) -> tuple:
    """The reference's (c, c_i stack), flat."""
    return flat_params(jax.device_get(japi.c_server)), _reference_stack(japi)


def _assert_control_close(tapi, want_control, **tol):
    got_c, got = flat_params(to_flax(tapi.c_server)), _port_stack(tapi)
    want_c, want = want_control
    for k in want_c:
        np.testing.assert_allclose(got_c[k], want_c[k], err_msg=f"c/{k}", **tol)
        np.testing.assert_allclose(got[k], want[k], err_msg=f"c_i/{k}", **tol)


@pytest.fixture(scope="module")
def slice_runs():
    """The reference's 3 slice rounds, and the port's in each mode."""
    japi, tdev = trained_pair(JaxScaffold, ScaffoldAPI, fed={"state_store": "device"},
                              extras={"control": _reference_control})
    tmm = port_api(ScaffoldAPI, from_flax(japi.init), fed={"state_store": "mmap"})
    tdev.train()
    tmm.train()
    return japi, tdev, tmm


def test_slice_matches_reference(slice_runs):
    japi, tdev, _ = slice_runs
    assert tdev.state.mode == "device"
    assert_slice_close(japi, tdev)
    _assert_control_close(tdev, japi.control, **C_TOL)


def test_mmap_is_bit_equal_to_device(slice_runs):
    _, tdev, tmm = slice_runs
    assert tmm.state.mode == "mmap"
    for k, v in tdev.global_vars.items():
        assert torch.equal(tmm.global_vars[k], v), k
    for k, v in tdev.c_server.items():
        assert torch.equal(tmm.c_server[k], v), k
    got, want = _port_stack(tmm), _port_stack(tdev)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert len(tmm.state.spill_ms) == 3


def test_only_sampled_rows_change(slice_runs):
    _, tdev, _ = slice_runs
    touched = {int(c) for r in range(3) for c in tdev._round_plan(r)}
    stack = tdev.state.stack
    for i in range(tdev.config.fed.client_num_in_total):
        moved = any(bool(s[i].abs().max() > 0) for s in stack.values())
        assert moved == (i in touched), i
    assert all(s.dtype == torch.float32 for s in stack.values())


def test_padded_client_is_ignored():
    """A cohort with an extra all-padding client (num_samples 0): its row
    comes back unchanged, and the new model and c are the cohort's
    without it."""
    _, tapi = lr_pair(JaxScaffold, ScaffoldAPI, batch_size=4)
    body = make_scaffold_cohort_body(tapi.model, tapi.config)
    sampled = tapi._round_plan(0)
    x, y, mask, ns, perms, seeds = tapi._place_batch(tapi._round_batch(sampled, 0), 0)
    rng = np.random.default_rng(0)
    c_rows = {k: torch.from_numpy(rng.normal(size=(len(sampled),) + tuple(v.shape))
                                  .astype(np.float32)) for k, v in tapi.c_server.items()}
    c_server = {k: torch.full_like(v, 0.01) for k, v in tapi.c_server.items()}
    pad = lambda a: torch.cat([a, torch.zeros_like(a[:1])])  # noqa: E731
    args = (tapi.global_vars, c_server)
    g1, c1, rows1, m1 = body(*args, c_rows, x, y, mask, ns, perms, seeds)
    g2, c2, rows2, m2 = body(*args, {k: torch.cat([v, v[:1] + 3.0]) for k, v in c_rows.items()},
                             pad(x), pad(y), pad(mask), pad(ns), perms + perms[:1],
                             seeds + seeds[:1])
    for k in g1:
        torch.testing.assert_close(g2[k], g1[k], rtol=0, atol=1e-7)
    for k in c1:
        torch.testing.assert_close(c2[k], c1[k], rtol=0, atol=1e-7)
        assert torch.equal(rows2[k][-1], c_rows[k][0] + 3.0)
        assert torch.equal(rows2[k][:-1], rows1[k])
    assert all(torch.equal(m1[k], m2[k]) for k in m1)


def test_control_variates_stay_float32_under_bfloat16():
    _, tapi = lr_pair(JaxScaffold, ScaffoldAPI, train={"compute_dtype": "bfloat16"})
    tapi.train()
    assert all(v.dtype == torch.float32 for v in tapi.c_server.values())
    assert all(v.dtype == torch.float32 for v in tapi.state.stack.values())


@pytest.mark.parametrize("train", [{"momentum": 0.9}, {"client_optimizer": "adam"},
                                   {"prox_mu": 0.1}, {"wd": 1e-4}])
def test_refusals(train):
    with pytest.raises(ValueError, match="SCAFFOLD"):
        ScaffoldAPI(lr_config(tcfg, {"lr": 0.1, **train}), lr_data(synthetic_classification),
                    torch_lr_model(), device="cpu")


@pytest.mark.parametrize("writer,src_mode,dst_mode", [
    ("reference", "device", "mmap"),   # c_stack into the spill tier
    ("reference", "mmap", "device"),   # c_rows into the device stack
    ("port", "mmap", "device"),
    ("port", "device", "mmap"),
])
def test_checkpoint_resumes_across_packages(writer, src_mode, dst_mode, tmp_path):
    """Two rounds on one side (batch 4: clients train several steps),
    checkpoint, the other side restores it in the other mode; then one
    more round on both sides, which must agree."""
    fed_src, fed_dst = {"state_store": src_mode}, {"state_store": dst_mode}
    per = {"reference": fed_src, "port": fed_dst} if writer == "reference" else \
        {"reference": fed_dst, "port": fed_src}
    japi, _ = lr_pair(JaxScaffold, ScaffoldAPI, fed=per["reference"], batch_size=4)
    _, tapi = lr_pair(JaxScaffold, ScaffoldAPI, fed=per["port"], batch_size=4)
    path = str(tmp_path / "ck")
    if writer == "reference":
        for r in range(2):
            japi.train_round(r)
        jax_save(path, jax.device_get(japi.global_vars), round_idx=2,
                 algo_state=jax.device_get(japi.checkpoint_state()))
        gv, _, _, _, algo, _ = load_checkpoint(path)
        tapi.global_vars = gv
        tapi.restore_state(algo)
    else:
        for r in range(2):
            tapi.train_round(r)
        save_checkpoint(path, tapi.global_vars, round_idx=2, algo_state=tapi.checkpoint_state())
        gv, _, _, _, algo, _ = jax_load(path)
        japi.global_vars = jax.tree_util.tree_map(jax.numpy.asarray, gv)
        japi.restore_state(algo)
    form = "c_stack" if src_mode == "device" else "c_rows_idx"
    assert form in algo
    _assert_control_close(tapi, _reference_control(japi), rtol=0, atol=1e-6)
    japi.train_round(2)
    tapi.train_round(2)
    got, want = to_flax(tapi.global_vars), jax.device_get(japi.global_vars["params"])
    for k, v in flat_params(want).items():
        np.testing.assert_allclose(flat_params(got)[k], v, rtol=0, atol=1e-6)
    _assert_control_close(tapi, _reference_control(japi), rtol=0, atol=1e-5)
