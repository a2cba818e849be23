"""Flash attention at head dims the kernels are not built for
(fedml_tpu_torch/ops/flash_attention.py ``at_built_head_dim``).

The reference's ``flash_attention`` takes any head dim; the port's kernels
are built for HEAD_DIMS and, above them, as chunked kernels for any
multiple of WIDE_CHUNK (128). On the CPU the port's plain versions take any
d, and are held here to the reference (Pallas interpret mode), d = 160 and
256 included. On the card any other d is zero-padded to the next width the
kernels take and launched with the caller's scale, 1/√d of the true d, and
O, dQ, dK and dV are sliced back; the pad-and-slice helper is driven here
by the plain versions, which is what it hands the kernels on the card, and
the launcher is driven up to the kernel call at d = 256.

Tolerance: ``chip_smoke.py``'s FLASH_TOL["float32"], |err| ≤ 1e-5·|ref| +
1e-5·max|ref|: the two packages (and the padded and unpadded routes) sum
the same float32 terms in other orders."""

import contextlib
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from fedml_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402

from fedml_tpu_torch.ops import flash_attention as fa  # noqa: E402
from torch_parity import reference_record, torch_threads  # noqa: E402

BH, S, BLOCK = 2, 128, 64
TOL = (1e-5, 1e-5)  # chip_smoke.py FLASH_TOL["float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small matmuls gain nothing from threads; under 6 test workers 8 threads
    # a process spin against each other
    with torch_threads(1):
        yield


def _inputs(d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(BH, S, d)).astype(np.float32) for _ in range(4)]  # q, k, v, dO


def _assert_close(got, want, what):
    got, want = torch.as_tensor(got).float(), torch.as_tensor(np.array(want)).float()
    assert got.shape == want.shape, what
    assert torch.isfinite(got).all(), what
    rtol, atol = TOL
    err = (got - want).abs()
    assert (err <= rtol * want.abs() + atol * want.abs().max()).all(), (
        f"{what}: max |err| {err.max().item()} (max|ref| {want.abs().max().item()})")


# d = 160 (zero-padded to two chunks) causal and d = 256 (two chunks) not:
# each above-128 case costs the reference ~2.5 s of Pallas interpret mode
@pytest.mark.parametrize("d,causal", [(48, True), (48, False), (80, True), (80, False),
                                      (160, True), (256, False)])
def test_flash_attention_at_unbuilt_head_dims_matches_reference(d, causal):
    q, k, v, do = _inputs(d, seed=d + causal)

    def run():
        def out(q, k, v):
            return jax_flash(q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK)

        arrays = [jnp.asarray(a) for a in (q, k, v, do)]
        o, vjp = jax.vjp(out, *arrays[:3])
        return {"o": np.asarray(o), "grads": [np.asarray(g) for g in vjp(arrays[3])]}

    want = reference_record("flash_head_dim_vjp", {"BH": BH, "S": S, "d": d, "causal": causal,
                                                    "block": BLOCK, "seed": d + causal}, run)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    before = dict(fa.LAUNCHES)
    o = fa.flash_attention(tq, tk, tv, causal=causal, block_q=BLOCK, block_k=BLOCK)
    o.backward(torch.from_numpy(do))
    assert fa.LAUNCHES == before  # CPU tensors: the plain versions, no launch
    _assert_close(o.detach(), want.o, f"O d={d} causal={causal}")
    for name, t, w in zip(("dQ", "dK", "dV"), (tq, tk, tv), want.grads):
        _assert_close(t.grad, w, f"{name} d={d} causal={causal}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [48, 80, 160])
def test_padded_route_equals_plain_versions_at_the_true_head_dim(d, causal):
    """``at_built_head_dim`` pads to 64 (d = 48), 96 (d = 80) or 256 (d =
    160, two chunks of the chunked kernels), keeps the scale and the LSE
    and δ rows, and slices back: driven by the plain versions, it gives
    what they give at the true d."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(d, seed=d + causal + 7))
    scale, blocks = d**-0.5, (BLOCK, BLOCK)
    o, lse = fa.flash_forward_plain(q, k, v, scale, causal, *blocks)
    po, plse = fa.at_built_head_dim(fa.flash_forward_plain, q, k, v, scale, causal, *blocks)
    delta = torch.sum(do * o, dim=-1)
    args = (q, k, v, do, lse, delta, scale, causal, *blocks)
    want = (o, lse, fa.flash_backward_dq_plain(*args), *fa.flash_backward_dkv_plain(*args))
    got = (po, plse, fa.at_built_head_dim(fa.flash_backward_dq_plain, *args),
           *fa.at_built_head_dim(fa.flash_backward_dkv_plain, *args))
    for name, g, w in zip(("O", "LSE", "dQ", "dK", "dV"), got, want):
        assert g.shape == w.shape and g.is_contiguous(), name
        _assert_close(g, w, f"{name} d={d} causal={causal}")


def test_built_head_dim_is_the_next_kernel_width():
    """A built head dim up to 128; above it the next multiple of the
    chunked kernels' 128-wide chunk."""
    ds = (1, 8, 16, 48, 80, 96, 100, 128, 129, 160, 256, 257, 384)
    assert [fa.built_head_dim(d) for d in ds] == [
        16, 16, 16, 64, 96, 96, 128, 128, 256, 256, 256, 384, 384]
    assert fa.WIDE_CHUNK == 128 and max(fa.HEAD_DIMS) == fa.WIDE_CHUNK


@pytest.mark.parametrize("d", [129, 160, 256, 384])
def test_head_dim_above_128_reaches_the_chunked_kernels(d, monkeypatch):
    """Above 128 the launcher no longer refuses: ``at_built_head_dim`` pads d
    to its chunk multiple, ``_launch`` passes its checks and calls the C
    entry point with that head dim and the caller's scale (the stream
    lookup is stubbed: a CPU tensor has none), counts one launch, and the
    outputs are sliced back to d. A head dim the kernels do not take is
    still refused."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(fa.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(fa.torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(fa, "LAUNCHES", dict(fa.LAUNCHES))
    fa.reset_launches()  # the copy's counts
    width = fa.built_head_dim(d)
    q, k, v = (torch.zeros(2, 64, d) for _ in range(3))

    def forward(q, k, v):
        out, lse = torch.empty_like(q), torch.empty(q.shape[:2])
        fa._launch(fa.FWD, entry, q, [(q, "q"), (k, "k"), (v, "k"), (out, "q"), (lse, "row")],
                   k.shape[1], True, d**-0.5)
        return out, lse

    before = fa.launch_totals()[fa.FWD]
    o, lse = fa.at_built_head_dim(forward, q, k, v)
    (args,) = calls
    assert args[:2] == (0, width) and args[-6:-2] == (2, 64, 64, 1)
    assert args[-2] == pytest.approx(d**-0.5)
    assert fa.launch_totals()[fa.FWD] == before + 1
    assert fa.LAUNCHES[(fa.FWD, fa.CHUNKED["float32"])] == 1  # the chunked kernel's count
    assert sum(fa.LAUNCHES.values()) == 1
    assert o.shape == (2, 64, d) and lse.shape == (2, 64)
    bad = torch.zeros(2, 64, width + 1)
    with pytest.raises(ValueError, match=f"no kernel for head dim {width + 1}"):
        fa._launch(fa.FWD, entry, bad, [(bad, "q")], 64, True, 1.0)
