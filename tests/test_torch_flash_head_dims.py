"""Flash attention at head dims the kernels are not built for
(fedml_tpu_torch/ops/flash_attention.py ``at_built_head_dim``).

The reference's ``flash_attention`` takes any head dim; the port's kernels
are built for HEAD_DIMS. On the CPU the port's plain versions take any d,
and are held here to the reference (Pallas interpret mode). On the card a
d up to 128 is zero-padded to the next built dim and launched with the
caller's scale, 1/√d of the true d, and O, dQ, dK and dV are sliced back;
the pad-and-slice helper is driven here by the plain versions, which is
what it hands the kernels on the card. A d above 128 has no kernel, and
the launcher refuses it with a pointer to ROADMAP.md §3.

Tolerance: ``chip_smoke.py``'s FLASH_TOL["float32"], |err| ≤ 1e-5·|ref| +
1e-5·max|ref|: the two packages (and the padded and unpadded routes) sum
the same float32 terms in other orders."""

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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [48, 80])
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
@pytest.mark.parametrize("d", [48, 80])
def test_padded_route_equals_plain_versions_at_the_true_head_dim(d, causal):
    """``at_built_head_dim`` pads to 64 (d = 48) or 96 (d = 80), keeps the
    scale and the LSE and δ rows, and slices back: driven by the plain
    versions, it gives what they give at the true d."""
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
    assert [fa.built_head_dim(d) for d in (1, 8, 16, 48, 80, 96, 100, 128, 129, 256)] == [
        16, 16, 16, 64, 96, 96, 128, 128, 129, 256]


def test_head_dim_above_128_is_refused_on_the_card_path():
    """A d above the largest built head dim is passed through unpadded and
    the launcher refuses it, naming ROADMAP.md §3 (it raises before it
    calls ``fn``, so a CPU tensor and no library do); no plain version
    stands in."""
    q = torch.zeros(2, 64, 256)
    for name in fa.KERNEL_NAMES:
        def launch(q, name=name):
            fa._launch(name, None, q, [(q, "q")], q.shape[1], True, 256**-0.5)

        with pytest.raises(ValueError, match=r"no kernel for head dim 256.*ROADMAP\.md §3"):
            fa.at_built_head_dim(launch, q)
