"""A plain-PyTorch emulation of the arithmetic of the float32 flash backward
kernels on the tensor cores (``flash_bwd_dq_f32tc_kernel`` and
``flash_bwd_dkv_f32tc_kernel`` in fedml_tpu_torch/ops/csrc/flash_attention.cu),
held to the port's plain versions and once to the reference's Pallas
backward (interpret mode).

The kernels run only on the card; this file shows on the CPU that their
arithmetic stays inside the bound ``chip_smoke.py`` holds them to there
(FLASH_TOL["float32"]). What the emulation does, as the kernels do:

- every float32 operand x of every product, P and dS included, is split
  into hi = tf32(x), rounded to nearest with ties away from zero (the
  kernels' two integer instructions on the int32 view), and the exact
  remainder lo = x − hi, which the tensor core reads to TF32 (its top 19
  bits);
- a product a·b of split operands is hi·lo + lo·hi + hi·hi, taken 8 along
  the depth at a time (one m16n8k8 mma), the three added to the float32
  accumulator in that order;
- inside each 8-deep step the depth is read in the kernels' slot order
  (0, 2, 4, 6, 1, 3, 5, 7): for S = Q·Kᵀ and dO·Vᵀ (K4: K·Qᵀ and V·dOᵀ) the
  head-dim columns, for dS·K (K4: Pᵀ·dO and dSᵀ·Q) the keys (queries), so
  that the A operand comes straight from the score accumulators;
- K3: 64 query rows a block over 32-key K and V tiles; K4: 64 keys a block
  over 32-query Q and dO tiles with their LSE and δ rows; P = exp(masked
  S·scale − LSE) with −1e30 above the diagonal and past Sk,
  dS = P∘(dO·Vᵀ − δ)·scale, K4 giving query rows past S no weight.

The order of the sums inside one mma is the hardware's and is not
emulated; it is one more order of the same float32 sums. A negative
control shows why the split is needed: one TF32 product (hi·hi alone)
breaks the bound on the same inputs."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from fedml_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402

from fedml_tpu_torch.ops import flash_attention as fa  # noqa: E402
from test_torch_flash_forward_f32_tc import (  # noqa: E402  (the float32 K2's emulation)
    NEG,
    _assert_close,
    _excess,
    _padded,
    mma_product,
)
from torch_parity import reference_record, torch_threads  # noqa: E402

TILE, SUB = fa.KERNEL_TILE, 32  # block rows, loop-tile rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small matmuls gain nothing from threads; under 6 test workers 8 threads
    # a process spin against each other
    with torch_threads(1):
        yield


def tc_dq_f32(q, k, v, do, lse, delta, scale, causal, split_operands=True):
    """K3 for float32 on the tensor cores, emulated → dQ."""
    S, Sk = q.shape[1], k.shape[1]
    nq, nk = -(-S // TILE), -(-Sk // SUB)
    qf, dof = _padded(q, nq * TILE), _padded(do, nq * TILE)
    kf, vf = _padded(k, nk * SUB), _padded(v, nk * SUB)
    lse_p, delta_p = _padded(lse, nq * TILE), _padded(delta, nq * TILE)
    dq = torch.zeros_like(qf)
    for qt in range(nq):
        qs = slice(qt * TILE, (qt + 1) * TILE)
        rows = qt * TILE + torch.arange(TILE)[:, None]
        k_end = min(nk, (qt * TILE + TILE - 1) // SUB + 1) if causal else nk
        for kt in range(k_end):
            ks = slice(kt * SUB, (kt + 1) * SUB)
            cols = kt * SUB + torch.arange(SUB)[None, :]
            s = mma_product(qf[:, qs], kf[:, ks].transpose(-1, -2), split_operands) * scale
            dp = mma_product(dof[:, qs], vf[:, ks].transpose(-1, -2), split_operands)
            s = torch.where((cols >= Sk) | (causal & (rows < cols)), NEG, s)
            p = torch.exp(s - lse_p[:, qs, None])
            ds = p * (dp - delta_p[:, qs, None]) * scale
            dq[:, qs] += mma_product(ds, kf[:, ks], split_operands)
    return dq[:, :S]


def tc_dkv_f32(q, k, v, do, lse, delta, scale, causal, split_operands=True):
    """K4 for float32 on the tensor cores, emulated → (dK, dV)."""
    S, Sk = q.shape[1], k.shape[1]
    nq, nk = -(-S // SUB), -(-Sk // TILE)
    qf, dof = _padded(q, nq * SUB), _padded(do, nq * SUB)
    kf, vf = _padded(k, nk * TILE), _padded(v, nk * TILE)
    lse_p, delta_p = _padded(lse, nq * SUB), _padded(delta, nq * SUB)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for kt in range(nk):
        ks = slice(kt * TILE, (kt + 1) * TILE)
        keys = kt * TILE + torch.arange(TILE)[:, None]
        for qt in range(kt * TILE // SUB if causal else 0, nq):
            qs = slice(qt * SUB, (qt + 1) * SUB)
            cols = qt * SUB + torch.arange(SUB)[None, :]  # queries
            st = mma_product(kf[:, ks], qf[:, qs].transpose(-1, -2), split_operands) * scale
            dpt = mma_product(vf[:, ks], dof[:, qs].transpose(-1, -2), split_operands)
            st = torch.where((keys >= Sk) | (causal & (cols < keys)), NEG, st)
            p = torch.exp(st - lse_p[:, None, qs])
            p = torch.where(cols < S, p, torch.zeros_like(p))
            ds = p * (dpt - delta_p[:, None, qs]) * scale
            dv[:, ks] += mma_product(p, dof[:, qs], split_operands)
            dk[:, ks] += mma_product(ds, qf[:, qs], split_operands)
    return dk[:, :Sk], dv[:, :Sk]


def _inputs(BH, S, Sk, d, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(BH, S, d)) for _ in range(2))
    k, v = (rng.normal(size=(BH, Sk, d)) for _ in range(2))
    return [torch.from_numpy(t.astype(np.float32)) for t in (q, k, v, do)]


def _backward_args(q, k, v, do, causal):
    """(args, plain blocks): the plain forward's LSE and δ = rowsum(dO∘O),
    the plain versions at 64-row tiles where they divide S, else one block."""
    bq, bk = (TILE if n % TILE == 0 else n for n in (q.shape[1], k.shape[1]))
    scale = q.shape[-1] ** -0.5
    o, lse = fa.flash_forward_plain(q, k, v, scale, causal, bq, bk)
    delta = torch.sum(do * o, dim=-1)
    return (q, k, v, do, lse, delta, scale, causal), (bq, bk)


def _plain(args, blocks):
    return fa.flash_backward_dq_plain(*args, *blocks), *fa.flash_backward_dkv_plain(*args, *blocks)


# (BH, S, Sk, d, causal): one 32-row tile, two and three 64-row tiles, at
# the smallest, the LM's and the largest head dim, causal and not; and
# Sk ≠ S (chip_smoke.py's 128 × 192, not causal)
CASES = [(2, S, S, d, causal) for S in (32, 128, 192) for d in (16, 96, 128)
         for causal in (True, False)] + [(3, 128, 192, 64, False)]


@pytest.mark.parametrize("BH,S,Sk,d,causal", CASES)
def test_emulated_split_tf32_backward_matches_plain_versions(BH, S, Sk, d, causal):
    q, k, v, do = _inputs(BH, S, Sk, d, seed=S + Sk + d + causal)
    args, blocks = _backward_args(q, k, v, do, causal)
    got = (tc_dq_f32(*args), *tc_dkv_f32(*args))
    for name, g, w in zip(("dQ", "dK", "dV"), got, _plain(args, blocks)):
        _assert_close(g, w, f"{name} S={S} Sk={Sk} d={d} causal={causal}")


@pytest.mark.parametrize("causal", [True, False])
def test_emulated_split_tf32_backward_matches_reference(causal):
    """dQ, dK, dV of the emulation against the reference's custom VJP
    (Pallas interpret mode), float32, two 64-row tiles."""
    BH, S, d = 2, 128, 32
    q, k, v, do = _inputs(BH, S, S, d, seed=13)

    def run():
        def out(q, k, v):
            return jax_flash(q, k, v, causal=causal, block_q=TILE, block_k=TILE)

        arrays = [jnp.asarray(t.numpy()) for t in (q, k, v, do)]
        _, vjp = jax.vjp(out, *arrays[:3])
        return {"grads": [np.asarray(g) for g in vjp(arrays[3])]}

    want = reference_record("flash_f32_vjp", {"BH": BH, "S": S, "d": d, "causal": causal,
                                               "block": TILE, "seed": 13}, run).grads
    args, _ = _backward_args(q, k, v, do, causal)
    got = (tc_dq_f32(*args), *tc_dkv_f32(*args))
    for name, g, w in zip(("dQ", "dK", "dV"), got, want):
        _assert_close(g, torch.from_numpy(np.array(w)), f"{name} causal={causal}")


@pytest.mark.parametrize("d", [16, 96])
def test_one_tf32_product_breaks_the_float32_bound(d):
    """Without the split, each product keeps TF32's 11 bits: on the same
    inputs dQ, dK or dV leaves FLASH_TOL["float32"], while the split stays
    inside it."""
    q, k, v, do = _inputs(2, 128, 128, d, seed=3)
    args, blocks = _backward_args(q, k, v, do, True)
    want = _plain(args, blocks)
    one = (tc_dq_f32(*args, split_operands=False), *tc_dkv_f32(*args, split_operands=False))
    assert max(_excess(g, w) for g, w in zip(one, want)) > 0
    three = (tc_dq_f32(*args), *tc_dkv_f32(*args))
    assert max(_excess(g, w) for g, w in zip(three, want)) <= 0
