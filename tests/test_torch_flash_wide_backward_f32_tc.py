"""A plain-PyTorch emulation of the arithmetic of the float32 flash backward
cluster kernels (``flash_bwd_dq_cluster_f32tc_kernel`` and
``flash_bwd_dkv_cluster_f32tc_kernel`` in
fedml_tpu_torch/ops/csrc/flash_attention.cu, head dims above 128), held to
the port's plain versions and once to the reference's Pallas backward
(interpret mode).

The kernels run only on the card; this file shows on the CPU that their
arithmetic stays inside the bound ``chip_smoke.py`` holds them to there
(FLASH_TOL["float32"]). What the emulation does, as the kernels do:

- d is split into 128-wide chunks, one block of a cluster each. K3: 64
  query rows a tile over 32-key K and V tiles; K4: 64 keys a tile over
  32-query Q and dO tiles with their LSE and δ rows;
- every float32 operand is split once into hi = tf32(x), rounded to
  nearest, ties away, and lo = x − hi as the tensor core reads it (the
  float32 K2's emulation, ``test_torch_flash_forward_f32_tc.split``);
- block c forms its chunk's share of S = Q·Kᵀ and dP = dO·Vᵀ (K4: K·Qᵀ and
  V·dOᵀ), the wgmma products, over its 128 columns in their order, 8 deep
  a step, each step hi·lo + lo·hi + hi·hi: the tensor core sums
  ``GROUP`` steps from zero, and each group's sum is added to the share
  rounded to nearest;
- every block adds the nc shares in rank order, so S and dP are formed
  once for all chunks; P = exp(masked S·scale − LSE) with −1e30 above the
  diagonal and past Sk, dS = P∘(dP − δ)·scale, K4 giving query rows past
  S no weight;
- the output products (dS·K; K4: Pᵀ·dO and dSᵀ·Q) are the mma.sync
  m16n8k8 products of the d ≤ 128 kernels: 8 keys (queries) a step in
  slot order, three TF32 products each, into a float32 accumulator
  (``test_torch_flash_forward_f32_tc.mma_product``).

The order of the sums inside one tensor-core instruction, and of the
instructions of a group, is the hardware's and is not emulated; it is one
more order of the same float32 sums, which the chip run measures (phase 7
of ``chip_smoke.py``). A negative control
shows why the split is needed: one TF32 product breaks the bound on the
same inputs."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from fedml_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402

from fedml_tpu_torch.ops import flash_attention as fa  # noqa: E402
from test_torch_flash_forward_f32_tc import (  # noqa: E402  (the float32 K2's emulation)
    MMA_K,
    NEG,
    _assert_close,
    _excess,
    _padded,
    mma_product,
    split,
    tf32_rna,
)
from torch_parity import reference_record, torch_threads  # noqa: E402

TILE, SUB, CHUNK = fa.KERNEL_TILE, 32, fa.WIDE_CHUNK  # resident rows, streamed rows, chunk
GROUP = 4  # csrc kClGroup: k8 steps summed before a nearest add


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small matmuls gain nothing from threads; under 6 test workers 8 threads
    # a process spin against each other
    with torch_threads(1):
        yield


def chunk_share(a, b, split_operands=True, group=GROUP):
    """a [.., m, 128] @ b [.., n, 128]ᵀ as one block's wgmma steps: 8 deep
    a step in order, hi·lo + lo·hi + hi·hi (hi·hi of TF32-rounded operands
    alone without ``split_operands``), ``group`` steps summed from zero
    and added to the share."""
    steps = a.shape[-1] // MMA_K
    if split_operands:
        (ahi, alo), (bhi, blo) = split(a), split(b)
    else:
        ahi, bhi = tf32_rna(a), tf32_rna(b)

    def per_step(x, y):  # [steps, .., m, n]: each step's 8-deep product
        xs = x.unflatten(-1, (steps, MMA_K)).movedim(-2, 0)
        ys = y.unflatten(-1, (steps, MMA_K)).movedim(-2, 0)
        return xs @ ys.transpose(-1, -2)

    terms = [per_step(ahi, blo), per_step(alo, bhi)] if split_operands else []
    terms.append(per_step(ahi, bhi))
    share = torch.zeros(a.shape[:-1] + b.shape[-2:-1])
    for g0 in range(0, steps, group):
        u = torch.zeros_like(share)
        for s in range(g0, g0 + group):
            for term in terms:
                u = u + term[s]
        share = share + u
    return share


def scores(a, b, split_operands=True, group=GROUP):
    """A·Bᵀ over the whole d: the chunks' shares added in rank order."""
    out = None
    for c0 in range(0, a.shape[-1], CHUNK):
        share = chunk_share(a[..., c0 : c0 + CHUNK], b[..., c0 : c0 + CHUNK], split_operands,
                            group)
        out = share if out is None else out + share
    return out


def cluster_dq_f32(q, k, v, do, lse, delta, scale, causal, split_operands=True, group=GROUP):
    """K3 above head dim 128 on the cluster kernel, emulated → dQ."""
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
            s = scores(qf[:, qs], kf[:, ks], split_operands, group) * scale
            dp = scores(dof[:, qs], vf[:, ks], split_operands, group)
            s = torch.where((cols >= Sk) | (causal & (rows < cols)), NEG, s)
            p = torch.exp(s - lse_p[:, qs, None])
            ds = p * (dp - delta_p[:, qs, None]) * scale
            dq[:, qs] += mma_product(ds, kf[:, ks], split_operands)
    return dq[:, :S]


def cluster_dkv_f32(q, k, v, do, lse, delta, scale, causal, split_operands=True, group=GROUP):
    """K4 above head dim 128 on the cluster kernel, emulated → (dK, dV)."""
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
            st = scores(kf[:, ks], qf[:, qs], split_operands, group) * scale
            dpt = scores(vf[:, ks], dof[:, qs], split_operands, group)
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


def _emulated(args, **kw):
    return cluster_dq_f32(*args, **kw), *cluster_dkv_f32(*args, **kw)


# (BH, S, Sk, d, causal): one 32-row tile and two 64-row tiles at two and
# three chunks, causal and not; more keys than queries (chip_smoke.py's
# 128 × 192, not causal)
CASES = [(2, S, S, d, causal) for S in (32, 128) for d in (256, 384)
         for causal in (True, False)] + [(2, 128, 192, 256, False)]


@pytest.mark.parametrize("BH,S,Sk,d,causal", CASES)
def test_emulated_cluster_backward_matches_plain_versions(BH, S, Sk, d, causal):
    q, k, v, do = _inputs(BH, S, Sk, d, seed=S + Sk + d + causal)
    args, blocks = _backward_args(q, k, v, do, causal)
    for name, g, w in zip(("dQ", "dK", "dV"), _emulated(args), _plain(args, blocks)):
        _assert_close(g, w, f"{name} S={S} Sk={Sk} d={d} causal={causal}")


def test_emulated_cluster_backward_matches_reference():
    """dQ, dK, dV of the emulation against the reference's custom VJP
    (Pallas interpret mode), float32, one 64-row tile at d = 256, causal."""
    BH, S, d = 1, 64, 256
    q, k, v, do = _inputs(BH, S, S, d, seed=17)

    def run():
        def out(q, k, v):
            return jax_flash(q, k, v, causal=True, block_q=TILE, block_k=TILE)

        arrays = [jnp.asarray(t.numpy()) for t in (q, k, v, do)]
        _, vjp = jax.vjp(out, *arrays[:3])
        return {"grads": [np.asarray(g) for g in vjp(arrays[3])]}

    want = reference_record("flash_f32_vjp", {"BH": BH, "S": S, "d": d, "causal": True,
                                               "block": TILE, "seed": 17}, run).grads
    args, _ = _backward_args(q, k, v, do, True)
    for name, g, w in zip(("dQ", "dK", "dV"), _emulated(args), want):
        _assert_close(g, torch.from_numpy(np.array(w)), f"{name} d={d}")


def test_one_tf32_product_breaks_the_float32_bound():
    """Without the split, each product keeps TF32's 11 bits: on the same
    inputs dQ, dK or dV leaves FLASH_TOL["float32"], while the split stays
    inside it."""
    q, k, v, do = _inputs(2, 128, 128, 256, seed=3)
    args, blocks = _backward_args(q, k, v, do, True)
    want = _plain(args, blocks)
    one = _emulated(args, split_operands=False)
    assert max(_excess(g, w) for g, w in zip(one, want)) > 0
    assert max(_excess(g, w) for g, w in zip(_emulated(args), want)) <= 0


@pytest.mark.parametrize("group", [1, 16])
def test_the_finest_and_coarsest_group_stay_inside_the_bound(group):
    """The emulated arithmetic at the finest nearest-add grain (every k8
    step) and the coarsest (a whole 128-wide chunk), three chunks."""
    q, k, v, do = _inputs(2, 128, 128, 384, seed=5)
    args, blocks = _backward_args(q, k, v, do, True)
    for name, g, w in zip(("dQ", "dK", "dV"), _emulated(args, group=group), _plain(args, blocks)):
        _assert_close(g, w, f"{name} group={group}")
