"""A plain-PyTorch emulation of the arithmetic of the bfloat16 flash
backward kernels on the tensor cores (``flash_bwd_dq_tc_kernel`` and
``flash_bwd_dkv_tc_kernel`` in fedml_tpu_torch/ops/csrc/flash_attention.cu),
held to the port's plain versions and once to the reference's Pallas
backward (interpret mode).

The kernels run only on the card; this file shows on the CPU that their
arithmetic stays inside the bound ``chip_smoke.py`` holds them to there.
What the emulation does, as the kernels do:

- K3: S = Q·Kᵀ and dO·Vᵀ from bf16 inputs, summed in float32 in steps of 16
  along the head dim (one mma's depth); dS rounded to bf16 before dS·K,
  summed in steps of 16 keys; dQ rounded to bf16 once.
- K4: the same products transposed (rows are keys); P and dS stay float32
  and each is split into hi = bf16(x), lo = bf16(x − hi), so that
  dV = Σ (hi + lo)ᵀ·dO and dK = Σ (hi + lo)ᵀ·Q are bf16 products summed in
  float32; dK and dV rounded to bf16 once.
- 64-row tiles; rows past S or Sk are zeros, columns past Sk are masked with
  −1e30, and K4 gives padded query rows no weight.

Tolerance: ``chip_smoke.py``'s FLASH_TOL for bfloat16,
|err| ≤ 2⁻⁷·|ref| + 2⁻⁸·max|ref|. The emulation and the plain versions sum
the same float32 terms in another order (K4's terms also differ by
|x − hi − lo| ≤ 2⁻¹⁶·|x|), so a bf16 rounding of dS or of an output may go
the other way: one bf16 ulp, 2⁻⁸ of that value. The order of the sums
inside one mma is the hardware's and is not emulated; it is one more order
of the same float32 sums, which the same bound covers on the card."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from fedml_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402

from fedml_tpu_torch.ops import flash_attention as fa  # noqa: E402

TILE, MMA_K = fa.KERNEL_TILE, 16
NEG = -1e30
RTOL, ATOL = 2.0**-7, 2.0**-8  # chip_smoke.py FLASH_TOL["bfloat16"]


def _split(x):
    """x as bf16 hi + lo, widened back to float32."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _mma_sum(parts, b):
    """Σ_p parts[p] @ b in float32, the reduction taken 16 at a time (one
    mma's depth) and each 16-wide step's parts in order, as the kernels'
    mma chains run."""
    acc = 0.0
    for k0 in range(0, b.shape[-2], MMA_K):
        for a in parts:
            acc = acc + a[..., k0 : k0 + MMA_K] @ b[..., k0 : k0 + MMA_K, :]
    return acc


def _padded(x, rows):
    """float32 copy of x [BH, n, ...] with zero rows up to ``rows``."""
    out = torch.zeros((x.shape[0], rows) + tuple(x.shape[2:]), dtype=torch.float32)
    out[:, : x.shape[1]] = x.float()
    return out


def _tiles(n):
    return -(-n // TILE)


def tc_dq(q, k, v, do, lse, delta, scale, causal):
    """K3 on the tensor cores, emulated → dQ in bf16."""
    S, Sk = q.shape[1], k.shape[1]
    nq, nk = _tiles(S), _tiles(Sk)
    qf, dof = _padded(q, nq * TILE), _padded(do, nq * TILE)
    kf, vf = _padded(k, nk * TILE), _padded(v, nk * TILE)
    lse_p, delta_p = _padded(lse, nq * TILE), _padded(delta, nq * TILE)
    dq = torch.zeros_like(qf)
    idx = torch.arange(TILE)
    for qt in range(nq):
        qs = slice(qt * TILE, (qt + 1) * TILE)
        rows = qt * TILE + idx[:, None]
        for kt in range(min(nk, qt + 1) if causal else nk):
            ks = slice(kt * TILE, (kt + 1) * TILE)
            cols = kt * TILE + idx[None, :]
            s = _mma_sum([qf[:, qs]], kf[:, ks].transpose(-1, -2))
            dp = _mma_sum([dof[:, qs]], vf[:, ks].transpose(-1, -2))
            masked = (cols >= Sk) | (causal & (rows < cols))
            p = torch.exp(torch.where(masked, NEG, s * scale) - lse_p[:, qs, None])
            ds = p * (dp - delta_p[:, qs, None]) * scale
            dq[:, qs] += _mma_sum([ds.bfloat16().float()], kf[:, ks])
    return dq[:, :S].bfloat16()


def tc_dkv(q, k, v, do, lse, delta, scale, causal, parts=_split, out_dtype=torch.bfloat16):
    """K4 on the tensor cores, emulated → (dK, dV) in ``out_dtype``;
    ``parts`` gives the bf16 terms that stand for P and dS."""
    S, Sk = q.shape[1], k.shape[1]
    nq, nk = _tiles(S), _tiles(Sk)
    qf, dof = _padded(q, nq * TILE), _padded(do, nq * TILE)
    kf, vf = _padded(k, nk * TILE), _padded(v, nk * TILE)
    lse_p, delta_p = _padded(lse, nq * TILE), _padded(delta, nq * TILE)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    idx = torch.arange(TILE)
    for kt in range(nk):
        ks = slice(kt * TILE, (kt + 1) * TILE)
        keys = kt * TILE + idx[:, None]
        for qt in range(kt if causal else 0, nq):
            qs = slice(qt * TILE, (qt + 1) * TILE)
            cols = qt * TILE + idx[None, :]  # queries
            st = _mma_sum([kf[:, ks]], qf[:, qs].transpose(-1, -2))  # Sᵀ [keys, queries]
            dpt = _mma_sum([vf[:, ks]], dof[:, qs].transpose(-1, -2))
            masked = (keys >= Sk) | (causal & (cols < keys))
            p = torch.exp(torch.where(masked, NEG, st * scale) - lse_p[:, None, qs])
            p = torch.where(cols < S, p, torch.zeros_like(p))
            ds = p * (dpt - delta_p[:, None, qs]) * scale
            dv[:, ks] += _mma_sum(parts(p), dof[:, qs])
            dk[:, ks] += _mma_sum(parts(ds), qf[:, qs])
    return dk[:, :Sk].to(out_dtype), dv[:, :Sk].to(out_dtype)


def _inputs(BH, S, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(BH, S, d)).astype(np.float32)).bfloat16()
            for _ in range(4)]  # q, k, v, dO


def _assert_flash_close(got, want, what):
    got, want = got.float(), want.float()
    bound = RTOL * want.abs() + ATOL * want.abs().max()
    err = (got - want).abs()
    assert torch.isfinite(got).all(), what
    assert (err <= bound).all(), (f"{what}: max |err| {err.max().item()} "
                                  f"(max|ref| {want.abs().max().item()})")


# (BH, S, d): the LM's head dim at its window and a ragged one; S = 96 ends
# half-way through the kernels' second 64-row tile
CASES = [(4, 256, 96), (4, 192, 96), (4, 96, 96), (2, 32, 16)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BH,S,d", CASES)
def test_emulated_tensor_core_backward_matches_plain_versions(BH, S, d, causal):
    q, k, v, do = _inputs(BH, S, d, seed=S + d)
    scale = d**-0.5
    # the plain versions at the kernels' tile where it divides S, else one block
    blk = TILE if S % TILE == 0 else S
    o, lse = fa.flash_forward_plain(q, k, v, scale, causal, blk, blk)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    args = (q, k, v, do, lse, delta, scale, causal)
    dq = tc_dq(*args)
    dk, dv = tc_dkv(*args)
    pdq = fa.flash_backward_dq_plain(*args, blk, blk)
    pdk, pdv = fa.flash_backward_dkv_plain(*args, blk, blk)
    for name, got, want in (("dQ", dq, pdq), ("dK", dk, pdk), ("dV", dv, pdv)):
        assert got.dtype == want.dtype == torch.bfloat16
        _assert_flash_close(got, want, f"{name} S={S} d={d} causal={causal}")


@pytest.mark.parametrize("causal", [True, False])
def test_emulated_tensor_core_backward_matches_reference(causal):
    """dQ, dK, dV of the emulation against the reference's custom VJP
    (Pallas interpret mode), bf16, two 64-row tiles."""
    BH, S, d = 2, 128, 32
    q, k, v, do = _inputs(BH, S, d, seed=7)

    def ref_out(q, k, v):
        return jax_flash(q, k, v, causal=causal, block_q=TILE, block_k=TILE)

    jarr = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v, do)]
    _, vjp = jax.vjp(ref_out, *jarr[:3])
    want = [torch.from_numpy(np.array(g.astype(jnp.float32))) for g in vjp(jarr[3])]

    scale = d**-0.5
    o, lse = fa.flash_forward_plain(q, k, v, scale, causal, TILE, TILE)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    args = (q, k, v, do, lse, delta, scale, causal)
    got = [tc_dq(*args), *tc_dkv(*args)]
    for name, g, w in zip(("dQ", "dK", "dV"), got, want):
        _assert_flash_close(g, w, f"{name} causal={causal}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BH,S,d", CASES[:3])
def test_emulated_k4_keeps_float32_products(BH, S, d, causal):
    """K4 is float32 throughout in the reference. Before the final rounding
    the emulated hi + lo products stay within 2⁻¹⁴·max|ref| of float32
    products of the same (exactly widened) inputs — measured ~3e-6 — while
    P and dS rounded to bf16 miss that bound (measured 1e-3 to 3e-3), which
    FLASH_TOL alone would not show."""
    q, k, v, do = _inputs(BH, S, d, seed=3)
    scale = d**-0.5
    blk = TILE if S % TILE == 0 else S
    o, lse = fa.flash_forward_plain(q, k, v, scale, causal, blk, blk)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    want = fa.flash_backward_dkv_plain(q.float(), k.float(), v.float(), do.float(), lse, delta,
                                       scale, causal, blk, blk)
    args = (q, k, v, do, lse, delta, scale, causal)
    split = tc_dkv(*args, out_dtype=torch.float32)
    rounded = tc_dkv(*args, parts=lambda x: (x.bfloat16().float(),), out_dtype=torch.float32)
    for name, got, bad, ref in zip(("dK", "dV"), split, rounded, want):
        bound = 2.0**-14 * ref.abs().max()
        assert (got - ref).abs().max() <= bound, name
        assert (bad - ref).abs().max() > bound, name


def test_hi_lo_split_keeps_sixteen_bits():
    """|hi + lo − x| ≤ 2⁻¹⁶·|x| over float32 values like K4's P and dS:
    exp outputs from 1 down to e⁻⁸⁰ (normal floats), values near 1, and
    signed products; 0 splits exactly. bf16(x) alone misses the bound by
    far, which is why K4 does not round P or dS."""
    rng = np.random.default_rng(11)
    s = rng.uniform(-80.0, 0.0, size=200_000).astype(np.float32)
    near_one = (1.0 - rng.uniform(0.0, 1e-3, size=50_000)).astype(np.float32)
    signed = (rng.normal(size=50_000) * rng.normal(size=50_000)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([np.exp(s), near_one, signed, [0.0, 1.0, -1.0]]))
    x = x.float()
    hi, lo = _split(x)
    assert (hi + lo - x).abs().le(2.0**-16 * x.abs()).all()
    assert (hi + lo)[x == 0].eq(0).all()
    rel_hi = ((hi - x).abs() / x.abs().clamp_min(1e-38)).max().item()
    assert rel_hi > 2.0**-10  # a single bf16 keeps only ~8 bits


def test_launch_refuses_operands_not_16_byte_aligned():
    """The bf16 kernels copy rows 16 bytes at a time (cp.async, uint4
    stores); the launcher refuses a view that starts off that alignment
    (it raises before it calls ``fn``, so a CPU tensor and no library do)."""
    base = torch.zeros(2 * 64 * 32 + 1)
    q = base[1:].view(2, 64, 32)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._launch(fa.BWD_DQ, None, q, [(q, "q")], 64, False, 0.25)
