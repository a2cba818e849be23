"""A plain-PyTorch emulation of the arithmetic of the bfloat16 flash
forward kernel on the tensor cores (``flash_fwd_tc_kernel`` in
fedml_tpu_torch/ops/csrc/flash_attention.cu), held to the port's plain
version and once to the reference's Pallas forward (interpret mode).

The kernel runs only on the card; this file shows on the CPU that its
arithmetic stays inside the bounds ``chip_smoke.py`` holds it to there.
What the emulation does, as the kernel does:

- S = Q·Kᵀ from bf16 inputs, summed in float32 in steps of 16 along the
  head dim (one mma's depth), then scaled; columns past Sk and, under the
  causal mask, above the diagonal take the mask value −1e30;
- the online softmax over 64-key tiles in float32: m_new = max(m, rowmax),
  p = exp(s − m_new), corr = exp(m − m_new), l = l·corr + Σp over the
  float32 p, acc = acc·corr + P·V;
- P rounded to bf16 (the reference's ``p.astype(v.dtype)``) as the A
  operand of P·V, summed in float32 16 keys at a time;
- O = acc / l (l = 1 where it is 0) rounded to bf16 once; LSE = m + log l;
- 64-row tiles; rows past S and Sk load as zeros and are never stored.

Tolerances: ``chip_smoke.py``'s FLASH_TOL. O (bf16): |err| ≤ 2⁻⁷·|ref| +
2⁻⁸·max|ref| — the emulation and the plain version sum the same float32
terms in another order, so a rounding of P or O may go the other way, one
bf16 ulp. LSE (float32): 1e-5·|ref| + 1e-5·max|ref|. The order of the sums
inside one mma is the hardware's and is not emulated; it is one more order
of the same float32 sums, which the same bounds cover on the card."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from fedml_tpu.ops.flash_attention import _flash_forward as jax_flash_forward  # noqa: E402

from fedml_tpu_torch.ops import flash_attention as fa  # noqa: E402

TILE, MMA_K = fa.KERNEL_TILE, 16
NEG = -1e30
O_TOL = (2.0**-7, 2.0**-8)  # chip_smoke.py FLASH_TOL["bfloat16"]
LSE_TOL = (1e-5, 1e-5)  # chip_smoke.py FLASH_TOL["float32"]


def _mma_sum(a, b):
    """a @ b in float32, the reduction taken 16 at a time (one mma's depth)."""
    acc = 0.0
    for k0 in range(0, b.shape[-2], MMA_K):
        acc = acc + a[..., k0 : k0 + MMA_K] @ b[..., k0 : k0 + MMA_K, :]
    return acc


def _padded(x, rows):
    """float32 copy of x [BH, n, d] with zero rows up to ``rows``."""
    out = torch.zeros((x.shape[0], rows) + tuple(x.shape[2:]), dtype=torch.float32)
    out[:, : x.shape[1]] = x.float()
    return out


def tc_forward(q, k, v, scale, causal, l_from_rounded_p=False):
    """K2 on the tensor cores, emulated → (O in bf16, LSE float32).
    ``l_from_rounded_p`` sums the bf16 P into l instead of the float32 p:
    the design the kernel must not have."""
    BH, S, d = q.shape
    Sk = k.shape[1]
    nq, nk = -(-S // TILE), -(-Sk // TILE)
    qf, kf, vf = _padded(q, nq * TILE), _padded(k, nk * TILE), _padded(v, nk * TILE)
    o = torch.zeros_like(qf)
    lse = torch.zeros(BH, nq * TILE)
    idx = torch.arange(TILE)
    for qt in range(nq):
        qs = slice(qt * TILE, (qt + 1) * TILE)
        rows = qt * TILE + idx[:, None]
        m = torch.full((BH, TILE, 1), NEG)
        l = torch.zeros(BH, TILE, 1)
        acc = torch.zeros(BH, TILE, d)
        for kt in range(min(nk, qt + 1) if causal else nk):
            ks = slice(kt * TILE, (kt + 1) * TILE)
            cols = kt * TILE + idx[None, :]
            s = _mma_sum(qf[:, qs], kf[:, ks].transpose(-1, -2)) * scale
            s = torch.where((cols >= Sk) | (causal & (rows < cols)), NEG, s)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            pb = p.bfloat16().float()
            l = l * corr + (pb if l_from_rounded_p else p).sum(dim=-1, keepdim=True)
            acc = acc * corr + _mma_sum(pb, vf[:, ks])
            m = m_new
        safe_l = torch.where(l > 0, l, torch.ones_like(l))
        o[:, qs] = acc / safe_l
        lse[:, qs] = (m + torch.log(safe_l))[..., 0]
    return o[:, :S].bfloat16(), lse[:, :S]


def _inputs(BH, S, Sk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(BH, S, d))
    k, v = (rng.normal(size=(BH, Sk, d)) for _ in range(2))
    return [torch.from_numpy(t.astype(np.float32)).bfloat16() for t in (q, k, v)]


def _excess(got, want, tol):
    """max of |got − want| − (rtol·|want| + atol·max|want|): ≤ 0 inside."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    rtol, atol = tol
    return ((got - want).abs() - rtol * want.abs() - atol * want.abs().max()).max().item()


def _assert_close(got, want, tol, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    assert _excess(got, want, tol) <= 0, (
        f"{what}: max |err| {(got.float() - want.float()).abs().max().item()} "
        f"(max|ref| {want.float().abs().max().item()})")


# (BH, S, Sk, d, causal): one tile of 32 rows, two and three full tiles,
# S = 96 ending half-way through the second tile, causal and not; and Sk ≠ S
# (chip_smoke.py's 128 × 192, not causal)
CASES = [(2, S, S, d, causal) for S in (32, 96, 128, 192) for d in (16, 96)
         for causal in (True, False)] + [(3, 128, 192, 64, False), (3, 128, 192, 96, False)]


@pytest.mark.parametrize("BH,S,Sk,d,causal", CASES)
def test_emulated_tensor_core_forward_matches_plain_version(BH, S, Sk, d, causal):
    q, k, v = _inputs(BH, S, Sk, d, seed=S + Sk + d)
    scale = d**-0.5
    # the plain version at the kernel's tile where it divides S, else one block
    bq, bk = (TILE if n % TILE == 0 else n for n in (S, Sk))
    po, plse = fa.flash_forward_plain(q, k, v, scale, causal, bq, bk)
    o, lse = tc_forward(q, k, v, scale, causal)
    _assert_close(o, po, O_TOL, f"O S={S} Sk={Sk} d={d} causal={causal}")
    _assert_close(lse, plse, LSE_TOL, f"LSE S={S} Sk={Sk} d={d} causal={causal}")


@pytest.mark.parametrize("causal", [True, False])
def test_emulated_tensor_core_forward_matches_reference(causal):
    """O and LSE of the emulation against the reference's Pallas forward
    (interpret mode), bf16, two 64-row tiles."""
    BH, S, d = 2, 128, 32
    q, k, v = _inputs(BH, S, S, d, seed=7)
    scale = d**-0.5
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
    jo, jlse = jax_flash_forward(jq, jk, jv, scale, causal, TILE, TILE, True)
    want_o = torch.from_numpy(np.array(jo.astype(jnp.float32))).bfloat16()
    want_lse = torch.from_numpy(np.array(jlse)[:, 0, :])  # [BH, 8, S], rows replicated
    o, lse = tc_forward(q, k, v, scale, causal)
    _assert_close(o, want_o, O_TOL, f"O causal={causal}")
    _assert_close(lse, want_lse, LSE_TOL, f"LSE causal={causal}")


def test_l_summed_from_rounded_p_breaks_the_lse_bound():
    """l must be summed from the float32 p: summing the bf16 P that enters
    P·V moves a row's LSE by up to ~2⁻⁹, outside LSE_TOL, while O stays
    inside its bf16 bound — so only the LSE check tells the two apart."""
    BH, S, d = 2, 128, 96
    q, k, v = _inputs(BH, S, S, d, seed=5)
    scale = d**-0.5
    po, plse = fa.flash_forward_plain(q, k, v, scale, True, TILE, TILE)
    o, lse = tc_forward(q, k, v, scale, True, l_from_rounded_p=True)
    assert _excess(o, po, O_TOL) <= 0
    assert _excess(lse, plse, LSE_TOL) > 0
    _, good_lse = tc_forward(q, k, v, scale, True)
    assert _excess(good_lse, plse, LSE_TOL) <= 0
