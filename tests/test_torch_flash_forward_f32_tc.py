"""A plain-PyTorch emulation of the arithmetic of the float32 flash forward
kernel on the tensor cores (``flash_fwd_f32tc_kernel`` in
fedml_tpu_torch/ops/csrc/flash_attention.cu), held to the port's plain
version and once to the reference's Pallas forward (interpret mode).

The kernel runs only on the card; this file shows on the CPU that its
arithmetic stays inside the bound ``chip_smoke.py`` holds it to there
(FLASH_TOL["float32"]). What the emulation does, as the kernel does:

- every float32 operand x is split into hi = tf32(x), rounded to nearest
  with ties away from zero (``cvt.rna.tf32.f32``'s rounding, which the
  kernel does on the int32 view: add 2¹², clear the low 13 bits), and the
  exact remainder lo = x − hi; the tensor core reads each operand's top 19
  bits (TF32), so lo enters the products truncated to TF32;
- a product a·b of split operands is hi·hi + hi·lo + lo·hi (3xTF32), taken
  8 along the depth at a time (one m16n8k8 mma), the three added to the
  float32 accumulator one after another: hi·lo, lo·hi, then hi·hi;
- inside each 8-deep step the depth is read in the kernel's slot order
  (0, 2, 4, 6, 1, 3, 5, 7): for S = Q·Kᵀ the head-dim columns, for P·V the
  keys, so that P comes straight from the score accumulators;
- 64-row query tiles, 32-key tiles, the online softmax in float32 over each
  key tile (m_new = max(m, rowmax), p = exp(s − m_new), corr = exp(m −
  m_new), l = l·corr + Σp, acc = acc·corr + P·V), P kept in float32 (split
  like any operand); the mask value −1e30 above the diagonal and past Sk;
- O = acc / l (l = 1 where it is 0); LSE = m + log l.

The order of the sums inside one mma is the hardware's and is not
emulated; it is one more order of the same float32 sums. A negative
control shows why the split is needed: one TF32 product (hi·hi alone)
breaks the bound on the same inputs."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from fedml_tpu.ops.flash_attention import _flash_forward as jax_flash_forward  # noqa: E402

from fedml_tpu_torch.ops import flash_attention as fa  # noqa: E402

TILE, KEYS, MMA_K = fa.KERNEL_TILE, 32, 8
SLOTS = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])  # a k8 step's depth in slot order
NEG = -1e30
TOL = (1e-5, 1e-5)  # chip_smoke.py FLASH_TOL["float32"]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 register: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    """The kernel's split: hi rounded to TF32, lo the exact remainder as the
    tensor core reads it."""
    hi = tf32_rna(x)
    return hi, tf32_truncate(x - hi)


def mma_product(a, b, split_operands=True):
    """a [.., m, K] @ b [.., K, n] as the kernel's mma steps: 8 along K at a
    time in slot order, three TF32 products each (one with
    ``split_operands=False``), added to a float32 accumulator in turn."""
    K = a.shape[-1]
    order = (torch.arange(0, K, MMA_K)[:, None] + SLOTS[None, :]).reshape(-1)
    a, b = a[..., order], b[..., order, :]
    (ahi, alo), (bhi, blo) = split(a), split(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, K, MMA_K):
        ks = slice(k0, k0 + MMA_K)
        if split_operands:
            acc = acc + ahi[..., ks] @ blo[..., ks, :]
            acc = acc + alo[..., ks] @ bhi[..., ks, :]
        acc = acc + ahi[..., ks] @ bhi[..., ks, :]
    return acc


def _padded(x, rows):
    out = torch.zeros((x.shape[0], rows) + tuple(x.shape[2:]), dtype=torch.float32)
    out[:, : x.shape[1]] = x
    return out


def tc_forward_f32(q, k, v, scale, causal, split_operands=True):
    """K2 for float32 on the tensor cores, emulated → (O, LSE) in float32."""
    BH, S, d = q.shape
    Sk = k.shape[1]
    nq, nk = -(-S // TILE), -(-Sk // KEYS)
    qf, kf, vf = _padded(q, nq * TILE), _padded(k, nk * KEYS), _padded(v, nk * KEYS)
    o = torch.zeros_like(qf)
    lse = torch.zeros(BH, nq * TILE)
    for qt in range(nq):
        qs = slice(qt * TILE, (qt + 1) * TILE)
        rows = qt * TILE + torch.arange(TILE)[:, None]
        m = torch.full((BH, TILE, 1), NEG)
        l = torch.zeros(BH, TILE, 1)
        acc = torch.zeros(BH, TILE, d)
        k_end = min(nk, (qt * TILE + TILE - 1) // KEYS + 1) if causal else nk
        for kt in range(k_end):
            ks = slice(kt * KEYS, (kt + 1) * KEYS)
            cols = kt * KEYS + torch.arange(KEYS)[None, :]
            s = mma_product(qf[:, qs], kf[:, ks].transpose(-1, -2), split_operands) * scale
            s = torch.where((cols >= Sk) | (causal & (rows < cols)), NEG, s)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + mma_product(p, vf[:, ks], split_operands)
            m = m_new
        safe_l = torch.where(l > 0, l, torch.ones_like(l))
        o[:, qs] = acc / safe_l
        lse[:, qs] = (m + torch.log(safe_l))[..., 0]
    return o[:, :S], lse[:, :S]


def _inputs(BH, S, Sk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(BH, S, d))
    k, v = (rng.normal(size=(BH, Sk, d)) for _ in range(2))
    return [torch.from_numpy(t.astype(np.float32)) for t in (q, k, v)]


def _excess(got, want, tol=TOL):
    """max of |got − want| − (rtol·|want| + atol·max|want|): ≤ 0 inside."""
    assert torch.isfinite(got).all()
    rtol, atol = tol
    return ((got - want).abs() - rtol * want.abs() - atol * want.abs().max()).max().item()


def _assert_close(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32, what
    assert _excess(got, want) <= 0, (
        f"{what}: max |err| {(got - want).abs().max().item()} "
        f"(max|ref| {want.abs().max().item()})")


def _plain(q, k, v, scale, causal):
    # the plain version at 64-row tiles where they divide S, else one block
    bq, bk = (TILE if n % TILE == 0 else n for n in (q.shape[1], k.shape[1]))
    return fa.flash_forward_plain(q, k, v, scale, causal, bq, bk)


# (BH, S, Sk, d, causal): one 32-row tile, two and three 64-row tiles, at
# the smallest, the LM's and the largest head dim, causal and not; and
# Sk ≠ S (chip_smoke.py's 128 × 192, not causal)
CASES = [(2, S, S, d, causal) for S in (32, 128, 192) for d in (16, 96, 128)
         for causal in (True, False)] + [(3, 128, 192, 64, False)]


@pytest.mark.parametrize("BH,S,Sk,d,causal", CASES)
def test_emulated_split_tf32_forward_matches_plain_version(BH, S, Sk, d, causal):
    q, k, v = _inputs(BH, S, Sk, d, seed=S + Sk + d + causal)
    scale = d**-0.5
    po, plse = _plain(q, k, v, scale, causal)
    o, lse = tc_forward_f32(q, k, v, scale, causal)
    _assert_close(o, po, f"O S={S} Sk={Sk} d={d} causal={causal}")
    _assert_close(lse, plse, f"LSE S={S} Sk={Sk} d={d} causal={causal}")


@pytest.mark.parametrize("causal", [True, False])
def test_emulated_split_tf32_forward_matches_reference(causal):
    """O and LSE of the emulation against the reference's Pallas forward
    (interpret mode), float32, two 64-row tiles."""
    BH, S, d = 2, 128, 32
    q, k, v = _inputs(BH, S, S, d, seed=11)
    scale = d**-0.5
    jo, jlse = jax_flash_forward(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                 scale, causal, TILE, TILE, True)
    want_o = torch.from_numpy(np.array(jo))
    want_lse = torch.from_numpy(np.array(jlse)[:, 0, :])  # [BH, 8, S], rows replicated
    o, lse = tc_forward_f32(q, k, v, scale, causal)
    _assert_close(o, want_o, f"O causal={causal}")
    _assert_close(lse, want_lse, f"LSE causal={causal}")


@pytest.mark.parametrize("d", [16, 96])
def test_one_tf32_product_breaks_the_float32_bound(d):
    """Without the split, each product keeps TF32's 11 bits: on the same
    inputs O leaves FLASH_TOL["float32"], while the split stays inside it."""
    q, k, v = _inputs(2, 128, 128, d, seed=3)
    scale = d**-0.5
    po, plse = _plain(q, k, v, scale, True)
    o1, lse1 = tc_forward_f32(q, k, v, scale, True, split_operands=False)
    assert max(_excess(o1, po), _excess(lse1, plse)) > 0
    o3, lse3 = tc_forward_f32(q, k, v, scale, True)
    assert max(_excess(o3, po), _excess(lse3, plse)) <= 0


def test_tf32_rounding_is_to_nearest_ties_away():
    """The emulated cvt.rna: 10 mantissa bits kept, halves rounded away from
    zero for either sign; x − hi is exact, and hi + lo, lo as the tensor
    core reads it, recovers x to 2⁻²¹ of it."""
    one = 1.0
    ulp = 2.0**-10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4],
                     dtype=torch.float32)
    assert tf32_rna(x).tolist() == [one + ulp, -(one + ulp), one, one + ulp]
    y = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    hi, lo = split(y)
    assert (tf32_truncate(hi) == hi).all() and (tf32_truncate(lo) == lo).all()
    assert ((y - hi - lo).abs() <= 2.0**-21 * y.abs()).all()
