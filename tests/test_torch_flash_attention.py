"""The port's flash attention (fedml_tpu_torch/ops/flash_attention.py)
against the reference's Pallas kernels (interpret mode on the CPU): the
forward and dQ/dK/dV through the autograd Function, at the reference
tests' shapes plus the LM's head dim 96, causal and not, float32 and
bfloat16; the shape guards; and the plain full_attention.

On the CPU the port runs its kernels' plain versions, the same blockwise
arithmetic at the same block sizes, so the two packages differ only in the
order of float32 sums. Tolerances:
- float32: 1e-5 absolute (values and gradients are O(1); the observed
  differences are ~1e-6, from summation order in the float32 products);
- bfloat16: 2^-7 relative plus 2^-8 of the largest magnitude — a bf16
  rounding (of P, of dS or of the output) may go the other way when the
  float32 sums before it differ in their last bits, one bf16 ulp (2^-8
  relative) of that value."""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from fedml_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402
from fedml_tpu.parallel.ring_attention import full_attention as jax_full  # noqa: E402

from fedml_tpu_torch.ops import flash_attention as fa  # noqa: E402
from fedml_tpu_torch.parallel.ring_attention import full_attention  # noqa: E402

# (shape, block) — block None: the default 512, clamped to S
CASES = [((2, 2, 128, 32), 64), ((1, 192, 16), 64), ((1, 32, 16), None), ((1, 2, 64, 96), 32)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]  # q, k, v, dO


def _assert_close(got, want, dtype, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=what)
    else:
        atol = 2.0**-8 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=atol, err_msg=what)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape,block", CASES, ids=lambda c: str(c))
def test_forward_and_gradients_match_reference(shape, block, causal, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v, g = _inputs(shape)
    blocks = {} if block is None else dict(block_q=block, block_k=block)

    def jax_loss(q, k, v):
        out = jax_flash(q, k, v, causal=causal, **blocks)
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, jout), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v))
    )
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v))
    before = dict(fa.LAUNCHES)
    tout = fa.flash_attention(tq, tk, tv, causal=causal, **blocks)
    assert tout.dtype == tdt and tout.shape == tq.shape
    (tout.float() * torch.from_numpy(g)).sum().backward()
    assert fa.LAUNCHES == before  # CPU tensors: the plain versions, no launch

    _assert_close(tout.detach().float(), jout.astype(jnp.float32), dtype, "O")
    for name, jg, t in zip(("dQ", "dK", "dV"), jgrads, (tq, tk, tv)):
        assert t.grad.dtype == tdt
        _assert_close(t.grad.float(), jg.astype(jnp.float32), dtype, name)


def test_lse_is_the_log_sum_exp_of_the_scores():
    q, k, v, _ = (torch.from_numpy(a).reshape(2, 64, 16) for a in _inputs((2, 64, 16)))
    _, lse = fa.flash_forward(q, k, v, 0.25, True, 32, 32)
    s = torch.einsum("bqd,bkd->bqk", q, k) * 0.25
    s = s.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), rtol=1e-6, atol=1e-5)


def _guard_cases():
    z = np.zeros
    return [
        # S not a multiple of the block
        (dict(q=z((1, 96, 16)), k=z((1, 96, 16)), v=z((1, 96, 16)), block_q=64, block_k=64), True),
        # causal needs S == Sk
        (dict(q=z((1, 64, 16)), k=z((1, 128, 16)), v=z((1, 128, 16)), causal=True), True),
        # q/k/v leading dims differ (MQA not broadcast)
        (dict(q=z((2, 4, 64, 16)), k=z((2, 1, 64, 16)), v=z((2, 1, 64, 16))), True),
        # head dims the kernels are not built for: the reference takes them, and
        # so does the port (plain versions on the CPU; on the card, d ≤ 128 padded)
        (dict(q=z((1, 64, 8)), k=z((1, 64, 8)), v=z((1, 64, 8))), False),
        (dict(q=z((1, 64, 256)), k=z((1, 64, 256)), v=z((1, 64, 256))), False),
    ]


@pytest.mark.parametrize("case,reference_raises", _guard_cases())
def test_shape_guards_raise_value_error(case, reference_raises):
    """The port raises ValueError where the reference does, and takes what
    the reference takes, with the reference's O."""
    kw = dict(case)
    arrays = {n: kw.pop(n).astype(np.float32) for n in ("q", "k", "v")}
    if reference_raises:
        with pytest.raises(ValueError):
            fa.flash_attention(*(torch.from_numpy(a) for a in arrays.values()), **kw)
        with pytest.raises(ValueError):
            jax_flash(*(jnp.asarray(a) for a in arrays.values()), **kw)
    else:
        got = fa.flash_attention(*(torch.from_numpy(a) for a in arrays.values()), **kw)
        want = jax_flash(*(jnp.asarray(a) for a in arrays.values()), **kw)
        _assert_close(got, want, "float32", "O")


def test_mixed_input_types_raise():
    q = torch.zeros(1, 64, 16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), q.half(), q.half())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_matches_reference(causal, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v, _ = _inputs((2, 48, 2, 16), seed=5)  # [B, T, H, D]
    want = jax_full(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), causal=causal)
    got = full_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal)
    assert got.dtype == tdt
    _assert_close(got.float(), want.astype(jnp.float32), dtype, "full_attention")


def test_bthd_adapter_equals_full_attention():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs((2, 64, 2, 32), seed=6))
    flash = functools.partial(fa.flash_attention_bthd, block_q=32, block_k=32)
    torch.testing.assert_close(flash(q, k, v), full_attention(q, k, v, causal=True),
                               rtol=1e-5, atol=1e-5)


def test_launch_checks_operands_before_the_c_call():
    """The C entry points take shapes, types and contiguity on trust; the
    launcher refuses what they would misread (it raises before it calls
    ``fn``, so a CPU tensor and no library do here)."""
    q = torch.zeros(2, 64, 32)
    lse = torch.zeros(2, 64)

    def launch(*operands, causal=False, Sk=64, q=q):
        fa._launch(fa.FWD, None, q, list(operands), Sk, causal, 0.25)

    bad = [
        [(q, "q"), (q.transpose(1, 2).contiguous().transpose(1, 2), "k")],  # not contiguous
        [(q, "q"), (q.bfloat16(), "k")],                                    # mixed types
        [(q, "q"), (torch.zeros(2, 64, 16), "k")],                          # wrong head dim
        [(q, "q"), (lse.double(), "row")],                                  # rows not float32
        [(q, "q"), (torch.zeros(2, 32), "row")],                            # rows too short
    ]
    for operands in bad:
        with pytest.raises(ValueError, match="operand"):
            launch(*operands)
    with pytest.raises(ValueError, match="no kernel"):
        launch((q, "q"), causal=True, Sk=128)
    with pytest.raises(ValueError, match="no kernel"):
        launch(q=torch.zeros(2, 64, 24))
