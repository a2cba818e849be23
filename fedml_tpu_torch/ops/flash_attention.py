"""Blockwise (flash) attention, kernels K2 (forward), K3 (backward dQ) and
K4 (backward dK/dV) (port of ``fedml_tpu/ops/flash_attention.py``).

softmax(Q Kᵀ/√d [causal]) V by online softmax, never holding the S×S
scores in device memory; the forward saves the log-sum-exp rows, and the
backward recomputes P from them tile by tile: dQ over the key tiles, dK and
dV over the query tiles (FlashAttention, Dao et al. 2022; online softmax per
Milakov & Gionis).

Two versions of each kernel's function:

- the CUDA kernels in ``csrc/flash_attention.cu`` (Hopper, ``sm_90a``),
  launched by :func:`flash_forward` / :func:`flash_backward_dq` /
  :func:`flash_backward_dkv` for CUDA tensors. They pick their own tiles
  (:data:`KERNEL_TILE` rows), so on the card ``block_q``/``block_k`` only
  bound what the caller may pass. All of them run on the tensor cores
  (``mma.sync`` with float32 sums; the float32 cluster kernels form their
  scores with ``wgmma``). For bfloat16: K2 sums l over the
  float32 P before it rounds P for P·V; K4 multiplies its float32 P and dS
  as bf16 hi + lo pairs, so it rounds neither. For float32, every operand
  of every product (Q, K, V, dO, and P and dS from the accumulators) is
  split into a TF32 hi and its exact remainder lo, and each product is
  taken as hi·lo + lo·hi + hi·hi (3xTF32), good to ~2⁻²⁰ of it;
- :func:`flash_forward_plain`, :func:`flash_backward_dq_plain` and
  :func:`flash_backward_dkv_plain`: the same blockwise arithmetic with the
  same casts in PyTorch ops, at the caller's block sizes and any head dim;
  the wrappers use them for CPU tensors, and nothing else.

The kernels are built for the head dims :data:`HEAD_DIMS`; above the
largest, the chunked kernels take any multiple of :data:`WIDE_CHUNK`: a
third grid dimension splits the output's head dim into chunks of that
width, and each block forms its scores over the whole d through shared
memory, chunk by chunk. The float32 K3 and K4 up to 8 chunks (d ≤ 1024)
are cluster kernels instead: the chunks' blocks of a tile form a
thread-block cluster, each sums its chunk's share of the scores on
``wgmma`` and reads the others' shares from their shared memory, so each
score is formed once. On the card any other d is zero-padded to the next
width the kernels take (:func:`built_head_dim`, :func:`at_built_head_dim`):
zero columns change neither Q·Kᵀ, dO·Vᵀ, LSE nor δ, the caller's scale
stays 1/√d of the true d, and O, dQ, dK and dV are sliced back to d.

The casts that decide the bfloat16 numbers are the reference kernel's: P is
rounded to v's type before P·V (K2), dO·Vᵀ is float32 and dS is rounded to
k's type before dS·K (K3), K4 is float32 throughout, and every output is
rounded to the inputs' type. δ = rowsum(dO∘O) is float32 torch ops outside
any kernel, as in the reference.

Under ``torch.func.vmap`` (the batched client schedule) each kernel's
Function folds the client axis into BH: the whole cohort's attention is
one K2, one K3 and one K4 launch a layer a step, on the card as on the
CPU's plain versions.

``LAUNCHES`` counts kernel launches by kernel and operand type, the
chunked kernels (head dims above :data:`HEAD_DIMS`) under the type's
``CHUNKED`` key (only the CUDA branches add to it; :func:`launch_totals`
gives each kernel's sum), so a run can show which kernels it went through. The v5e timings in the
reference module's docstring are the TPU's, not this port's."""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from fedml_tpu_torch.ops._build import count_launch, load_kernel_library

FWD, BWD_DQ, BWD_DKV = "flash_attention.fwd", "flash_attention.bwd_dq", "flash_attention.bwd_dkv"
KERNEL_NAMES = (FWD, BWD_DQ, BWD_DKV)
OPERAND_TYPES = ("float32", "bfloat16")
CHUNKED = {t: t + ".chunked" for t in OPERAND_TYPES}  # the chunked kernels' launch keys
# launches by (kernel, operand type or CHUNKED[type]); launch_totals() sums them
LAUNCHES: Dict[Tuple[str, str], int] = {(name, t): 0 for name in KERNEL_NAMES
                                        for t in (*OPERAND_TYPES, *CHUNKED.values())}

KERNEL_TILE = 64  # rows of the kernels' query tiles and key tiles (csrc kTile; float32 K2: 32 keys)
HEAD_DIMS = (16, 32, 64, 96, 128)  # the head dims the kernels are built for
WIDE_CHUNK = 128  # above HEAD_DIMS: the chunked kernels' head-dim chunk (csrc kWide)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30


def launch_totals() -> Dict[str, int]:
    """Each kernel's launches, both operand types and the chunked kernels
    together."""
    return {name: sum(n for (kn, _), n in LAUNCHES.items() if kn == name) for name in KERNEL_NAMES}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ---------------------------------------------------------------- plain versions


def _masked_scores(q, k, q0: int, k0: int, scale: float, causal: bool):
    """Scaled float32 scores of one (query block, key block) pair with the
    causal mask — the one definition the three plain versions share."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        rows = q0 + torch.arange(q.shape[-2], device=q.device)[:, None]
        cols = k0 + torch.arange(k.shape[-2], device=q.device)[None, :]
        s = torch.where(rows >= cols, s, torch.full_like(s, _NEG_INF))
    return s


def _live(q0: int, block_q: int, k0: int, causal: bool) -> bool:
    """A block pair is live unless every (row, col) in it has col > row."""
    return not causal or k0 <= q0 + block_q - 1


def flash_forward_plain(q, k, v, scale: float, causal: bool, block_q: int, block_k: int):
    """K2's arithmetic on q [BH, S, d], k/v [BH, Sk, d] → (O [BH, S, d] in
    q's type, LSE [BH, S] float32)."""
    BH, S, d = q.shape
    Sk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty(BH, S, dtype=torch.float32, device=q.device)
    for q0 in range(0, S, block_q):
        qb = q[:, q0 : q0 + block_q]
        acc = torch.zeros(BH, block_q, d, dtype=torch.float32, device=q.device)
        m = torch.full((BH, block_q, 1), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros(BH, block_q, 1, dtype=torch.float32, device=q.device)
        for k0 in range(0, Sk, block_k):
            if not _live(q0, block_q, k0, causal):
                break
            s = _masked_scores(qb, k[:, k0 : k0 + block_k], q0, k0, scale, causal)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            m = m_new
            pv = torch.matmul(p.to(v.dtype).float(), v[:, k0 : k0 + block_k].float())
            acc = acc * corr + pv
        safe_l = torch.where(l > 0, l, torch.ones_like(l))
        out[:, q0 : q0 + block_q] = (acc / safe_l).to(q.dtype)
        lse[:, q0 : q0 + block_q] = (m + torch.log(safe_l))[..., 0]
    return out, lse


def flash_backward_dq_plain(q, k, v, do, lse, delta, scale: float, causal: bool,
                            block_q: int, block_k: int):
    """K3's arithmetic → dQ [BH, S, d] in q's type."""
    S, Sk = q.shape[1], k.shape[1]
    dq = torch.empty_like(q)
    for q0 in range(0, S, block_q):
        qs = slice(q0, q0 + block_q)
        acc = torch.zeros(q[:, qs].shape, dtype=torch.float32, device=q.device)
        for k0 in range(0, Sk, block_k):
            if not _live(q0, block_q, k0, causal):
                break
            ks = slice(k0, k0 + block_k)
            s = _masked_scores(q[:, qs], k[:, ks], q0, k0, scale, causal)
            p = torch.exp(s - lse[:, qs, None])
            dov = torch.matmul(do[:, qs].float(), v[:, ks].float().transpose(-1, -2))
            ds = p * (dov - delta[:, qs, None]) * scale
            acc = acc + torch.matmul(ds.to(k.dtype).float(), k[:, ks].float())
        dq[:, qs] = acc.to(q.dtype)
    return dq


def flash_backward_dkv_plain(q, k, v, do, lse, delta, scale: float, causal: bool,
                             block_q: int, block_k: int):
    """K4's arithmetic (float32 throughout) → (dK, dV) in k's and v's types."""
    S, Sk = q.shape[1], k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for k0 in range(0, Sk, block_k):
        ks = slice(k0, k0 + block_k)
        dk_acc = torch.zeros(k[:, ks].shape, dtype=torch.float32, device=k.device)
        dv_acc = torch.zeros_like(dk_acc)
        for q0 in range(0, S, block_q):
            if not _live(q0, block_q, k0, causal):
                continue
            qs = slice(q0, q0 + block_q)
            s = _masked_scores(q[:, qs], k[:, ks], q0, k0, scale, causal)
            p = torch.exp(s - lse[:, qs, None])
            dof = do[:, qs].float()
            dv_acc = dv_acc + torch.matmul(p.transpose(-1, -2), dof)
            dov = torch.matmul(dof, v[:, ks].float().transpose(-1, -2))
            ds = p * (dov - delta[:, qs, None]) * scale
            dk_acc = dk_acc + torch.matmul(ds.transpose(-1, -2), q[:, qs].float())
        dk[:, ks] = dk_acc.to(k.dtype)
        dv[:, ks] = dv_acc.to(v.dtype)
    return dk, dv


# ---------------------------------------------------------------- the kernels


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind the three C entry points."""
    lib = load_kernel_library("flash_attention")
    if (lib.fedml_flash_max_head_dim() != max(HEAD_DIMS) or lib.fedml_flash_tile() != KERNEL_TILE
            or lib.fedml_flash_wide_chunk() != WIDE_CHUNK):
        raise RuntimeError("csrc/flash_attention.cu disagrees with HEAD_DIMS / KERNEL_TILE / "
                           "WIDE_CHUNK")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [I, I, I, I, F, P]  # bh, s_len, sk_len, causal, scale, stream
    lib.fedml_flash_fwd.argtypes = [I, I, P, P, P, P, P] + shape
    lib.fedml_flash_bwd_dq.argtypes = [I, I, P, P, P, P, P, P, P] + shape
    lib.fedml_flash_bwd_dkv.argtypes = [I, I, P, P, P, P, P, P, P, P] + shape
    lib.fedml_flash_kernel_info.argtypes = [I, I, I, ctypes.POINTER(I)]
    for fn in (lib.fedml_flash_fwd, lib.fedml_flash_bwd_dq, lib.fedml_flash_bwd_dkv,
               lib.fedml_flash_kernel_info):
        fn.restype = ctypes.c_int
    return lib


def kernel_info(name: str, dtype: torch.dtype, head_dim: int) -> Dict[str, int | str]:
    """The kernel that ``name`` launches for (dtype, head_dim), as the
    launch picks it at :func:`built_head_dim` (head_dim): its CUDA
    ``function`` (built for the head dim, chunked, or the float32 K3/K4
    cluster kernel), threads a block, registers and local-memory bytes a
    thread (spills land there), dynamic shared memory a block, and the
    blocks one SM holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    out = (ctypes.c_int * 6)()
    err = _lib().fedml_flash_kernel_info(_DTYPE_CODE[dtype], built_head_dim(head_dim),
                                         KERNEL_NAMES.index(name), out)
    if err != 0:
        raise RuntimeError(f"{name}: no kernel info for {dtype}, head dim {head_dim}: error {err}")
    stem = {FWD: "flash_fwd", BWD_DQ: "flash_bwd_dq", BWD_DKV: "flash_bwd_dkv"}[name]
    family = ("", "_wide", "_cluster")[out[5]]  # csrc Family
    keys = ("threads", "registers", "local_bytes", "smem_bytes", "blocks_per_sm")
    return {"function": stem + family + ("_f32tc_kernel" if dtype == torch.float32
                                         else "_tc_kernel"), **dict(zip(keys, out))}


def _launch(name: str, fn, q, operands, Sk: int, causal: bool, scale: float) -> None:
    """Check what the C entry point takes on trust, then launch.
    ``operands`` are (tensor, kind) in the C argument order; kind "q" is
    [BH, S, d] and "k" [BH, Sk, d] in q's type, "row" [BH, S] float32."""
    BH, S, d = q.shape
    if built_head_dim(d) != d or q.dtype not in _DTYPE_CODE or (causal and S != Sk):
        raise ValueError(f"{name}: no kernel for head dim {d}, {q.dtype}, "
                         f"causal={causal} with S={S}, Sk={Sk}")
    want = {"q": ((BH, S, d), q.dtype), "k": ((BH, Sk, d), q.dtype),
            "row": ((BH, S), torch.float32)}
    for t, kind in operands:
        shape, dtype = want[kind]
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: operand {tuple(t.shape)} {t.dtype} (contiguous="
                             f"{t.is_contiguous()}), expected {shape} {dtype} contiguous")
        if kind != "row" and t.data_ptr() % 16:  # the kernels copy rows 16 bytes at a time
            raise ValueError(f"{name}: operand {tuple(t.shape)} at {t.data_ptr():#x} is not "
                             f"16-byte aligned")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], d, *(t.data_ptr() for t, _ in operands),
                 BH, S, Sk, int(causal), scale, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    t = str(q.dtype).removeprefix("torch.")
    count_launch(LAUNCHES, (name, CHUNKED[t] if d > max(HEAD_DIMS) else t))


def _device_kind(*ts) -> str:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"flash attention: tensors on different devices {[t.device for t in ts]}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention: unsupported device {dev}")
    return dev.type


def built_head_dim(d: int) -> int:
    """The smallest head dim the kernels take not below ``d``: one of
    :data:`HEAD_DIMS`, or above them the next multiple of :data:`WIDE_CHUNK`."""
    return next((h for h in HEAD_DIMS if h >= d), -(-d // WIDE_CHUNK) * WIDE_CHUNK)


def at_built_head_dim(fn, *args):
    """``fn(*args)`` with every [BH, n, d] tensor among ``args`` zero-padded
    along d to :func:`built_head_dim` (d), and every [BH, n, ·] output sliced
    back to d; [BH, n] rows (LSE, δ) and the scalars pass unchanged, so the
    scale stays the caller's 1/√d. Zero columns add nothing to Q·Kᵀ or dO·Vᵀ,
    and O, dQ, dK and dV have zeros there."""
    d = args[0].shape[-1]
    width = built_head_dim(d)
    if width == d:
        return fn(*args)

    def pad(a):
        return F.pad(a, (0, width - d)) if isinstance(a, torch.Tensor) and a.dim() == 3 else a

    def cut(t):
        return t[..., :d].contiguous() if t.dim() == 3 else t

    out = fn(*map(pad, args))
    return cut(out) if isinstance(out, torch.Tensor) else tuple(map(cut, out))


def _forward_kernel(q, k, v, scale: float, causal: bool):
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch(FWD, _lib().fedml_flash_fwd, q,
            [(q, "q"), (k, "k"), (v, "k"), (out, "q"), (lse, "row")], k.shape[1], causal, scale)
    return out, lse


def _dq_kernel(q, k, v, do, lse, delta, scale: float, causal: bool):
    dq = torch.empty_like(q)
    _launch(BWD_DQ, _lib().fedml_flash_bwd_dq, q,
            [(q, "q"), (k, "k"), (v, "k"), (do, "q"), (lse, "row"), (delta, "row"), (dq, "q")],
            k.shape[1], causal, scale)
    return dq


def _dkv_kernel(q, k, v, do, lse, delta, scale: float, causal: bool):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(BWD_DKV, _lib().fedml_flash_bwd_dkv, q,
            [(q, "q"), (k, "k"), (v, "k"), (do, "q"), (lse, "row"), (delta, "row"),
             (dk, "k"), (dv, "k")], k.shape[1], causal, scale)
    return dk, dv


def flash_forward(q, k, v, scale: float, causal: bool, block_q: int, block_k: int):
    """K2: (O, LSE) for contiguous q [BH, S, d], k/v [BH, Sk, d]."""
    if _device_kind(q, k, v) == "cpu":
        return flash_forward_plain(q, k, v, scale, causal, block_q, block_k)
    return at_built_head_dim(_forward_kernel, q, k, v, scale, causal)


def flash_backward_dq(q, k, v, do, lse, delta, scale: float, causal: bool,
                      block_q: int, block_k: int):
    """K3: dQ."""
    if _device_kind(q, k, v, do, lse, delta) == "cpu":
        return flash_backward_dq_plain(q, k, v, do, lse, delta, scale, causal, block_q, block_k)
    return at_built_head_dim(_dq_kernel, q, k, v, do, lse, delta, scale, causal)


def flash_backward_dkv(q, k, v, do, lse, delta, scale: float, causal: bool,
                       block_q: int, block_k: int):
    """K4: (dK, dV)."""
    if _device_kind(q, k, v, do, lse, delta) == "cpu":
        return flash_backward_dkv_plain(q, k, v, do, lse, delta, scale, causal, block_q, block_k)
    return at_built_head_dim(_dkv_kernel, q, k, v, do, lse, delta, scale, causal)


# ---------------------------------------------------------------- autograd


def _fold(info, in_dims, *ts):
    """The client axis that ``torch.func.vmap`` peeled off each operand,
    folded into the kernels' BH axis: [C, BH, ...] → [C·BH, ...],
    contiguous (an operand without the axis is expanded to it)."""
    out = []
    for t, d in zip(ts, in_dims):
        t = t.movedim(d, 0) if d is not None else t.expand((info.batch_size,) + tuple(t.shape))
        out.append(t.reshape((-1,) + tuple(t.shape[2:])).contiguous())
    return out


def _unfold(info, *ts):
    """[C·BH, ...] → [C, BH, ...]: a folded kernel's outputs, batched at 0."""
    C = info.batch_size
    return tuple(t.reshape((C, t.shape[0] // C) + tuple(t.shape[1:])) for t in ts)


class _Flash(torch.autograd.Function):
    """K2 forward, returning (O, LSE); K3 and K4 backward through
    :class:`_FlashDq` and :class:`_FlashDkv`. Saves (q, k, v, O, LSE).

    Under ``torch.func.vmap`` (the batched client schedule) the kernels
    cannot see a batched tensor, so each of the three Functions has a
    ``vmap`` rule that folds the client axis into BH and makes ONE launch
    for the whole cohort; ``vmap(grad(...))`` runs the backward on batched
    tensors, and there the Functions it calls fold the same way."""

    @staticmethod
    def forward(q, k, v, causal: bool, block_q: int, block_k: int):
        scale = 1.0 / math.sqrt(q.shape[-1])
        return flash_forward(q, k, v, scale, causal, block_q, block_k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, block_q, block_k = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, block_q, block_k)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = torch.sum(do.float() * out.float(), dim=-1)
        dq = _FlashDq.apply(q, k, v, do, lse, delta, *ctx.cfg)
        dk, dv = _FlashDkv.apply(q, k, v, do, lse, delta, *ctx.cfg)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, block_q, block_k):
        fq, fk, fv = _fold(info, in_dims[:3], q, k, v)
        _check(fq, fk, fv, causal, block_q, block_k)  # the contract holds folded
        out, lse = _Flash.apply(fq, fk, fv, causal, block_q, block_k)
        return _unfold(info, out, lse), (0, 0)


class _FlashDq(torch.autograd.Function):
    """K3 as a Function, so the backward folds under vmap (no gradient of
    its own: the reference's flash attention is differentiated once)."""

    @staticmethod
    def forward(q, k, v, do, lse, delta, causal, block_q, block_k):
        scale = 1.0 / math.sqrt(q.shape[-1])
        return flash_backward_dq(q, k, v, do, lse, delta, scale, causal, block_q, block_k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, q, k, v, do, lse, delta, causal, block_q, block_k):
        dq = _FlashDq.apply(*_fold(info, in_dims[:6], q, k, v, do, lse, delta),
                            causal, block_q, block_k)
        return _unfold(info, dq)[0], 0


class _FlashDkv(torch.autograd.Function):
    """K4 as a Function (see :class:`_FlashDq`)."""

    @staticmethod
    def forward(q, k, v, do, lse, delta, causal, block_q, block_k):
        scale = 1.0 / math.sqrt(q.shape[-1])
        return flash_backward_dkv(q, k, v, do, lse, delta, scale, causal, block_q, block_k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, q, k, v, do, lse, delta, causal, block_q, block_k):
        dk, dv = _FlashDkv.apply(*_fold(info, in_dims[:6], q, k, v, do, lse, delta),
                                 causal, block_q, block_k)
        return _unfold(info, dk, dv), (0, 0)


def _check(q, k, v, causal: bool, block_q: int, block_k: int) -> Tuple[int, int]:
    """The reference's shape contract; returns the clamped block sizes."""
    S, d = q.shape[-2:]
    Sk = k.shape[-2]
    block_q, block_k = min(block_q, S), min(block_k, Sk)
    if S % block_q or Sk % block_k:
        raise ValueError(
            f"sequence lengths ({S}, {Sk}) must be multiples of the block "
            f"sizes ({block_q}, {block_k})"
        )
    if causal and S != Sk:
        raise ValueError("causal attention requires matching Q/K lengths")
    if q.reshape(-1, S, d).shape[0] != k.reshape(-1, Sk, d).shape[0] or k.shape != v.shape:
        raise ValueError(
            f"q/k/v leading (batch, heads) dims must match: q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)} (broadcast MQA/GQA heads first)"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(
            f"flash attention takes float32 or bfloat16 q/k/v of one type; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    return block_q, block_k


def flash_attention(q, k, v, causal: bool = True, block_q: int = 512, block_k: int = 512):
    """Blockwise attention softmax(Q Kᵀ/√d [, causal]) V on q/k/v [..., S, d]
    with any leading batch/head dims and any head dim (on the card up to
    128, see :func:`at_built_head_dim`). Sequence lengths must be multiples
    of the (clamped) block sizes, as in the reference. Differentiable
    through the flash backward kernels."""
    block_q, block_k = _check(q, k, v, causal, block_q, block_k)
    S, d = q.shape[-2:]
    Sk = k.shape[-2]
    out, _ = _Flash.apply(
        q.reshape(-1, S, d).contiguous(),
        k.reshape(-1, Sk, d).contiguous(),
        v.reshape(-1, Sk, d).contiguous(),
        causal, block_q, block_k,
    )
    return out.reshape(q.shape)


def flash_attention_bthd(q, k, v, causal: bool = True, **kw):
    """[B, T, H, D]-layout adapter: the drop-in flash-backed ``attn_fn`` for
    :class:`fedml_tpu_torch.models.transformer.TransformerLM`."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=causal, **kw)
    return out.transpose(1, 2).to(q.dtype)
