"""Flash attention for training: the port of the JAX package's
``ops/flash_attention.py`` (forward, and the dQ and dK/dV backward).

Layouts are the JAX package's: the block-level routers
(``block_attention_fwd`` / ``block_attention_bwd``) take the kernel
layout (B, H, T, D) and an lse of (B, H, T, 1) fp32; ``flash_attention``
takes the public (B, T, H, D) and is differentiable. The kernels read
either layout in place through strides, so neither side transposes.

Two versions of each function:

- the plain PyTorch version (``dense_fwd_lse`` / ``dense_bwd_lse``, the
  counterparts of ``_dense_fwd_lse`` / ``_dense_bwd_lse``), which keeps
  the kernels' numerics rules: products of input-dtype values with an
  fp32 accumulator, masked scores -1e30, the softmax in fp32 with the
  denominator floored at 1e-30 and ``lse = m + log(l)``, P cast to V's
  dtype before PV; in the backward ``delta = rowsum(dO * O)`` and
  ``dP = dO V^T`` in fp32, ``p = exp(s - lse)``, dS cast to K's dtype
  before ``dS K`` for dQ, ``dV = P^T dO`` and ``dK = dS^T Q`` in fp32, each
  output cast back to its input's dtype. The CPU takes it, and the card
  holds the kernels against it (``chip_smoke.py``).
- the hand-written CUDA kernels of ``csrc/flash_attention.cu`` (replacing
  the TPU's ``_fwd_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``),
  launched on the current stream through ``ctypes`` by ``flash_fwd``,
  ``flash_bwd_dq`` and ``flash_bwd_dkv``, each of which counts its
  launches in ``.launches``. The bf16 forward and dK/dV run on the tensor
  cores (``mma.sync``) and read 16 bytes at a time, so bf16 inputs must be
  16-byte aligned with b, h and t strides that are multiples of 8
  elements (as every (B, T, H, D) view of a projection is); anything else
  raises.

Routing is by the tensor's device only: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises; nothing falls back
when a build or a launch fails. The one exception is the reference's own
shape rule: a T with no power-of-two block >= 8 dividing it, or a head
dim that is not a multiple of 32, takes the dense path on every device
(``dense_attention``, or the plain lse versions for the block routers),
as the JAX package does. Each such call adds one to
``flash_attention.fallbacks`` and each distinct reason is logged once. A
shape that tiles never goes dense: a tileable head dim the kernels do
not take (96, say) raises on the card.

The JAX package's block sizes (``_auto_block``, 512 and 1024) are a TPU
measurement and do not carry over: the kernels tile by 64 rows.
"""

from __future__ import annotations

import ctypes
import logging
import math

import torch

from frl_distributed_ml_scaffold_tpu_torch.ops import _build
from frl_distributed_ml_scaffold_tpu_torch.ops.ring_attention import (
    dense_attention,
)

_NEG_INF = -1.0e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
# Slots of the kernels' stride table (csrc/flash_attention.cu).
_SLOTS = ("q", "k", "v", "o", "do", "dq", "dk", "dv")

_log = logging.getLogger(__name__)
_warned: set[str] = set()


# ------------------------------------------------------------------- plain


def _scores(q, k, causal):
    """fp32 ``Q K^T / sqrt(D)`` of (B, H, T, D) inputs, masked with -1e30
    above the diagonal when ``causal``."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        qpos = torch.arange(tq, device=s.device)[:, None]
        kpos = torch.arange(tk, device=s.device)[None, :]
        s = torch.where(qpos >= kpos, s, _NEG_INF)
    return s


def dense_fwd_lse(q, k, v, *, causal):
    """(B, H, Tq, D) x (B, H, Tk, D) -> (o, lse[B, H, Tq, 1]): the plain
    forward, with the kernel's numerics."""
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (acc / l).to(q.dtype), m + torch.log(l)


def dense_bwd_lse(q, k, v, o, lse, do, *, causal):
    """The plain backward from the row's global lse -> (dq, dk, dv)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal) - lse)  # masked: exp(-1e30 - lse) = 0
    do32 = do.float()
    delta = (do32 * o.float()).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v.float())
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ kernels


def _check_kernel_args(seq_dim: int, *tensors):
    """What the kernels take; anything else raises before a pointer is
    handed over. ``seq_dim`` is T's axis: 2 for (B, H, T, D), 1 for
    (B, T, H, D)."""
    q = tensors[0]
    if q.dim() != 4:
        raise ValueError(f"flash kernels take 4-d tensors, got {tuple(q.shape)}")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(
            f"flash kernels take float32 or bfloat16, got {q.dtype}"
        )
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim {HEAD_DIMS}, got {d}")
    if q.shape[3 - seq_dim] > 65535 or q.shape[0] > 65535:
        raise ValueError(f"flash kernels take B, H <= 65535, got {tuple(q.shape)}")
    for t in tensors:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(
                f"flash kernels need q, k, v (o, dO) of one shape and dtype: "
                f"{tuple(t.shape)} {t.dtype} vs {tuple(q.shape)} {q.dtype}"
            )
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if t.stride(-1) != 1:
            raise ValueError("flash kernels need unit stride along head_dim")
        if t.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
            raise ValueError(
                "the bf16 flash kernels read 16 bytes at a time: they need "
                "16-byte aligned tensors whose b, h and t strides are "
                f"multiples of 8 elements, got strides {t.stride()}")


def _stride_table(seq_dim: int, **tensors) -> ctypes.Array:
    """The kernels' stride table: each named tensor's element strides
    along b, h and t; unused slots 0."""
    table = (ctypes.c_longlong * (3 * len(_SLOTS)))()
    h_dim = 3 - seq_dim
    for name, t in tensors.items():
        i = _SLOTS.index(name)
        table[3 * i: 3 * i + 3] = [t.stride(0), t.stride(h_dim),
                                   t.stride(seq_dim)]
    return table


def _bind(name: str, n_ptr: int):
    """The C entry ``name`` of ``csrc/flash_attention.cu``: pointers, the
    ints B, H, T, D, dtype and causal, the stride table, the softmax
    scale and the stream."""
    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
        )
    return fn


def _dims(q, seq_dim, causal):
    """The ints every entry takes after its pointers."""
    b, t, d = q.shape[0], q.shape[seq_dim], q.shape[-1]
    return (b, q.shape[3 - seq_dim], t, d, _KERNEL_DTYPES[q.dtype],
            int(bool(causal)))


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"flash attention {what} kernel launch failed: "
                           f"CUDA error {err}")


def _lse_arg(lse, q, seq_dim):
    b, t = q.shape[0], q.shape[seq_dim]
    want = (b, q.shape[3 - seq_dim], t, 1)
    if tuple(lse.shape) != want or lse.dtype != torch.float32:
        raise ValueError(
            f"lse must be float32 {want}, got {lse.dtype} {tuple(lse.shape)}"
        )
    if lse.device != q.device:
        raise ValueError(f"tensors on {lse.device} and {q.device}")
    return lse.contiguous()


def flash_fwd(q, k, v, *, causal: bool, seq_dim: int = 2):
    """Launch the forward kernel on CUDA tensors -> (o, lse[B, H, T, 1]).
    ``o`` has q's shape (contiguous), ``seq_dim`` is T's axis."""
    _check_kernel_args(seq_dim, q, k, v)
    fn = _bind("frl_flash_fwd", 5)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dims = _dims(q, seq_dim, causal)
    lse = torch.empty((*dims[:3], 1), dtype=torch.float32, device=q.device)
    strides = _stride_table(seq_dim, q=q, k=k, v=v, o=o)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), *dims, strides,
             1.0 / math.sqrt(q.shape[-1]),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "forward")
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, o, lse, do, *, causal: bool, seq_dim: int = 2):
    """Launch the dQ kernel on CUDA tensors -> dq (q's shape)."""
    _check_kernel_args(seq_dim, q, k, v, o, do)
    lse = _lse_arg(lse, q, seq_dim)
    fn = _bind("frl_flash_bwd_dq", 7)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = _stride_table(seq_dim, q=q, k=k, v=v, o=o, do=do, dq=dq)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
             *_dims(q, seq_dim, causal), strides,
             1.0 / math.sqrt(q.shape[-1]),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "dQ")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, o, lse, do, *, causal: bool, seq_dim: int = 2):
    """Launch the dK/dV kernel on CUDA tensors -> (dk, dv). The bf16
    kernel first writes ``rowsum(dO * O)`` into a [B, H, T] fp32 scratch
    (one launch of the entry, counted once)."""
    _check_kernel_args(seq_dim, q, k, v, o, do)
    lse = _lse_arg(lse, q, seq_dim)
    fn = _bind("frl_flash_bwd_dkv", 9)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    dims = _dims(q, seq_dim, causal)
    delta = torch.empty(dims[:3], dtype=torch.float32, device=q.device)
    strides = _stride_table(seq_dim, q=q, k=k, v=v, o=o, do=do, dk=dk, dv=dv)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), *dims, strides,
             1.0 / math.sqrt(q.shape[-1]),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "dK/dV")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


# ------------------------------------------------------------------ routers


def fallback_reason(t: int, d: int) -> str | None:
    """Why the reference takes the dense path at sequence length ``t`` and
    head dim ``d`` (no power-of-two block >= 8 divides t, or d % 32 != 0),
    or None when the shape tiles."""
    if t % 8 or d % 32:
        return (
            f"flash_attention falling back to dense: shape (T={t}, head_dim="
            f"{d}) is not tileable (need a power-of-two divisor of T and "
            "head_dim % 32 == 0)"
        )
    return None


def _fall_back(reason: str) -> None:
    flash_attention.fallbacks += 1
    if reason not in _warned:
        _warned.add(reason)
        _log.warning(reason)


def _device_route(q) -> bool:
    """True to launch the kernels (CUDA), False for the plain version
    (CPU); any other device raises."""
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")


def _block_reason(q, k) -> str | None:
    if q.shape[2] != k.shape[2]:
        return (f"block attention falling back to dense: Tq={q.shape[2]} != "
                f"Tk={k.shape[2]}")
    return fallback_reason(q.shape[2], q.shape[3])


def block_attention_fwd(q, k, v, *, causal: bool):
    """One-block attention in kernel layout (B, H, T, D) -> (o, lse)."""
    reason = _block_reason(q, k)
    if reason is not None:
        _fall_back(reason)
        return dense_fwd_lse(q, k, v, causal=causal)
    if _device_route(q):
        return flash_fwd(q, k, v, causal=causal)
    return dense_fwd_lse(q, k, v, causal=causal)


def block_attention_bwd(q, k, v, o, lse, do, *, causal: bool):
    """Gradients from the row's global lse -> (dq, dk, dv): the dQ kernel,
    then the dK/dV kernel."""
    reason = _block_reason(q, k)
    if reason is not None:
        _fall_back(reason)
        return dense_bwd_lse(q, k, v, o, lse, do, causal=causal)
    if _device_route(q):
        dq = flash_bwd_dq(q, k, v, o, lse, do, causal=causal)
        return (dq, *flash_bwd_dkv(q, k, v, o, lse, do, causal=causal))
    return dense_bwd_lse(q, k, v, o, lse, do, causal=causal)


def _bhtd(x):
    return x.transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    """(B, T, H, D) attention whose forward saves ``(q, k, v, o, lse)``
    and whose backward runs dQ, then dK/dV (the JAX ``_flash`` custom
    VJP). Outputs are allocated here with ``torch.empty`` and written by
    the kernels, so a checkpointed region that reruns this forward gets
    fresh outputs from a fresh launch."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if _device_route(q):
            o, lse = flash_fwd(q, k, v, causal=causal, seq_dim=1)
        else:
            o, lse = dense_fwd_lse(_bhtd(q), _bhtd(k), _bhtd(v),
                                   causal=causal)
            o = _bhtd(o)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal = ctx.causal
        if _device_route(q):
            do = do if do.stride(-1) == 1 else do.contiguous()
            dq = flash_bwd_dq(q, k, v, o, lse, do, causal=causal, seq_dim=1)
            dk, dv = flash_bwd_dkv(q, k, v, o, lse, do, causal=causal,
                                   seq_dim=1)
            return dq, dk, dv, None
        grads = dense_bwd_lse(*map(_bhtd, (q, k, v, o)), lse, _bhtd(do),
                              causal=causal)
        return (*map(_bhtd, grads), None)


def flash_attention(q, k, v, *, causal: bool = True):
    """(B, T, H, D) fused attention, differentiable; a drop-in for
    ``dense_attention``. Shapes that do not tile take ``dense_attention``
    (counted in ``flash_attention.fallbacks``)."""
    reason = fallback_reason(q.shape[1], q.shape[3])
    if reason is not None:
        _fall_back(reason)
        return dense_attention(q, k, v, causal=causal)
    return _FlashAttention.apply(q, k, v, causal)


flash_attention.fallbacks = 0
