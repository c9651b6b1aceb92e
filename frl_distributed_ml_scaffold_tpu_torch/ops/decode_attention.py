"""Single-token decode attention over a contiguous KV cache.

The port of ``frl_distributed_ml_scaffold_tpu/ops/decode_attention.py``
for the serving slice. Layout is the cache's, as in the JAX package:
q ``[B, H, D]``, k/v ``[B, S, H, D]``, ``kv_len [B]`` int32 occupancy per
row (``kv_len > S`` reads the whole cache: retired serving rows keep
decoding past their bucket).

Two versions of one function:

- ``dense_decode_attention``, the plain PyTorch version: fp32 scores and
  softmax, masked with ``finfo(float32).min``, the probabilities cast to
  the cache dtype before the PV product. The CPU takes it, and the card
  holds the kernel against it (``chip_smoke.py``).
- ``_flash_decode``, the hand-written CUDA kernel
  (``csrc/decode_attention.cu``, which replaces the TPU's
  ``_decode_kernel``), launched on the current stream through ``ctypes``.

``decode_attention`` routes between them by the tensor's device only: a
CPU tensor takes the plain version, a CUDA tensor launches the kernel or
raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import math

import torch

from frl_distributed_ml_scaffold_tpu_torch.ops import _build

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dense_decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: torch.Tensor
) -> torch.Tensor:
    """Reference decode attention: q ``[B, H, D]`` against the cache
    ``[B, S, H, D]``, keys at positions ``>= kv_len[b]`` masked out."""
    d = q.shape[-1]
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) / math.sqrt(d)
    kpos = torch.arange(k.shape[1], device=k.device)
    mask = kpos[None, :] < kv_len.to(k.device)[:, None]  # [B, S]
    s = s.masked_fill(~mask[:, None, :], torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhs,bshd->bhd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _check_kernel_args(q, k, v, kv_len):
    b, h, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"cache {tuple(k.shape)} does not match q {tuple(q.shape)} "
            "(want k/v [B, S, H, D])"
        )
    if v.shape != k.shape or v.stride() != k.stride():
        raise ValueError("k and v must share shape and strides")
    if q.dtype not in _KERNEL_DTYPES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(
            f"decode kernel takes float32 or bfloat16 q/k/v of one dtype, "
            f"got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if d % 32 or not 32 <= d <= 256:
        raise ValueError(
            f"decode kernel needs head_dim % 32 == 0 and <= 256, got {d}"
        )
    if q.stride(-1) != 1 or k.stride(-1) != 1:
        raise ValueError("decode kernel needs unit stride along head_dim")
    if k.stride(2) != d:
        raise ValueError(
            "decode kernel needs each position's [H, D] contiguous"
        )
    if (kv_len.shape != (b,) or kv_len.dtype != torch.int32
            or not kv_len.is_contiguous()):
        raise ValueError("kv_len must be a contiguous int32 [B] tensor")
    for t in (k, v, kv_len):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")


def _kernel():
    fn = _build.load("decode_attention").frl_decode_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 7 + [ctypes.c_float, ctypes.c_void_p]
        )
    return fn


def _flash_decode(q, k, v, kv_len):
    """Launch the CUDA kernel; ``kv_len`` is int32 and already >= 1."""
    _check_kernel_args(q, k, v, kv_len)
    fn = _kernel()
    b, h, d = q.shape
    s = k.shape[1]
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), b, h, s, d, _KERNEL_DTYPES[q.dtype],
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        out.stride(0), out.stride(1), 1.0 / math.sqrt(d), stream,
    )
    if err != 0:
        raise RuntimeError(
            f"decode attention kernel launch failed: CUDA error {err}"
        )
    decode_attention.launches += 1
    return out


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: torch.Tensor,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    impl: str = "flash",
) -> torch.Tensor:
    """Single-token decode attention, the one entry point every decode
    consumer routes through. ``impl="dense"`` is the explicit config
    choice ``model.decode_attention=dense``; ``"flash"`` clamps ``kv_len``
    to >= 1 (as the TPU kernel's router does) and takes the kernel on a
    CUDA tensor, the plain version on a CPU tensor.
    ``decode_attention.launches`` counts kernel launches."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "quantized KV cache (kv_cache_quant != 'none') is not ported "
            "yet: ROADMAP queue B item 7 (_decode_kernel_quant)"
        )
    if impl == "dense":
        return dense_decode_attention(q, k, v, kv_len)
    if impl != "flash":
        raise KeyError(
            f"unknown decode_attention impl {impl!r} (dense | flash)"
        )
    lens = kv_len.to(torch.int32).clamp_min(1)
    if q.device.type == "cpu":
        return dense_decode_attention(q, k, v, lens)
    if q.device.type != "cuda":
        raise ValueError(
            f"decode attention runs on cpu or cuda, not {q.device}"
        )
    return _flash_decode(q, k, v, lens.contiguous())


decode_attention.launches = 0
