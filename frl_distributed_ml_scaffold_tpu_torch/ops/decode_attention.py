"""Decode attention over a contiguous or a paged KV cache.

The port of ``frl_distributed_ml_scaffold_tpu/ops/decode_attention.py``
for the serving path. Layouts are the JAX package's:

- contiguous: q ``[B, H, D]``, k/v ``[B, S, H, D]``, ``kv_len [B]`` int32
  occupancy per row (``kv_len > S`` reads the whole cache: retired
  serving rows keep decoding past their bucket);
- paged: pools ``[N, bs, H, D]`` shared by every row, ``block_tables
  [B, M]`` int32 mapping row b's logical block j to pool block
  ``block_tables[b, j]``; occupancy is clamped at ``M * bs`` (retired
  rows run past it). Single-token decode takes q ``[B, H, D]``; the
  speculative verify tile takes q ``[B, T, H, D]``, where query t sees
  logical positions ``< kv_len - T + 1 + t``, so query 0 is the
  single-token step.

Two versions of each function:

- the plain PyTorch version (``dense_*``): fp32 scores and softmax,
  masked with ``finfo(float32).min``, the probabilities cast to the cache
  dtype before the PV product. The CPU takes it, and the card holds the
  kernel against it (``chip_smoke.py``).
- the hand-written CUDA kernel (``csrc/decode_attention.cu`` replaces the
  TPU's ``_decode_kernel``; ``csrc/paged_attention.cu`` replaces
  ``_paged_decode_kernel`` and ``_paged_verify_kernel``), launched on the
  current stream through ``ctypes``.

The routers (``decode_attention``, ``paged_decode_attention``,
``paged_verify_attention``) choose by the tensor's device only: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises. Nothing falls back. Each router counts its kernel launches in its
``.launches`` attribute.
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


# ------------------------------------------------------------------- paged

# Query tiles the verify kernel is instantiated for (T = speculate_k + 1).
MAX_VERIFY_TILE = 8
# Shared memory the kernels give a row's table (csrc/paged_attention.cu).
_MAX_TABLE_BYTES = 32 * 1024


def _logical_view(pool, block_tables):
    """Row b's logical cache ``[B, M*bs, H, D]``: pool blocks gathered
    through the table (the plain versions' straightforward read; the
    kernels never build it)."""
    b, m = block_tables.shape
    g = pool[block_tables.long()]  # [B, M, bs, H, D]
    return g.reshape(b, m * pool.shape[1], *pool.shape[2:])


def _occupancy(kv_len, block_tables, pool):
    """Clamp occupancy to ``[1, M*bs]``: retired rows run past the table,
    and a row always attends at least position 0 (the router's clamp)."""
    cap = block_tables.shape[1] * pool.shape[1]
    return kv_len.to(device=pool.device, dtype=torch.int32).clamp(1, cap)


def dense_paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    kv_len: torch.Tensor,
    block_tables: torch.Tensor,
) -> torch.Tensor:
    """Reference decode attention over a paged cache: q ``[B, H, D]``
    against the pool blocks each row's table maps, keys at logical
    positions ``>= kv_len[b]`` masked out (occupancy clamped to
    ``[1, M*bs]``). Unreferenced blocks are never read."""
    k = _logical_view(k_pool, block_tables)
    v = _logical_view(v_pool, block_tables)
    return dense_decode_attention(
        q, k, v, _occupancy(kv_len, block_tables, k_pool)
    )


def dense_paged_verify_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    kv_len: torch.Tensor,
    block_tables: torch.Tensor,
) -> torch.Tensor:
    """Reference verify-tile attention over a paged cache: q
    ``[B, T, H, D]``, whose K/V already sit at logical positions
    ``kv_len - T .. kv_len - 1``. Query t is the single-token decode at
    occupancy ``kv_len - T + 1 + t`` (clamped to ``[1, M*bs]``), so
    query 0 equals ``dense_paged_decode_attention`` bit for bit."""
    t = q.shape[1]
    k = _logical_view(k_pool, block_tables)
    v = _logical_view(v_pool, block_tables)
    base = kv_len.to(device=q.device, dtype=torch.int32) - (t - 1)
    return torch.stack(
        [
            dense_decode_attention(
                q[:, j].contiguous(), k, v,
                _occupancy(base + j, block_tables, k_pool),
            )
            for j in range(t)
        ],
        dim=1,
    )


def _check_paged_args(q, k_pool, v_pool, kv_len, block_tables, want_q_dim):
    """What the paged kernels take; anything else raises before a
    pointer is handed over."""
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    if q.dim() != want_q_dim:
        raise ValueError(f"q {tuple(q.shape)} must have {want_q_dim} dims")
    if k_pool.dim() != 4 or k_pool.shape[2:] != (h, d):
        raise ValueError(
            f"pool {tuple(k_pool.shape)} does not match q {tuple(q.shape)} "
            "(want pools [N, bs, H, D])"
        )
    if v_pool.shape != k_pool.shape or v_pool.stride() != k_pool.stride():
        raise ValueError("k_pool and v_pool must share shape and strides")
    if q.dtype not in _KERNEL_DTYPES or not q.dtype == k_pool.dtype == v_pool.dtype:
        raise TypeError(
            "paged kernels take float32 or bfloat16 q/pools of one dtype, "
            f"got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}"
        )
    if d not in (32, 64, 128, 256):
        raise ValueError(
            f"paged kernels take head_dim 32, 64, 128 or 256, got {d}"
        )
    bs = k_pool.shape[1]
    if bs < 1 or bs & (bs - 1):
        raise ValueError(
            f"paged kernels need a power-of-two block size, got {bs}"
        )
    if q.stride(-1) != 1 or k_pool.stride(-1) != 1:
        raise ValueError("paged kernels need unit stride along head_dim")
    if (block_tables.dim() != 2 or block_tables.shape[0] != b
            or block_tables.dtype != torch.int32
            or not block_tables.is_contiguous()):
        raise ValueError("block_tables must be a contiguous int32 [B, M] tensor")
    if block_tables.shape[1] * 4 > _MAX_TABLE_BYTES:
        raise ValueError(
            f"block table of {block_tables.shape[1]} columns does not fit "
            "the kernel's shared memory"
        )
    if (kv_len.shape != (b,) or kv_len.dtype != torch.int32
            or not kv_len.is_contiguous()):
        raise ValueError("kv_len must be a contiguous int32 [B] tensor")
    for t in (k_pool, v_pool, kv_len, block_tables):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")


def _paged_kernel(name: str):
    fn = getattr(_build.load("paged_attention"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
            + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p]
        )
    return fn


def _launch_paged(name, q4, k_pool, v_pool, kv_len, block_tables, out4):
    """q4/out4 ``[B, T, H, D]`` views (T = 1 for decode)."""
    b, t, h, d = q4.shape
    n, bs = k_pool.shape[:2]
    err = _paged_kernel(name)(
        q4.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        kv_len.data_ptr(), block_tables.data_ptr(), out4.data_ptr(),
        b, t, h, d, n, bs, block_tables.shape[1], _KERNEL_DTYPES[q4.dtype],
        q4.stride(0), q4.stride(1), q4.stride(2),
        k_pool.stride(0), k_pool.stride(1), k_pool.stride(2),
        out4.stride(0), out4.stride(1), out4.stride(2),
        1.0 / math.sqrt(d), torch.cuda.current_stream(q4.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _flash_paged_decode(q, k_pool, v_pool, kv_len, block_tables):
    """Launch the paged decode kernel; ``kv_len`` int32, already >= 1."""
    _check_paged_args(q, k_pool, v_pool, kv_len, block_tables, 3)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch_paged(
        "frl_paged_decode_attention", q[:, None], k_pool, v_pool, kv_len,
        block_tables, out[:, None],
    )
    paged_decode_attention.launches += 1
    return out


def _flash_paged_verify(q, k_pool, v_pool, kv_len, block_tables):
    """Launch the paged verify kernel on a ``[B, T, H, D]`` tile."""
    _check_paged_args(q, k_pool, v_pool, kv_len, block_tables, 4)
    if not 1 <= q.shape[1] <= MAX_VERIFY_TILE:
        raise ValueError(
            f"verify tile of {q.shape[1]} queries; the kernel takes "
            f"1..{MAX_VERIFY_TILE}"
        )
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch_paged(
        "frl_paged_verify_attention", q, k_pool, v_pool, kv_len,
        block_tables, out,
    )
    paged_verify_attention.launches += 1
    return out


def _use_paged_kernel(q, impl, k_scale, v_scale, item) -> bool:
    """The paged routers' rule: the kernel for a CUDA tensor under
    ``impl="flash"``, the plain version for ``impl="dense"`` or a CPU
    tensor; everything else raises."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "quantized paged pools (kv_cache_quant != 'none') are not "
            f"ported yet: ROADMAP queue B item {item}"
        )
    if impl not in ("dense", "flash"):
        raise KeyError(
            f"unknown decode_attention impl {impl!r} (dense | flash)"
        )
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"paged attention runs on cpu or cuda, not {q.device}")
    return impl == "flash" and q.device.type == "cuda"


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    kv_len: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    impl: str = "flash",
) -> torch.Tensor:
    """Single-token decode attention over a paged cache, the entry point
    the paged model branch routes through. ``impl="dense"`` is the
    explicit plain version; ``"flash"`` clamps ``kv_len`` to >= 1 and
    takes the kernel on a CUDA tensor, the plain version on a CPU tensor.
    ``paged_decode_attention.launches`` counts kernel launches."""
    if not _use_paged_kernel(q, impl, k_scale, v_scale, 8):
        return dense_paged_decode_attention(
            q, k_pool, v_pool, kv_len, block_tables
        )
    lens = kv_len.to(torch.int32).clamp_min(1).contiguous()
    return _flash_paged_decode(q, k_pool, v_pool, lens, block_tables)


def paged_verify_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    kv_len: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    impl: str = "flash",
) -> torch.Tensor:
    """Speculative verify-tile attention over a paged cache: q
    ``[B, T, H, D]``, ``kv_len`` each row's total occupancy including the
    tile. Routed like ``paged_decode_attention``;
    ``paged_verify_attention.launches`` counts kernel launches."""
    if not _use_paged_kernel(q, impl, k_scale, v_scale, 9):
        return dense_paged_verify_attention(
            q, k_pool, v_pool, kv_len, block_tables
        )
    lens = kv_len.to(torch.int32).clamp_min(1).contiguous()
    return _flash_paged_verify(q, k_pool, v_pool, lens, block_tables)


paged_decode_attention.launches = 0
paged_verify_attention.launches = 0
