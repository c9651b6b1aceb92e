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

A QUANTIZED cache (``model.kv_cache_quant``) holds 1-byte K/V payloads
(int8, fp8 e4m3 or e5m2: ``ops/quantization.py``) with bf16 scales of
the payload's leading shape (``[B, S, H]``, or ``[N, bs, H]`` for
pools); every router takes them as ``k_scale`` / ``v_scale``, both or
neither.

Two versions of each function:

- the plain PyTorch version (``dense_*``): fp32 scores and softmax,
  masked with ``finfo(float32).min``. Unquantized, the probabilities are
  cast to the cache dtype before the PV product. Quantized
  (``dense_decode_attention_quant``, and the paged ones given scales),
  the reference's quant contract: q and payload upcast to fp32, the K
  scale multiplies the score with ``1/sqrt(D)``, the V scale multiplies
  the fp32 probabilities before PV. The CPU takes it, and the card holds
  the kernel against it (``chip_smoke.py``).
- the hand-written CUDA kernel (``csrc/decode_attention.cu``, a split-KV
  kernel whose split count ``decode_splits`` picks, replaces the
  TPU's ``_decode_kernel``; ``csrc/paged_attention.cu`` replaces
  ``_paged_decode_kernel`` and ``_paged_verify_kernel``;
  ``csrc/quant_attention.cu`` replaces the three ``*_quant`` siblings;
  for bf16 q both paged files launch ``csrc/paged_tc.cuh``'s
  tensor-core kernel, split as ``paged_splits`` picks, and the quantized
  contiguous cache launches the same kernel without the table, split as
  ``decode_splits`` picks), launched on the current stream through
  ``ctypes``.

The routers (``decode_attention``, ``paged_decode_attention``,
``paged_verify_attention``) choose by the tensor's device only: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises. Nothing falls back. Each router counts its kernel launches, in
``.launches`` for the unquantized kernel and ``.quant_launches`` for the
quantized one.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from frl_distributed_ml_scaffold_tpu_torch.ops import _build
from frl_distributed_ml_scaffold_tpu_torch.ops.quantization import byte_view

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Payload formats of the quantized kernels (csrc/quant_attention.cu).
_PAYLOAD_FORMATS = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}
_NEG = torch.finfo(torch.float32).min


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


def dense_decode_attention_quant(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
) -> torch.Tensor:
    """Reference decode attention over a quantized cache: q ``[B, H, D]``
    against 1-byte payloads ``[B, S, H, D]`` with scales ``[B, S, H]``,
    keys at positions ``>= kv_len[b]`` masked out. Scores
    ``(q . k) * k_scale / sqrt(D)`` and the softmax in fp32; the V scale
    multiplies the fp32 probabilities before PV. Masked positions are
    zeroed before use, so garbage there (NaN included) never reaches the
    output."""
    d = q.shape[-1]
    kpos = torch.arange(k.shape[1], device=k.device)
    live = kpos[None, :] < kv_len.to(k.device)[:, None]  # [B, S]
    lv = live[:, :, None]  # [B, S, 1] against [B, S, H]
    ks = torch.where(lv, k_scale.float(), 0.0).transpose(1, 2)  # [B, H, S]
    vs = torch.where(lv, v_scale.float(), 0.0).transpose(1, 2)
    kf = torch.where(lv[..., None], k.float(), 0.0)
    vf = torch.where(lv[..., None], v.float(), 0.0)
    s = torch.einsum("bhd,bshd->bhs", q.float(), kf) * ks * (1.0 / math.sqrt(d))
    s = s.masked_fill(~live[:, None, :], _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p * vs, vf).to(q.dtype)


def _check_dtypes(q, k, v, k_scale, v_scale, what):
    """q in float32 or bfloat16; unquantized, k/v of q's dtype;
    quantized, k/v of one 1-byte payload format with bf16 scales of the
    payload's leading shape, sharing strides."""
    if k_scale is None:
        if q.dtype not in _KERNEL_DTYPES or not q.dtype == k.dtype == v.dtype:
            raise TypeError(
                f"{what} take float32 or bfloat16 q/k/v of one dtype, "
                f"got {q.dtype}/{k.dtype}/{v.dtype}"
            )
        return
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what} take float32 or bfloat16 q, got {q.dtype}")
    if k.dtype not in _PAYLOAD_FORMATS or v.dtype != k.dtype:
        raise TypeError(
            f"quantized {what} take int8, float8_e4m3fn or float8_e5m2 "
            f"k/v of one dtype, got {k.dtype}/{v.dtype}"
        )
    lead = tuple(k.shape[:-1])
    for s in (k_scale, v_scale):
        if s.dtype != torch.bfloat16 or tuple(s.shape) != lead:
            raise ValueError(
                f"scales must be bfloat16 {lead}, got {s.dtype} "
                f"{tuple(s.shape)}"
            )
    if v_scale.stride() != k_scale.stride():
        raise ValueError("k_scale and v_scale must share strides")


def _check_kernel_args(q, k, v, kv_len, k_scale=None, v_scale=None):
    """What the contiguous kernels take; anything else raises before a
    pointer is handed over."""
    b, h, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"cache {tuple(k.shape)} does not match q {tuple(q.shape)} "
            "(want k/v [B, S, H, D])"
        )
    if v.shape != k.shape or v.stride() != k.stride():
        raise ValueError("k and v must share shape and strides")
    _check_dtypes(q, k, v, k_scale, v_scale, "decode kernels")
    if d % 32 or not 32 <= d <= 256:
        raise ValueError(
            f"decode kernel needs head_dim % 32 == 0 and <= 256, got {d}"
        )
    if k_scale is not None and d not in (32, 64, 128, 256):
        raise ValueError(
            f"quantized decode kernel takes head_dim 32, 64, 128 or 256, "
            f"got {d}"
        )
    if q.stride(-1) != 1 or k.stride(-1) != 1:
        raise ValueError("decode kernel needs unit stride along head_dim")
    # The unquantized kernel, and the quantized one for bf16 q
    # (csrc/paged_tc.cuh), copy the cache 16 bytes at a time; the fp32-q
    # quantized kernel reads bytes.
    if k_scale is None or q.dtype == torch.bfloat16:
        elem = k.element_size()
        for t in (k, v):
            if (t.data_ptr() % 16
                    or any(st * elem % 16 for st in t.stride()[:3])):
                raise ValueError(
                    "the decode kernel reads the cache 16 bytes at a time: "
                    "k and v must be 16-byte aligned with b, s and h strides "
                    f"in multiples of 16 bytes, got strides {t.stride()}"
                )
    if k.stride(2) != d:
        raise ValueError(
            "decode kernel needs each position's [H, D] contiguous"
        )
    if (kv_len.shape != (b,) or kv_len.dtype != torch.int32
            or not kv_len.is_contiguous()):
        raise ValueError("kv_len must be a contiguous int32 [B] tensor")
    extra = () if k_scale is None else (k_scale, v_scale)
    for t in (k, v, kv_len, *extra):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")


def _bind(source: str, name: str, n_ptr: int, n_int: int, n_long: int):
    """The C entry ``name`` of ``csrc/<source>.cu``, its argument types
    declared on first use: pointers, ints, int64 strides, the softmax
    scale and the stream."""
    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
            + [ctypes.c_longlong] * n_long + [ctypes.c_float, ctypes.c_void_p]
        )
    return fn


# Most CTAs one (row, head) is split into: the portable cluster size
# (csrc/decode_attention.cu merges the splits through distributed shared
# memory).
MAX_DECODE_SPLITS = 8


def decode_splits(bh: int, s: int, sm_count: int) -> int:
    """CTAs per (row, head) of the contiguous decode kernels (the
    unquantized one, and ``csrc/paged_tc.cuh`` over a quantized cache for
    bf16 q), from what the host knows without a sync, never ``kv_len``:
    about one CTA (16 warps) per SM in all, so
    1 once ``B*H >= sm_count``; at most ``MAX_DECODE_SPLITS``, and no
    more than one per 256 positions of capacity ``s`` (one pass of a
    CTA at head_dim 64 bf16)."""
    return max(1, min(MAX_DECODE_SPLITS, sm_count // bh, -(-s // 256)))


def paged_splits(bh: int, cap: int, sm_count: int) -> int:
    """CTAs per (row, head) of the paged kernels for bf16 q
    (``csrc/paged_tc.cuh``), from what the host knows without a sync: B*H,
    the table's capacity ``cap = M * bs`` positions and the SM count:
    ``decode_splits``'s rule over that capacity (both kernels run 16-warp
    CTAs of 256 positions a pass). Never the occupancy: a split takes a
    fixed share of the table, so the decode at n and the verify at
    n + T - 1 partition positions alike, and verify query 0 equals the
    decode bit for bit."""
    return decode_splits(bh, cap, sm_count)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _use_kernel(q, impl) -> bool:
    """The routers' rule: the kernel for a CUDA tensor under
    ``impl="flash"``, the plain version for ``impl="dense"`` or a CPU
    tensor; everything else raises."""
    if impl not in ("dense", "flash"):
        raise KeyError(
            f"unknown decode_attention impl {impl!r} (dense | flash)"
        )
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"decode attention runs on cpu or cuda, not {q.device}"
        )
    return impl == "flash" and q.device.type == "cuda"


def _flash_decode(q, k, v, kv_len, splits=None):
    """Launch the CUDA kernel; ``kv_len`` is int32 (the kernel clamps each
    row's occupancy to ``[1, S]``). ``splits``: CTAs per (row, head),
    ``decode_splits``'s by default."""
    _check_kernel_args(q, k, v, kv_len)
    fn = _bind("decode_attention", "frl_decode_attention", 5, 6, 7)
    b, h, d = q.shape
    s = k.shape[1]
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if splits is None:
        splits = decode_splits(b * h, s, _sm_count(q.device.index))
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), b, h, s, d, _KERNEL_DTYPES[q.dtype], splits,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        out.stride(0), out.stride(1), 1.0 / math.sqrt(d), stream,
    )
    if err != 0:
        raise _build.KernelError(
            f"decode attention kernel launch failed: CUDA error {err}"
        )
    decode_attention.launches += 1
    return out


def _flash_decode_quant(q, k, v, kv_len, k_scale, v_scale, splits=None):
    """Launch the quantized contiguous kernel; ``kv_len`` is int32 (the
    kernel clamps each row's occupancy to ``[1, S]``). ``splits``: CTAs
    per (row, head) of the bf16-q kernel (``csrc/paged_tc.cuh``),
    ``decode_splits``'s by default, never from ``kv_len`` (fp32 q takes
    one)."""
    _check_kernel_args(q, k, v, kv_len, k_scale, v_scale)
    fn = _bind("quant_attention", "frl_decode_attention_quant", 7, 7, 10)
    b, h, d = q.shape
    s = k.shape[1]
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if splits is None:
        splits = decode_splits(b * h, s, _sm_count(q.device.index))
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        b, h, s, d, _KERNEL_DTYPES[q.dtype], _PAYLOAD_FORMATS[k.dtype],
        splits,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        k_scale.stride(0), k_scale.stride(1), k_scale.stride(2),
        out.stride(0), out.stride(1), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise _build.KernelError(
            f"quantized decode attention kernel launch failed: CUDA error "
            f"{err}"
        )
    decode_attention.quant_launches += 1
    return out


def _quantized(k_scale, v_scale, what: str) -> bool:
    """Both scales or neither (the reference's rule and message)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(
            "k_scale and v_scale must be passed together (a quantized "
            f"{what} quantizes both of its halves)"
        )
    return k_scale is not None


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
    consumer routes through. With ``k_scale`` / ``v_scale`` (``[B, S, H]``
    bf16, both or neither) the cache is quantized. ``impl="dense"`` is the
    explicit config choice ``model.decode_attention=dense``; ``"flash"``
    clamps each row's occupancy to ``[1, S]`` (as the TPU kernel's router
    clamps it to >= 1) and takes the kernel on a CUDA tensor, the plain
    version on a CPU tensor. ``decode_attention.launches`` /
    ``.quant_launches`` count kernel launches."""
    quant = _quantized(k_scale, v_scale, "cache")
    if not _use_kernel(q, impl):
        lens = kv_len
        if impl == "flash":
            lens = kv_len.to(torch.int32).clamp_min(1)
        if quant:
            return dense_decode_attention_quant(q, k, v, lens, k_scale, v_scale)
        return dense_decode_attention(q, k, v, lens)
    # The kernels clamp each row to [1, S] themselves: no launch for the
    # clamp.
    lens = kv_len.to(torch.int32).contiguous()
    if quant:
        return _flash_decode_quant(q, k, v, lens, k_scale, v_scale)
    return _flash_decode(q, k, v, lens)


decode_attention.launches = 0
decode_attention.quant_launches = 0


# ------------------------------------------------------------------- paged

# Query tiles the verify kernels are instantiated for (T = speculate_k + 1).
MAX_VERIFY_TILE = 8
# Shared memory the kernels give a row's table (csrc/paged_attention.cu,
# csrc/quant_attention.cu, csrc/paged_tc.cuh).
_MAX_TABLE_BYTES = 32 * 1024


def _logical_view(pool, block_tables):
    """Row b's logical cache ``[B, M*bs, ...]``: pool blocks gathered
    through the table (the plain versions' straightforward read; the
    kernels never build it). fp8 pools are gathered as bytes."""
    b, m = block_tables.shape
    g = byte_view(pool)[block_tables.long()].view(pool.dtype)
    return g.reshape(b, m * pool.shape[1], *pool.shape[2:])


def _occupancy(kv_len, block_tables, pool):
    """Clamp occupancy to ``[1, M*bs]``: retired rows run past the table,
    and a row always attends at least position 0 (the router's clamp)."""
    cap = block_tables.shape[1] * pool.shape[1]
    return kv_len.to(device=pool.device, dtype=torch.int32).clamp(1, cap)


def _paged_reference(k_pool, v_pool, block_tables, k_scale, v_scale):
    """``attend(q, occupancy)`` over the pools' logical views: the
    unquantized or the quantized plain decode."""
    k = _logical_view(k_pool, block_tables)
    v = _logical_view(v_pool, block_tables)
    if k_scale is None:
        return lambda q, n: dense_decode_attention(q, k, v, n)
    ks = _logical_view(k_scale, block_tables)
    vs = _logical_view(v_scale, block_tables)
    return lambda q, n: dense_decode_attention_quant(q, k, v, n, ks, vs)


def dense_paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    kv_len: torch.Tensor,
    block_tables: torch.Tensor,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Reference decode attention over a paged cache: q ``[B, H, D]``
    against the pool blocks each row's table maps, keys at logical
    positions ``>= kv_len[b]`` masked out (occupancy clamped to
    ``[1, M*bs]``). With ``k_scale`` / ``v_scale`` (``[N, bs, H]`` bf16)
    the pools are quantized. Unreferenced blocks are never read."""
    attend = _paged_reference(k_pool, v_pool, block_tables, k_scale, v_scale)
    return attend(q, _occupancy(kv_len, block_tables, k_pool))


def dense_paged_verify_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    kv_len: torch.Tensor,
    block_tables: torch.Tensor,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Reference verify-tile attention over a paged cache: q
    ``[B, T, H, D]``, whose K/V already sit at logical positions
    ``kv_len - T .. kv_len - 1``. Query t is the single-token decode at
    occupancy ``kv_len - T + 1 + t`` (clamped to ``[1, M*bs]``), so
    query 0 equals ``dense_paged_decode_attention`` bit for bit. Scales
    as there."""
    t = q.shape[1]
    attend = _paged_reference(k_pool, v_pool, block_tables, k_scale, v_scale)
    base = kv_len.to(device=q.device, dtype=torch.int32) - (t - 1)
    return torch.stack(
        [
            attend(
                q[:, j].contiguous(),
                _occupancy(base + j, block_tables, k_pool),
            )
            for j in range(t)
        ],
        dim=1,
    )


def _check_paged_args(q, k_pool, v_pool, kv_len, block_tables, want_q_dim,
                      k_scale=None, v_scale=None):
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
    _check_dtypes(q, k_pool, v_pool, k_scale, v_scale, "paged kernels")
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
    elem = k_pool.element_size()
    for t in (k_pool, v_pool):
        if t.data_ptr() % 16 or any(st * elem % 16 for st in t.stride()[:3]):
            raise ValueError(
                "the paged kernels read the pools 16 bytes at a time: "
                "k_pool and v_pool must be 16-byte aligned with N, bs and H "
                f"strides in multiples of 16 bytes, got strides {t.stride()}"
            )
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
    if not 1 <= q.shape[1] <= MAX_VERIFY_TILE and want_q_dim == 4:
        raise ValueError(
            f"verify tile of {q.shape[1]} queries; the kernel takes "
            f"1..{MAX_VERIFY_TILE}"
        )
    extra = () if k_scale is None else (k_scale, v_scale)
    for t in (k_pool, v_pool, kv_len, block_tables, *extra):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")


def _launch_paged(op, q, k_pool, v_pool, kv_len, block_tables, k_scale,
                  v_scale, splits=None):
    """Launch the paged ``op`` ("decode" on q ``[B, H, D]``, "verify" on
    ``[B, T, H, D]``) kernel, the quantized one when scales are given;
    ``kv_len`` int32 (the kernels clamp each row's occupancy to
    ``[1, M*bs]``). ``splits``: CTAs per (row, head) of the bf16-q
    kernel, ``paged_splits``'s by default (fp32 q takes one)."""
    _check_paged_args(q, k_pool, v_pool, kv_len, block_tables,
                      3 if op == "decode" else 4, k_scale, v_scale)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    q4, out4 = (q, out) if q.dim() == 4 else (q[:, None], out[:, None])
    b, t, h, d = q4.shape
    n, bs = k_pool.shape[:2]
    m = block_tables.shape[1]
    if splits is None:
        splits = paged_splits(b * h, m * bs, _sm_count(q.device.index))
    name = f"frl_paged_{op}_attention"
    ptrs = [q4.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr()]
    ints = [b, t, h, d, n, bs, m, _KERNEL_DTYPES[q.dtype]]
    strides = [q4.stride(0), q4.stride(1), q4.stride(2),
               k_pool.stride(0), k_pool.stride(1), k_pool.stride(2)]
    if k_scale is None:
        fn = _bind("paged_attention", name, 6, 9, 9)
    else:
        name += "_quant"
        fn = _bind("quant_attention", name, 8, 10, 12)
        ptrs += [k_scale.data_ptr(), v_scale.data_ptr()]
        ints.append(_PAYLOAD_FORMATS[k_pool.dtype])
        strides += [k_scale.stride(0), k_scale.stride(1), k_scale.stride(2)]
    ints.append(splits)
    ptrs += [kv_len.data_ptr(), block_tables.data_ptr(), out4.data_ptr()]
    strides += [out4.stride(0), out4.stride(1), out4.stride(2)]
    err = fn(*ptrs, *ints, *strides, 1.0 / math.sqrt(d),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise _build.KernelError(
            f"{name} kernel launch failed: CUDA error {err}")
    return out


def _count(router, k_scale) -> None:
    if k_scale is None:
        router.launches += 1
    else:
        router.quant_launches += 1


def _flash_paged_decode(q, k_pool, v_pool, kv_len, block_tables,
                        k_scale=None, v_scale=None, splits=None):
    """Launch the paged decode kernel (quantized with scales)."""
    out = _launch_paged("decode", q, k_pool, v_pool, kv_len, block_tables,
                        k_scale, v_scale, splits)
    _count(paged_decode_attention, k_scale)
    return out


def _flash_paged_verify(q, k_pool, v_pool, kv_len, block_tables,
                        k_scale=None, v_scale=None, splits=None):
    """Launch the paged verify kernel (quantized with scales) on a
    ``[B, T, H, D]`` tile."""
    out = _launch_paged("verify", q, k_pool, v_pool, kv_len, block_tables,
                        k_scale, v_scale, splits)
    _count(paged_verify_attention, k_scale)
    return out




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
    the paged model branch routes through. With ``k_scale`` / ``v_scale``
    (``[N, bs, H]`` bf16, both or neither) the pools are quantized.
    ``impl="dense"`` is the explicit plain version; ``"flash"`` takes
    the kernel on a CUDA tensor, the plain version on a CPU tensor (both
    clamp each row's occupancy to ``[1, M*bs]``).
    ``paged_decode_attention.launches`` /
    ``.quant_launches`` count kernel launches."""
    _quantized(k_scale, v_scale, "pool")
    if not _use_kernel(q, impl):
        return dense_paged_decode_attention(
            q, k_pool, v_pool, kv_len, block_tables, k_scale, v_scale
        )
    # The kernels clamp each row to [1, M*bs] themselves: no launch for
    # the clamp.
    lens = kv_len.to(torch.int32).contiguous()
    return _flash_paged_decode(q, k_pool, v_pool, lens, block_tables,
                              k_scale, v_scale)


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
    ``paged_verify_attention.launches`` / ``.quant_launches`` count kernel
    launches."""
    _quantized(k_scale, v_scale, "pool")
    if not _use_kernel(q, impl):
        return dense_paged_verify_attention(
            q, k_pool, v_pool, kv_len, block_tables, k_scale, v_scale
        )
    return _flash_paged_verify(q, k_pool, v_pool,
                              kv_len.to(torch.int32).contiguous(),
                              block_tables, k_scale, v_scale)


paged_decode_attention.launches = 0
paged_decode_attention.quant_launches = 0
paged_verify_attention.launches = 0
paged_verify_attention.quant_launches = 0
