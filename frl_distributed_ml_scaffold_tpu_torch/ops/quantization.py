"""Scaled low-precision (int8 / fp8) quantization: the KV cache's, and
the scaled matmuls of the collective-matmul rings and training.

The port's own copy of the JAX package's ``ops/quantization.py``
(``LOWP_FORMATS``, ``lowp_dtype``, ``resolve_lowp``, ``qmax``,
``quantize``, ``dequantize``, ``qdot``, ``quantized_matmul``), so a
format name means the same thing to both packages and a quantized cache
or ring payload holds the same bytes in both. ``quantize`` follows the
reference step for step: ``scale = max|x| / qmax`` in fp32 over every
axis but the kept channel axes (all of them with ``channel_axes=None``,
per-tensor; 1 where the slice is all zero), ``y = x / scale`` in fp32,
then int8 rounds half to even and clips, fp8 clips and casts.

``qdot`` contracts ``[..., K] x [K, M]`` quantized operands and scales
the raw fp32 product by ``s_lhs * s_rhs`` in fp32, as the reference
does. On the CPU (the plain version) int8 contracts exactly in float64
and fp8 upcasts to fp32. On a card each format takes one route
(``QDOT_ROUTES``): int8 ``torch._int_mm`` (int32 accumulation, exact),
fp8_e4m3 ``torch._scaled_mm`` at unit scales with an fp32 output, and
fp8_e5m2 (cuBLASLt has no e5m2 x e5m2 product) an upcast to bf16, which
holds every e5m2 value exactly, contracted with fp32 accumulation into
an fp32 output. The operands are padded to the shapes the routes need
(zeros along K add nothing; padded rows and columns are cut off), and a
route that fails raises: nothing falls back to the plain version on a
card. ``qdot_calls`` counts the calls by route.

``quantized_matmul`` is the straight-through matmul: the forward
quantizes ``x`` per-tensor and ``w`` per output channel and runs
``qdot``; the backward is the plain matmul's against the full-precision
``x`` and ``w``.

``byte_view`` gives the uint8 view of a 1-byte float tensor, and
``zeros`` makes one from zero bytes: the cache allocations, writes,
gathers and pads go through them, so no op needs fp8 support of its
own.
"""

from __future__ import annotations

import torch

#: format name -> (storage dtype, largest representable magnitude).
LOWP_FORMATS: dict[str, tuple[torch.dtype, float]] = {
    "int8": (torch.int8, 127.0),
    "fp8_e4m3": (torch.float8_e4m3fn, 448.0),
    "fp8_e5m2": (torch.float8_e5m2, 57344.0),
}

_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def lowp_dtype(fmt: str) -> torch.dtype:
    """Storage dtype of a low-precision format name (KeyError on typos,
    listing the vocabulary)."""
    if fmt not in LOWP_FORMATS:
        raise KeyError(
            f"unknown low-precision format {fmt!r} "
            f"(known: {sorted(LOWP_FORMATS)})"
        )
    return LOWP_FORMATS[fmt][0]


def resolve_lowp(value) -> str | None:
    """Any knob spelling of "which low-precision format" as a format name
    or None: ``None`` / "none" / "off" / "" are off, an object with a
    ``.lowp`` attribute (a schedule rule) resolves to it, and an unknown
    name raises ``lowp_dtype``'s KeyError."""
    if value is not None and hasattr(value, "lowp"):
        value = value.lowp
    if value is None or value in ("none", "off", ""):
        return None
    lowp_dtype(value)
    return value


def qmax(fmt: str) -> float:
    """Largest representable magnitude of a format."""
    lowp_dtype(fmt)
    return LOWP_FORMATS[fmt][1]


def quantize(
    x: torch.Tensor, fmt: str,
    channel_axes: tuple[int, ...] | int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric scaled quantization: returns ``(q, scale)`` with
    ``x ≈ q * scale`` and an fp32 scale. ``channel_axes`` keep
    independent scales (the max-abs reduction runs over all the others);
    ``None`` is per-tensor. The scale keeps reduced axes as size-1
    dims."""
    dtype, m = lowp_dtype(fmt), qmax(fmt)
    if channel_axes is None:
        channel_axes = ()
    elif isinstance(channel_axes, int):
        channel_axes = (channel_axes,)
    keep = {a % x.dim() for a in channel_axes}
    reduce_axes = tuple(a for a in range(x.dim()) if a not in keep)
    if not reduce_axes:
        reduce_axes = None
    x32 = x.float()
    amax = (torch.amax(x32.abs(), dim=reduce_axes, keepdim=True)
            if reduce_axes is not None else x32.abs())
    # All-zero slices quantize to zeros with scale 1 (never divide by 0).
    scale = torch.where(amax > 0.0, amax / m, torch.ones_like(amax))
    y = x32 / scale
    if fmt == "int8":
        q = torch.clamp(torch.round(y), -m, m).to(dtype)
    else:
        q = torch.clamp(y, -m, m).to(dtype)
    return q, scale


def quantize_kv(x: torch.Tensor, fmt: str) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [..., D]`` quantized as the KV cache stores it: one scale per
    vector over the last axis (each token's head vector), kept in bf16.
    Returns ``(payload [..., D], scales [...])``."""
    q, s = quantize(x, fmt, tuple(range(x.dim() - 1)))
    return q, s[..., 0].to(torch.bfloat16)


def dequantize(
    q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Inverse of ``quantize``: ``q * scale`` in ``dtype`` (``scale``
    broadcasts against ``q``)."""
    return (q.float() * scale.float()).to(dtype)


def byte_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or its uint8 view when it holds fp8 (same storage,
    so writes through the view land in ``t``)."""
    return t.view(torch.uint8) if t.dtype in _FP8 else t


def zeros(shape, dtype: torch.dtype, device=None) -> torch.Tensor:
    """``torch.zeros``, with fp8 made as zero bytes (0x00 is +0.0)."""
    if dtype in _FP8:
        return torch.zeros(shape, dtype=torch.uint8, device=device).view(dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


#: format -> the route ``qdot`` takes on a card.
QDOT_ROUTES = {"int8": "int_mm", "fp8_e4m3": "scaled_mm",
               "fp8_e5m2": "bf16_mm"}

#: ``qdot`` calls by route (``plain``: the CPU's).
qdot_calls = {"plain": 0, "int_mm": 0, "scaled_mm": 0, "bf16_mm": 0}

_FMT_OF = {dtype: fmt for fmt, (dtype, _) in LOWP_FORMATS.items()}


def _pad2(a: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``a`` [r, c] zero-padded to [rows, cols] (itself when it fits)."""
    r, c = a.shape
    if (r, c) == (rows, cols):
        return a
    out = zeros((rows, cols), a.dtype, a.device)
    byte_view(out)[:r, :c] = byte_view(a)
    return out


def _up(n: int, m: int, least: int = 0) -> int:
    return max(-(-n // m) * m, least)


def _raw_card(a: torch.Tensor, b: torch.Tensor, route: str) -> torch.Tensor:
    """The raw fp32 product ``a [M, K] @ b [K, N]`` of two quantized
    operands on a card, through ``route``."""
    m, k = a.shape
    n = b.shape[1]
    if route == "int_mm":
        # M > 16, K and N multiples of 8; b column-major.
        mp, kp, np_ = _up(m, 8, 24), _up(k, 8), _up(n, 8)
        a2 = _pad2(a, mp, kp).contiguous()
        b2 = _pad2(b.t(), np_, kp).contiguous().t()
        out = torch._int_mm(a2, b2).float()
    elif route == "scaled_mm":
        # Every dim a multiple of 16; b column-major; unit scales, so the
        # product is the raw one, scaled afterwards as the reference does.
        mp, kp, np_ = _up(m, 16), _up(k, 16), _up(n, 16)
        a2 = _pad2(a, mp, kp).contiguous()
        b2 = _pad2(b.t(), np_, kp).contiguous().t()
        one = torch.ones((), dtype=torch.float32, device=a.device)
        out = torch._scaled_mm(a2, b2, scale_a=one, scale_b=one,
                               out_dtype=torch.float32)
    else:
        out = torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                       out_dtype=torch.float32)
    qdot_calls[route] += 1
    return out[:m, :n]


def raw_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of the raw product ``a [M, K] @ b [K, N]`` of
    two quantized operands, fp32 out, on any device: int8 products
    summed in float64 are exact integers, as the reference's int32
    accumulation is; fp8 upcasts to fp32 and contracts there."""
    wide = torch.float64 if a.dtype == torch.int8 else torch.float32
    return torch.mm(a.to(wide), b.to(wide)).float()


def qdot(q_lhs: torch.Tensor, s_lhs: torch.Tensor, q_rhs: torch.Tensor,
         s_rhs: torch.Tensor) -> torch.Tensor:
    """Scaled low-precision contraction ``[..., K] x [K, M]`` of two
    quantized operands of one format, fp32 out: the raw product times
    ``s_lhs * s_rhs`` (scales that broadcast against ``[..., M]``;
    module docstring for the routes)."""
    if q_lhs.dtype != q_rhs.dtype or q_lhs.dtype not in _FMT_OF:
        raise TypeError(f"qdot takes two operands of one low-precision "
                        f"format, got {q_lhs.dtype} and {q_rhs.dtype}")
    lead, k = q_lhs.shape[:-1], q_lhs.shape[-1]
    a = q_lhs.reshape(-1, k)
    if q_lhs.device.type == "cuda":
        raw = _raw_card(a, q_rhs, QDOT_ROUTES[_FMT_OF[q_lhs.dtype]])
    else:
        raw = raw_plain(a, q_rhs)
        qdot_calls["plain"] += 1
    raw = raw.reshape(*lead, q_rhs.shape[1])
    return raw * (s_lhs.float() * s_rhs.float())


def _qmm_forward(x: torch.Tensor, w: torch.Tensor, fmt: str) -> torch.Tensor:
    q_x, s_x = quantize(x, fmt)
    q_w, s_w = quantize(w, fmt, channel_axes=1)  # scale [1, M]
    y = qdot(q_x, s_x.reshape(()), q_w, s_w[0])
    return y.to(torch.promote_types(x.dtype, w.dtype))


class _QuantizedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, fmt):
        ctx.save_for_backward(x, w)
        return _qmm_forward(x, w, fmt)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = torch.matmul(dy, w.t().to(dy.dtype))
        dw = torch.mm(x.reshape(-1, x.shape[-1]).float().t(),
                      dy.reshape(-1, dy.shape[-1]).float())
        return dx.to(x.dtype), dw.to(w.dtype), None


def quantized_matmul(x: torch.Tensor, w: torch.Tensor,
                     fmt: str) -> torch.Tensor:
    """Straight-through scaled low-precision ``[..., K] @ [K, M]``: the
    forward through ``qdot`` (per-tensor ``x``, per-output-channel ``w``
    scales), the backward the plain matmul's against the full-precision
    ``x`` and ``w``."""
    return _QuantizedMatmul.apply(x, w, fmt)
