"""Scaled low-precision (int8 / fp8) quantization for the KV cache.

The port's own copy of the JAX package's ``ops/quantization.py``
(``LOWP_FORMATS``, ``lowp_dtype``, ``qmax``, ``quantize``,
``dequantize``), so a format name means the same thing to both packages
and a quantized cache holds the same bytes in both. ``quantize`` follows
the reference step for step: ``scale = max|x| / qmax`` in fp32 over every
axis but the kept channel axes (1 where the slice is all zero), ``y = x /
scale`` in fp32, then int8 rounds half to even and clips, fp8 clips and
casts. The cache keeps one scale per head vector, so ``quantize`` takes
the kept axes as a tuple; the per-tensor and bare-int forms, like the
scaled matmuls (``qdot``, ``quantized_matmul``), serve the
tensor-parallel rings and training, which are not ported yet.

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


def qmax(fmt: str) -> float:
    """Largest representable magnitude of a format."""
    lowp_dtype(fmt)
    return LOWP_FORMATS[fmt][1]


def quantize(
    x: torch.Tensor, fmt: str, channel_axes: tuple[int, ...]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric scaled quantization: returns ``(q, scale)`` with
    ``x ≈ q * scale`` and an fp32 scale. ``channel_axes`` keep
    independent scales (the max-abs reduction runs over all the others);
    the scale keeps reduced axes as size-1 dims."""
    dtype, m = lowp_dtype(fmt), qmax(fmt)
    keep = {a % x.dim() for a in channel_axes}
    reduce_axes = tuple(a for a in range(x.dim()) if a not in keep)
    x32 = x.float()
    amax = torch.amax(x32.abs(), dim=reduce_axes, keepdim=True)
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
