"""The port's quantization primitives (frl_distributed_ml_scaffold_tpu_torch/
ops/quantization.py) held to the JAX package's, compiled as it runs
there (``jq_quantize``), bit for bit: the same
inputs, made from a numpy seed, give the same payload bytes and the same
scales in int8, fp8_e4m3 and fp8_e5m2, from fp32 and from bf16, with
all-zero head vectors among them (scale 1). A quantized cache written by
either package therefore holds the same bytes.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frl_distributed_ml_scaffold_tpu_torch.ops import quantization as tq

jq = importlib.import_module("frl_distributed_ml_scaffold_tpu.ops.quantization")
# The JAX package's ``quantize`` as it runs there: compiled, where XLA
# takes ``max|x| / qmax`` as a product with qmax's fp32 reciprocal (eager
# JAX divides; ROADMAP C.15).
jq_quantize = jax.jit(jq.quantize, static_argnums=(1, 2))

FORMATS = ["int8", "fp8_e4m3", "fp8_e5m2"]


def _x(seed: int) -> np.ndarray:
    """[B, t, H, hd] K/V-shaped values over a wide range, with two
    all-zero head vectors and one exact maximum."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5, 4, 32)).astype(np.float32)
    x *= np.exp(rng.uniform(-6, 6, (3, 5, 4, 1))).astype(np.float32)
    x[0, 1, 2] = 0.0
    x[2, 4] = 0.0
    x[1, 0, 0, 3] = 448.0
    return x


def _bytes(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return tq.byte_view(t).numpy().view(np.uint8)
    return np.asarray(t).view(np.uint8)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stacked", [False, True], ids=["per_head", "kv_stack"])
def test_quantize_is_bit_identical_to_jax(fmt, dtype, stacked):
    """One head vector's K, or (as the model writes) K and V stacked on a
    leading axis and quantized in one call; the JAX side quantizes each
    of K and V alone, so the stacked call must not mix their scales."""
    x = _x(0)
    xs = np.stack((x, _x(2))) if stacked else x[None]
    axes = (0, 1, 2, 3) if stacked else (0, 1, 2)
    tqv, ts = tq.quantize(torch.from_numpy(xs if stacked else x)
                          .to(getattr(torch, dtype)), fmt, channel_axes=axes)
    if not stacked:
        tqv, ts = tqv[None], ts[None]
    assert tqv.dtype == tq.lowp_dtype(fmt) and ts.dtype == torch.float32
    assert tuple(ts.shape) == xs.shape[:-1] + (1,)
    for i, xi in enumerate(xs):
        jqv, js = jq_quantize(jnp.asarray(xi, getattr(jnp, dtype)), fmt,
                              (0, 1, 2))
        np.testing.assert_array_equal(_bytes(tqv[i]), _bytes(jqv))
        np.testing.assert_array_equal(ts[i].numpy(), np.asarray(js))
        # The stored form: scales cast to bf16, as the cache keeps them.
        np.testing.assert_array_equal(
            ts[i].to(torch.bfloat16).float().numpy(),
            np.asarray(js.astype(jnp.bfloat16).astype(jnp.float32)),
        )
    # The cache's form of the same call: bf16 scales without the kept dim.
    kq, ks = tq.quantize_kv(torch.from_numpy(xs).to(getattr(torch, dtype)),
                            fmt)
    assert torch.equal(tq.byte_view(kq), tq.byte_view(tqv))
    assert torch.equal(ks, ts[..., 0].to(torch.bfloat16))
    assert ts[0, 0, 1, 2, 0] == 1.0 and (ts[0, 2, 4] == 1.0).all()
    assert not _bytes(tqv)[0, 0, 1, 2].any()


@pytest.mark.parametrize("fmt", FORMATS)
def test_dequantize_matches_jax_and_round_trips(fmt):
    x = _x(1)
    jqv, js = jq_quantize(jnp.asarray(x), fmt, (0, 1, 2))
    tqv, ts = tq.quantize(torch.from_numpy(x), fmt, channel_axes=(0, 1, 2))
    for dt in ("float32", "bfloat16"):
        got = tq.dequantize(tqv, ts, getattr(torch, dt)).float().numpy()
        want = np.asarray(
            jq.dequantize(jqv, js, getattr(jnp, dt)).astype(jnp.float32)
        )
        np.testing.assert_array_equal(got, want)
    # Relative error of one element against its head vector's max.
    back = tq.dequantize(tqv, ts).numpy()
    amax = np.abs(x).max(axis=-1, keepdims=True)
    rel = {"int8": 0.5 / 127, "fp8_e4m3": 2.0 ** -4, "fp8_e5m2": 2.0 ** -3}
    assert (np.abs(back - x) <= rel[fmt] * np.maximum(amax, 1e-30) + 1e-45).all()


def test_formats_and_byte_helpers():
    assert sorted(tq.LOWP_FORMATS) == sorted(jq.LOWP_FORMATS)
    for fmt in FORMATS:
        assert tq.qmax(fmt) == jq.qmax(fmt)
        assert str(tq.lowp_dtype(fmt)).replace("torch.", "") == (
            jnp.dtype(jq.lowp_dtype(fmt)).name
        )
    with pytest.raises(KeyError, match="known"):
        tq.lowp_dtype("int4")
    z = tq.zeros((2, 3), torch.float8_e4m3fn)
    assert z.dtype == torch.float8_e4m3fn and not _bytes(z).any()
    assert (z.float() == 0).all()
    b = tq.byte_view(z)
    b[0, 1] = 0x38  # 1.0 in e4m3
    assert float(z[0, 1].float()) == 1.0
    i8 = torch.zeros(2, dtype=torch.int8)
    assert tq.byte_view(i8) is i8
