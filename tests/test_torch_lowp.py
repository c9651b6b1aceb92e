"""The port's scaled low-precision matmuls (``ops/quantization.py``
``resolve_lowp``, ``quantize`` per-tensor and per-channel, ``qdot``,
``quantized_matmul``) against the JAX package's, on the same inputs
made from a numpy seed, in int8, fp8_e4m3 and fp8_e5m2:

- ``quantize`` with ``channel_axes`` None, an int and a tuple: payload
  bytes and scales bit-equal;
- ``qdot`` of those payloads: int8 bit-equal (exact integer products,
  the same fp32 scaling), fp8 within 1e-6 relative (fp32 products
  summed in another order);
- ``quantized_matmul`` forward (as ``qdot``) and its straight-through
  backward, the plain matmul's against the full-precision operands,
  within 1e-6 relative.

Each format's card route is ``test_torch_lowp_cuda.py``'s.
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

FORMATS = ["int8", "fp8_e4m3", "fp8_e5m2"]
AXES = [None, 1, -1, (0, 2)]


def _x(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return x * np.exp(rng.uniform(-3, 3, shape[-1:])).astype(np.float32)


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return tq.byte_view(t.contiguous()).numpy().view(np.uint8)
    return np.asarray(t).view(np.uint8)


def test_resolve_lowp_matches_jax():
    for v in (None, "none", "off", "", "int8", "fp8_e4m3", "fp8_e5m2"):
        assert tq.resolve_lowp(v) == jq.resolve_lowp(v)

    class Rule:
        lowp = "int8"

    assert tq.resolve_lowp(Rule()) == jq.resolve_lowp(Rule()) == "int8"
    with pytest.raises(KeyError) as t_err:
        tq.resolve_lowp("int4")
    with pytest.raises(KeyError) as j_err:
        jq.resolve_lowp("int4")
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("axes", AXES, ids=str)
def test_quantize_axes_bit_identical_to_jax(fmt, axes):
    x = _x((3, 5, 8), 1)
    x[1] = 0.0  # an all-zero slice: scale 1
    tqv, ts = tq.quantize(torch.from_numpy(x), fmt, channel_axes=axes)
    jqv, js = jq.quantize(jnp.asarray(x), fmt, channel_axes=axes)
    assert tuple(ts.shape) == js.shape and tuple(tqv.shape) == jqv.shape
    np.testing.assert_array_equal(_bits(tqv), _bits(jqv))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))


def _operands(fmt, seed=3):
    x = _x((2, 7, 24), seed)
    w = _x((24, 16), seed + 1)
    return (tq.quantize(torch.from_numpy(x), fmt),
            tq.quantize(torch.from_numpy(w), fmt, channel_axes=1),
            jq.quantize(jnp.asarray(x), fmt),
            jq.quantize(jnp.asarray(w), fmt, channel_axes=(1,)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_qdot_matches_jax(fmt):
    (tx, tsx), (tw, tsw), (jx, jsx), (jw, jsw) = _operands(fmt)
    calls = tq.qdot_calls["plain"]
    got = tq.qdot(tx, tsx.reshape(()), tw, tsw[0]).numpy()
    assert tq.qdot_calls["plain"] == calls + 1  # the CPU's plain version
    want = np.asarray(jq.qdot(jx, jnp.squeeze(jsx), jw, jsw[0],
                              (((2,), (0,)), ((), ()))))
    assert got.dtype == np.float32 and got.shape == want.shape
    if fmt == "int8":
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def test_qdot_refuses_mixed_formats():
    (tx, tsx), _, _, _ = _operands("int8")
    (_, _), (tw, tsw), _, _ = _operands("fp8_e4m3")
    with pytest.raises(TypeError, match="one low-precision format"):
        tq.qdot(tx, tsx, tw, tsw[0])


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantized_matmul_forward_and_ste_backward_match_jax(fmt):
    x = _x((2, 7, 24), 5)
    w = _x((24, 16), 6)
    dy = _x((2, 7, 16), 7)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ty = tq.quantized_matmul(tx, tw, fmt)
    ty.backward(torch.from_numpy(dy))
    jy, vjp = jax.vjp(lambda a, b: jq.quantized_matmul(a, b, fmt),
                      jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    want = np.asarray(jy)
    if fmt == "int8":
        np.testing.assert_array_equal(ty.detach().numpy().view(np.uint32),
                                      want.view(np.uint32))
    else:
        np.testing.assert_allclose(ty.detach().numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    for g, r in ((tx.grad, jdx), (tw.grad, jdw)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-6,
                                   atol=1e-6 * np.abs(r).max())
    # Straight-through: the gradients are the plain matmul's.
    np.testing.assert_allclose(tx.grad.numpy(), dy @ w.T, rtol=1e-5,
                               atol=1e-5)
