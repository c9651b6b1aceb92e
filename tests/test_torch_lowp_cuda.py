"""The scaled low-precision product's card routes (``ops/quantization.py``
``qdot``, ``QDOT_ROUTES``: int8 ``torch._int_mm``, fp8_e4m3
``torch._scaled_mm``, fp8_e5m2 the bf16 tensor cores into fp32) against
the plain version on the same operands.

Marked ``cuda`` and skipped without a card. This file imports no JAX, so
it also runs on a machine that has none; there, skip the repository
conftest (which sets up JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_lowp_cuda.py

Tolerances: int8 exact (integer products); fp8_e5m2 1e-5 relative to
the largest value (fp32 sums in another order); fp8_e4m3 1e-3 (cuBLASLt's
fp8 product keeps fewer bits than fp32 between its promotions; 2.9e-4
measured by ``chip_smoke.py``'s ``lowp_check``).
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import numpy as np
import pytest
import torch

from frl_distributed_ml_scaffold_tpu_torch.ops import quantization as tq

FORMATS = ["int8", "fp8_e4m3", "fp8_e5m2"]
TOL = {"int8": 0.0, "fp8_e4m3": 1e-3, "fp8_e5m2": 1e-5}


def _x(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return x * np.exp(rng.uniform(-3, 3, shape[-1:])).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("rows", [8, 8192])
def test_qdot_card_route_matches_plain(fmt, rows):
    """Each format's card route against the plain version on the same
    operands; 8 rows pads up to the routes' shapes, 520 columns to
    their multiples."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card routes have no CPU mode)")
    x = torch.from_numpy(_x((rows, 1024), 8))
    w = torch.from_numpy(_x((1024, 520), 9))
    qx, sx = tq.quantize(x, fmt)
    qw, sw = tq.quantize(w, fmt, channel_axes=1)
    route = tq.QDOT_ROUTES[fmt]
    n = tq.qdot_calls[route]
    got = tq.qdot(qx.cuda(), sx.cuda(), qw.cuda(), sw[0].cuda()).cpu()
    assert tq.qdot_calls[route] == n + 1
    want = tq.qdot(qx, sx, qw, sw[0])
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err <= TOL[fmt], (fmt, err)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_quantized_matmul_on_the_card(fmt):
    """``quantized_matmul`` on the card: the forward is ``qdot``'s, the
    straight-through gradients the plain matmul's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card routes have no CPU mode)")
    x = torch.from_numpy(_x((64, 256), 1)).cuda().requires_grad_()
    w = torch.from_numpy(_x((256, 128), 2)).cuda().requires_grad_()
    dy = torch.from_numpy(_x((64, 128), 3)).cuda()
    y = tq.quantized_matmul(x, w, fmt)
    y.backward(dy)
    qx, sx = tq.quantize(x.detach(), fmt)
    qw, sw = tq.quantize(w.detach(), fmt, channel_axes=1)
    torch.testing.assert_close(y.detach(), tq.qdot(qx, sx.reshape(()), qw,
                                                   sw[0]), rtol=0, atol=0)
    torch.testing.assert_close(x.grad, dy @ w.detach().t(), rtol=1e-5,
                               atol=1e-4)
    torch.testing.assert_close(w.grad, x.detach().t() @ dy, rtol=1e-5,
                               atol=1e-4)
