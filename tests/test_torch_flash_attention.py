"""The port's flash attention (frl_distributed_ml_scaffold_tpu_torch/ops/
flash_attention.py) held against the JAX package's Pallas flash kernels,
run in interpret mode with explicit 32-row query blocks and 64-row key
blocks so they really tile, with blocks of two sizes.

On the CPU the port takes its plain versions (``dense_fwd_lse``,
``dense_bwd_lse``) and its own autograd Function; the CUDA kernels are
held against the same plain versions on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).

Tolerances: fp32 2e-5 (summation order; the JAX package's own flash
tests use the same); lse 1e-5 under both (fp32 sums of the same exact
products). bf16 outputs and gradients 2e-2 of ``max(1, max|ref|)``: both
round to bf16 (ulp 2^-8 relative) and round P (dS for dQ) to bf16 before
a product, the Pallas kernel at its running max and the plain version at
the row's global one.
"""

from __future__ import annotations

import importlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as tfa
from frl_distributed_ml_scaffold_tpu_torch.ops.ring_attention import (
    dense_attention as t_dense_attention,
)

jfa = importlib.import_module("frl_distributed_ml_scaffold_tpu.ops.flash_attention")
jra = importlib.import_module("frl_distributed_ml_scaffold_tpu.ops.ring_attention")

B, H, T, D = 2, 4, 128, 32
BLOCK_Q, BLOCK_K = 32, 64
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(n, dtype, shape=(B, H, T, D), seed=0):
    """``n`` arrays of ``shape`` from a numpy seed, as (jax, torch) pairs
    rounded to ``dtype`` the same way on both sides."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal(shape).astype(np.float32)
        t = torch.from_numpy(x).to(tdt)
        out.append((jnp.asarray(t.float().numpy()).astype(jdt), t))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, what):
    want = _np(want)
    tol = 2e-5 if dtype == "float32" else 2e-2 * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_fwd_bwd_match_the_pallas_kernels(dtype, causal):
    """o and lse, then dq, dk and dv from the same residuals: the port's
    plain versions against ``_fwd`` / ``_bwd`` in interpret mode."""
    (jq, q), (jk, k), (jv, v), (jdo, do) = _inputs(4, dtype)
    jo, jlse = jfa._fwd(jq, jk, jv, causal=causal, block_q=BLOCK_Q,
                        block_k=BLOCK_K, interpret=True)
    o, lse = tfa.block_attention_fwd(q, k, v, causal=causal)
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (B, H, T, 1)
    _close(o, jo, dtype, "o")
    np.testing.assert_allclose(_np(lse), _np(jlse), atol=1e-5, rtol=0)
    # Both backwards from the reference's residuals (o rounded the same).
    jo_t = torch.tensor(_np(jo)).to(q.dtype)
    jlse_t = torch.tensor(_np(jlse))
    jgrads = jfa._bwd(causal, BLOCK_Q, BLOCK_K, True,
                      (jq, jk, jv, jo, jlse), jdo)
    grads = tfa.block_attention_bwd(q, k, v, jo_t, jlse_t, do, causal=causal)
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        assert g.dtype == q.dtype
        _close(g, jg, dtype, name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_grads_match_jax_grad(dtype, causal):
    """The (B, T, H, D) router and its autograd Function against
    ``jax.grad`` of the JAX ``flash_attention`` (Pallas, interpret mode)."""
    shape = (B, T, H, D)
    (jq, q), (jk, k), (jv, v) = _inputs(3, dtype, shape, seed=1)
    w = np.sin(np.arange(np.prod(shape), dtype=np.float32)).reshape(shape)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, block_q=BLOCK_Q,
                                block_k=BLOCK_K, interpret=True)
        return (o.astype(jnp.float32) * w).sum(), o

    (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(jq, jk, jv)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = tfa.flash_attention.fallbacks
    o = tfa.flash_attention(q, k, v, causal=causal)
    assert tfa.flash_attention.fallbacks == before
    grads = torch.autograd.grad((o.float() * torch.from_numpy(w)).sum(),
                                (q, k, v))
    _close(o.detach(), jo, dtype, "o")
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        _close(g, jg, dtype, name)


def test_plain_versions_match_autograd_of_the_plain_forward():
    """fp32: the explicit plain backward equals torch.autograd through
    the plain forward (what ``chip_smoke.py`` holds the kernels' autograd
    Function to on the card)."""
    (_, q), (_, k), (_, v), (_, do) = _inputs(4, "float32", seed=2)
    for causal in (True, False):
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        o, lse = tfa.dense_fwd_lse(qq, kk, vv, causal=causal)
        want = torch.autograd.grad(o, (qq, kk, vv), do)
        got = tfa.dense_bwd_lse(q, k, v, o.detach(), lse.detach(), do,
                                causal=causal)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=2e-5, rtol=0)


@pytest.mark.parametrize("t", [100, 12, 4, 1000, 136, 8])
def test_fallback_rule_matches_the_reference(t, caplog):
    """A T with no power-of-two block >= 8 dividing it, or a head dim not
    a multiple of 32, goes dense as the reference's does, counted in
    ``fallbacks`` and logged once per reason; a shape that tiles never
    goes dense."""
    for d in (32, 48, 64):
        jax_dense = (jfa._pick_block(t, min(jfa._auto_block(t), t)) is None
                     or d % 32 != 0)
        assert (tfa.fallback_reason(t, d) is not None) == jax_dense
    (_, q), (_, k), (_, v) = _inputs(3, "float32", (1, t, 2, 32), seed=3)
    tiles = tfa.fallback_reason(t, 32) is None
    before = tfa.flash_attention.fallbacks
    with caplog.at_level(logging.WARNING, logger=tfa.__name__):
        for _ in range(2):
            o = tfa.flash_attention(q, k, v, causal=True)
    assert tfa.flash_attention.fallbacks == before + (0 if tiles else 2)
    if not tiles:
        torch.testing.assert_close(o, t_dense_attention(q, k, v, causal=True),
                                   atol=0, rtol=0)
        want = np.asarray(jra.dense_attention(*(jnp.asarray(x.numpy())
                                                for x in (q, k, v))))
        np.testing.assert_allclose(o.numpy(), want, atol=2e-5, rtol=0)
        assert len([r for r in caplog.records
                    if "falling back" in r.getMessage()]) <= 1
    else:
        assert not [r for r in caplog.records
                    if "falling back" in r.getMessage()]


def test_block_routers_fall_back_on_untileable_shapes():
    """Tq != Tk or an untileable T takes the plain lse versions, counted."""
    (_, q), (_, k), (_, v) = _inputs(3, "float32", (1, 2, 12, 32), seed=4)
    before = tfa.flash_attention.fallbacks
    o, lse = tfa.block_attention_fwd(q, k, v, causal=True)
    want = tfa.dense_fwd_lse(q, k, v, causal=True)
    torch.testing.assert_close(o, want[0], atol=0, rtol=0)
    torch.testing.assert_close(lse, want[1], atol=0, rtol=0)
    tfa.block_attention_bwd(q, k, v, o, lse, q, causal=True)
    assert tfa.flash_attention.fallbacks == before + 2


def test_dense_attention_matches_jax():
    """The plain training attention (``model.attention=dense``) against
    the JAX ``dense_attention``, fp32 and bf16."""
    for dtype in ("float32", "bfloat16"):
        (jq, q), (jk, k), (jv, v) = _inputs(3, dtype, (B, T, H, D), seed=5)
        for causal in (True, False):
            want = jra.dense_attention(jq, jk, jv, causal=causal)
            got = t_dense_attention(q, k, v, causal=causal)
            assert got.dtype == q.dtype
            _close(got, want, dtype, f"dense causal={causal}")


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_shapes():
    """The kernel wrappers take only what the CUDA kernels take; they
    refuse before any build or launch."""
    (_, q), = _inputs(1, "float32", (1, 2, 64, 48))
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_fwd(q, q, q, causal=True)
    (_, q), = _inputs(1, "float32", (1, 2, 64, 32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_fwd(q.half(), q.half(), q.half(), causal=True)
    with pytest.raises(ValueError, match="one shape"):
        tfa.flash_fwd(q, q[:, :, :32], q, causal=True)
    with pytest.raises(ValueError, match="unit stride"):
        tfa.flash_fwd(q, q, q.transpose(2, 3).contiguous().transpose(2, 3),
                      causal=True)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_bwd_dq(q, q, q, q, torch.zeros(1, 2, 64), q, causal=True)


def test_bf16_kernel_wrappers_refuse_misaligned_tensors():
    """The bf16 kernels read 16 bytes at a time: a (B, T, H, D) view with
    strides in multiples of 8 elements passes the wrappers' check; a t
    stride off the 8-element grid or a base pointer off 16 bytes raises
    before any build or launch."""
    bf = torch.bfloat16
    view = torch.zeros(1, 64, 2, 40, dtype=bf)[..., :32]
    tfa._check_kernel_args(1, view, view, view)
    odd = torch.zeros(1, 2, 64, 36, dtype=bf)[..., :32]
    with pytest.raises(ValueError, match="multiples of 8"):
        tfa.flash_fwd(odd, odd, odd, causal=True)
    shifted = torch.zeros(1 * 2 * 64 * 32 + 1, dtype=bf)[1:].view(1, 2, 64, 32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_bwd_dkv(shifted, shifted, shifted, shifted,
                          torch.zeros(1, 2, 64, 1), shifted, causal=True)
