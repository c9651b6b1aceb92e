"""The port's fused BatchNorm (frl_distributed_ml_scaffold_tpu_torch/ops/
fused_bn.py) against the JAX package's ``ops/fused_bn.py`` and flax's
``nn.BatchNorm``, on the CPU, inputs from a numpy seed.

- The plain versions of the two backward passes (``bn_sums`` / ``bn_dx``
  take them on a CPU tensor) against the Pallas ``_kernel_sums`` /
  ``_kernel_dx`` in interpret mode, at several (M, C): M not a multiple
  of the row block, C not a multiple of 128 (nor of the 16-byte vector).
- ``fused_bn_train``'s forward and its gradients through the autograd
  Function against JAX ``fused_bn_train`` and ``jax.vjp`` of it.
- The ``BatchNorm`` / ``FusedBatchNorm`` modules against flax
  ``nn.BatchNorm``: train-mode output and new running statistics, and
  eval mode.

Tolerances: fp32 1e-5 relative to max(1, max|ref|) (summation order and
rsqrt only); bf16 outputs one bf16 ulp (2^-7) relative, where the two
frameworks may round a value the other way; the sums are fp32 in both
dtypes, 1e-5.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frl_distributed_ml_scaffold_tpu.ops import fused_bn as jbn
from frl_distributed_ml_scaffold_tpu_torch.ops import fused_bn as tbn

EPS = 1e-5
TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol, scale)


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32), getattr(jnp, dtype))


def _inputs(rng, shape, dtype):
    """x with per-channel offsets and spreads, dy, a random gamma (some
    negative: a gamma of 1 or 0 would hide the scale's part of dx)."""
    c = shape[-1]
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 2.5, c)
         + rng.standard_normal(c)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    scale = rng.uniform(-0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    # Round once to the dtype so both frameworks see the same values.
    x, dy, scale, bias = (np.asarray(_t(a, dtype).float()) for a in
                          (x, dy, scale, bias))
    return x, dy, scale, bias


def _stats(x):
    x2d = x.reshape(-1, x.shape[-1]).astype(np.float32)
    mean = x2d.mean(0)
    var = np.maximum(0.0, (x2d * x2d).mean(0) - mean * mean)
    return mean.astype(np.float32), var.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,c", [(64, 128), (1000, 64), (333, 100),
                                 (37, 2048)])
def test_backward_passes_match_pallas_kernels(m, c, dtype):
    """``bn_sums`` and ``bn_dx`` (their plain versions, on the CPU)
    against the Pallas sums and dx kernels in interpret mode."""
    rng = np.random.default_rng(m * 7 + c)
    x, dy, scale, _ = _inputs(rng, (m, c), dtype)
    mean, var = _stats(x)
    jdb, jdg = jbn._kernel_sums(_j(x, dtype), _j(dy, dtype), jnp.asarray(mean),
                                jnp.asarray(var), EPS, True)
    tdb, tdg = tbn.bn_sums(_t(x, dtype), _t(dy, dtype), torch.from_numpy(mean),
                           torch.from_numpy(var), EPS)
    assert tdb.dtype == tdg.dtype == torch.float32
    _close(tdb, jdb, TOL["float32"])
    _close(tdg, jdg, TOL["float32"])
    jdx = jbn._kernel_dx(_j(x, dtype), _j(dy, dtype), _j(scale, dtype),
                         jnp.asarray(mean), jnp.asarray(var), jdg, jdb, EPS,
                         float(m), True)
    tdx = tbn.bn_dx(_t(x, dtype), _t(dy, dtype), _t(scale, dtype),
                    torch.from_numpy(mean), torch.from_numpy(var),
                    torch.from_numpy(np.array(jdg)),
                    torch.from_numpy(np.array(jdb)), EPS, m)
    assert tdx.dtype == getattr(torch, dtype) and tdx.shape == (m, c)
    _close(tdx.float(), np.asarray(jdx, np.float32), TOL[dtype])


def test_fallback_bwd_matches_jax():
    """The whole plain backward over an NHWC tensor against
    ``_fallback_bwd``."""
    rng = np.random.default_rng(3)
    x, dy, scale, _ = _inputs(rng, (2, 5, 6, 24), "float32")
    mean, var = _stats(x)
    want = jbn._fallback_bwd(jnp.asarray(x), jnp.asarray(dy),
                             jnp.asarray(scale), jnp.asarray(mean),
                             jnp.asarray(var), EPS)
    got = tbn.fallback_bwd(*(torch.from_numpy(a) for a in
                             (x, dy, scale, mean, var)), EPS)
    for g, w in zip(got, want):
        _close(g, w, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_bn_train_matches_jax(dtype):
    """Forward (y, mean, var) and the gradients of x, scale and bias
    through the autograd Function against JAX ``fused_bn_train`` and its
    custom VJP; the gradients come back in the inputs' dtypes."""
    rng = np.random.default_rng(11)
    x, dy, scale, bias = _inputs(rng, (3, 7, 5, 40), dtype)
    jx, jscale, jbias = _j(x, dtype), _j(scale, dtype), _j(bias, dtype)
    (jy, jmean, jvar), vjp = jax.vjp(
        lambda a, s, b: jbn.fused_bn_train(a, s, b, eps=EPS), jx, jscale,
        jbias)
    jgrads = vjp((_j(dy, dtype), jnp.zeros_like(jmean), jnp.zeros_like(jvar)))
    leaves = [_t(a, dtype).requires_grad_() for a in (x, scale, bias)]
    y, mean, var = tbn.fused_bn_train(*leaves, eps=EPS)
    assert y.dtype == getattr(torch, dtype)
    assert mean.dtype == var.dtype == torch.float32
    assert not mean.requires_grad and not var.requires_grad
    _close(y.detach().float(), np.asarray(jy, np.float32), TOL[dtype])
    _close(mean, jmean, TOL["float32"])
    _close(var, jvar, TOL["float32"])
    grads = torch.autograd.grad(y, leaves, _t(dy, dtype))
    for g, w, leaf in zip(grads, jgrads, leaves):
        assert g.dtype == leaf.dtype
        _close(g.float(), np.asarray(w, np.float32),
               TOL[dtype])


@pytest.mark.parametrize("policy", ["fp32", "bf16_mixed"])
@pytest.mark.parametrize("fused", [False, True])
def test_batchnorm_modules_match_flax(fused, policy):
    """``BatchNorm`` / ``FusedBatchNorm`` against flax ``nn.BatchNorm``
    (momentum 0.9, eps 1e-5, the compute dtype as ``dtype``): train-mode
    output and new running statistics from non-trivial old ones, and
    eval-mode output; the buffers are not written by the forward."""
    cd = "float32" if policy == "fp32" else "bfloat16"
    rng = np.random.default_rng(5)
    x, _, scale, bias = _inputs(rng, (4, 3, 3, 16), cd)
    ra_mean = rng.standard_normal(16).astype(np.float32)
    ra_var = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    flax_bn = fnn.BatchNorm(momentum=0.9, epsilon=EPS,
                            dtype=getattr(jnp, cd))
    variables = {"params": {"scale": _j(scale, cd), "bias": _j(bias, cd)},
                 "batch_stats": {"mean": jnp.asarray(ra_mean),
                                 "var": jnp.asarray(ra_var)}}
    jy, new = flax_bn.apply(variables, _j(x, cd), use_running_average=False,
                            mutable=["batch_stats"])
    jy_eval = flax_bn.apply(variables, _j(x, cd), use_running_average=True)

    cls = tbn.FusedBatchNorm if fused else tbn.BatchNorm
    mod = cls(16, momentum=0.9, epsilon=EPS, dtype=getattr(torch, cd))
    mod.stats_name = "bn."
    with torch.no_grad():
        mod.scale.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        mod.mean.copy_(torch.from_numpy(ra_mean))
        mod.var.copy_(torch.from_numpy(ra_var))
    params = {"scale": _t(scale, cd), "bias": _t(bias, cd),
              "mean": torch.from_numpy(ra_mean),
              "var": torch.from_numpy(ra_var)}
    updates: dict = {}
    y = torch.func.functional_call(mod, params, (_t(x, cd),),
                                   {"train": True, "updates": updates})
    assert y.dtype == getattr(torch, cd)
    _close(y.float(), np.asarray(jy, np.float32), TOL[cd])
    assert set(updates) == {"bn.mean", "bn.var"}
    _close(updates["bn.mean"], new["batch_stats"]["mean"], TOL["float32"])
    _close(updates["bn.var"], new["batch_stats"]["var"], TOL["float32"])
    torch.testing.assert_close(mod.mean, torch.from_numpy(ra_mean))
    y_eval = mod(_t(x, cd), train=False, updates={})
    _close(y_eval.float(), np.asarray(jy_eval, np.float32), TOL[cd])


def test_fused_grads_match_autograd_of_the_plain_forward():
    """The closed-form backward (``FusedBatchNorm``) against autograd
    through the plain forward (``BatchNorm``), fp32."""
    rng = np.random.default_rng(9)
    x, dy, scale, bias = _inputs(rng, (4, 6, 6, 32), "float32")
    grads = {}
    for cls in (tbn.BatchNorm, tbn.FusedBatchNorm):
        mod = cls(32)
        with torch.no_grad():
            mod.scale.copy_(torch.from_numpy(scale))
            mod.bias.copy_(torch.from_numpy(bias))
        xt = torch.from_numpy(x).requires_grad_()
        y = mod(xt, train=True, updates={})
        grads[cls] = torch.autograd.grad(y, [xt, mod.scale, mod.bias],
                                         torch.from_numpy(dy))
    for g, w in zip(grads[tbn.FusedBatchNorm], grads[tbn.BatchNorm]):
        _close(g, w.numpy(), TOL["float32"])
