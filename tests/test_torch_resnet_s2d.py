"""The port's space-to-depth stem and mask pool (models/resnet.py
``stem="s2d"``, ``pool_grad="mask"``; models/convert.py
``s2d_stem_weights``) against the JAX package, on the CPU, inputs from a
numpy seed.

- A depth-10 ResNet at 32 px with ``stem=s2d pool_grad=mask``, the JAX
  variables carried across with ``resnet_params_from_jax`` (the
  ``stem_s2d`` leaf): logits in train and eval mode, fp32 and
  bf16_mixed, and in fp32 every parameter's gradient of a seeded
  projection of the train-mode logits.
- ``space_to_depth`` and ``s2d_stem_weights`` equal the JAX package's
  bit for bit, and a stem (and a whole network) rewritten by
  ``s2d_stem_weights`` computes what the 7x7/s2 stem computes.
- The mask backward equals autodiff's (scatter) on a tie-free input,
  splits tied maxima as JAX ``_max_pool_mask_grad`` does, and keeps the
  gradient's mass; odd pool-input dims raise with the JAX message.

Tolerances, relative to max(1, max|ref|) as in test_torch_resnet.py:
logits 1e-3 fp32 / 5e-2 bf16_mixed (that file's reasons; measured 5.1e-6
/ 2.9e-2); gradients 1e-3 of each tensor's largest JAX entry (measured
9.8e-6: convolutions summed in another order under train-mode
BatchNorm); the rewritten stem and network 1e-5 (measured 2.4e-7 /
3.0e-7: the same products summed in another order); the pool's
gradients 1e-6 (measured: 0 against JAX's mask gradient, 2.4e-7 against
autodiff's, which sums a position's windows in another order).
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_resnet_variables

from frl_distributed_ml_scaffold_tpu.config import schema as jschema
from frl_distributed_ml_scaffold_tpu.models import resnet as jresnet
from frl_distributed_ml_scaffold_tpu.precision import get_policy as jax_policy
from frl_distributed_ml_scaffold_tpu_torch.config import schema as tschema
from frl_distributed_ml_scaffold_tpu_torch.models import resnet as tresnet
from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
    init_resnet_params,
    resnet_params_from_jax,
    s2d_stem_weights,
)
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

DEPTH, CLASSES, IMAGE, BATCH = 10, 10, 32, 8
MODEL = dict(depth=DEPTH, num_classes=CLASSES, stem="s2d", pool_grad="mask")
LOGIT_TOL = {"fp32": 1e-3, "bf16_mixed": 5e-2}
GRAD_TOL, STEM_TOL, POOL_TOL = 1e-3, 1e-5, 1e-6


@functools.lru_cache(maxsize=None)
def _variables():
    return jax_resnet_variables(DEPTH, CLASSES, IMAGE, stem="s2d",
                                pool_grad="mask")


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def _port(policy):
    v = _variables()
    model = tresnet.ResNet(tschema.ResNetConfig(**MODEL), get_policy(policy),
                           device="cpu")
    params, extras = resnet_params_from_jax(v["params"], v["batch_stats"])
    model.load_state_dict({**params, **extras["batch_stats"]})
    return model


def _inputs():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    w = rng.standard_normal((BATCH, CLASSES)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("policy", ["fp32", "bf16_mixed"])
def test_logits_match_jax(policy):
    x, _ = _inputs()
    jmodel = jresnet.ResNet(jschema.ResNetConfig(**MODEL), jax_policy(policy))
    jvars = jax.tree.map(jnp.asarray, _variables())
    model = _port(policy)
    assert tuple(model.stem_s2d.weight.shape) == (64, 12, 4, 4)
    for train in (True, False):
        want = jax.jit(lambda v, a: jmodel.apply(
            v, a, train=train, mutable=["batch_stats"] if train else False))(
            jvars, x)
        want = want[0] if train else want
        got, _ = model(torch.from_numpy(x), train=train)
        _close(got, want, LOGIT_TOL[policy], f"logits train={train}")


def test_gradients_match_jax():
    x, w = _inputs()
    v = _variables()
    jmodel = jresnet.ResNet(jschema.ResNetConfig(**MODEL), jax_policy("fp32"))

    def loss(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, x,
            train=True, mutable=["batch_stats"])
        return (logits * w).sum()

    jgrads = jax.device_get(jax.jit(jax.grad(loss))(
        jax.tree.map(jnp.asarray, v["params"])))
    want, _ = resnet_params_from_jax(jgrads, v["batch_stats"])
    model = _port("fp32")
    logits, _ = model(torch.from_numpy(x), train=True)
    (logits * torch.from_numpy(w)).sum().backward()
    got = dict(model.named_parameters())
    assert got.keys() == want.keys() and "stem_s2d.weight" in want
    for name, g in want.items():
        err = float((got[name].grad - g).abs().max())
        assert err <= GRAD_TOL * float(g.abs().max()) + 1e-7, (name, err)


def test_s2d_rewrite_equals_conv7():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    w7 = rng.standard_normal((7, 7, 3, 8)).astype(np.float32)  # HWIO
    xt, w7t = torch.from_numpy(x), torch.from_numpy(w7).permute(3, 2, 0, 1)
    np.testing.assert_array_equal(
        tresnet.space_to_depth(xt).numpy(),
        np.asarray(jresnet.space_to_depth(jnp.asarray(x))))
    w4 = s2d_stem_weights(w7t)
    np.testing.assert_array_equal(
        w4.numpy(), np.asarray(jresnet.s2d_stem_weights(
            jnp.asarray(w7))).transpose(3, 2, 0, 1))
    conv7 = tresnet.Conv(3, 8, 7, 2, device="cpu")
    conv4 = tresnet.Conv(12, 8, 4, 1, device="cpu")
    with torch.no_grad():
        conv7.weight.copy_(w7t)
        conv4.weight.copy_(w4)
        _close(conv4(tresnet.space_to_depth(xt)), conv7(xt), STEM_TOL, "stem")
    # A whole network: the conv7 model's weights with the stem rewritten.
    cfg = tschema.ResNetConfig(depth=DEPTH, num_classes=CLASSES)
    params, extras = init_resnet_params(
        cfg, torch.Generator().manual_seed(0))
    w = params.pop("stem_conv.weight")
    nets = {}
    for stem, sd in (("conv7", {"stem_conv.weight": w}),
                     ("s2d", {"stem_s2d.weight": s2d_stem_weights(w)})):
        nets[stem] = tresnet.ResNet(dataclasses.replace(cfg, stem=stem),
                                    get_policy("fp32"), device="cpu")
        nets[stem].load_state_dict({**params, **sd, **extras["batch_stats"]})
    with torch.no_grad():
        _close(nets["s2d"](xt)[0], nets["conv7"](xt)[0], STEM_TOL, "network")


def _pool_grads(x: np.ndarray, dy: np.ndarray):
    xt = torch.from_numpy(x).requires_grad_()
    dyt = torch.from_numpy(dy)
    torch.autograd.backward(tresnet.max_pool_mask_grad(xt), dyt)
    mask = xt.grad.numpy()
    xs = torch.from_numpy(x).requires_grad_()
    torch.autograd.backward(tresnet.max_pool_same(xs), dyt)
    return mask, xs.grad.numpy(), np.asarray(_jax_mask_grad(x, dy))


@jax.jit
def _jax_mask_grad(x, dy):
    return jax.vjp(jresnet._max_pool_mask_grad, x)[1](dy)[0]


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (1, 16, 10, 3)])
def test_mask_grad_equals_scatter_without_ties(shape):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    dy = rng.standard_normal((shape[0], shape[1] // 2, shape[2] // 2,
                              shape[3])).astype(np.float32)
    mask, scatter, jax_mask = _pool_grads(x, dy)
    np.testing.assert_allclose(mask, scatter, rtol=POOL_TOL, atol=POOL_TOL)
    np.testing.assert_allclose(mask, jax_mask, rtol=POOL_TOL, atol=POOL_TOL)


def test_mask_grad_splits_ties_like_jax():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 3, (2, 8, 10, 3)).astype(np.float32)  # many ties
    dy = rng.standard_normal((2, 4, 5, 3)).astype(np.float32)
    mask, scatter, jax_mask = _pool_grads(x, dy)
    np.testing.assert_allclose(mask, jax_mask, rtol=POOL_TOL, atol=POOL_TOL)
    assert not np.allclose(mask, scatter)  # scatter: the first max takes all
    np.testing.assert_allclose(mask.sum(), dy.sum(), rtol=1e-5)


def test_odd_dims_raise_as_in_jax():
    x = np.zeros((1, 7, 8, 2), np.float32)
    with pytest.raises(ValueError) as te:
        tresnet.max_pool_mask_grad(torch.from_numpy(x))
    with pytest.raises(ValueError) as je:
        jresnet._max_pool_mask_grad(jnp.asarray(x))
    assert str(te.value) == str(je.value)
    assert "even pool-INPUT spatial dims" in str(te.value)
    with pytest.raises(ValueError) as te:
        tresnet.space_to_depth(torch.from_numpy(x))
    with pytest.raises(ValueError) as je:
        jresnet.space_to_depth(jnp.asarray(x))
    assert str(te.value) == str(je.value)
    # 36 px: s2d gives 18, the stem pool's input stays even; 28 gives 14;
    # 30 gives an odd 15 into the pool.
    model = tresnet.ResNet(tschema.ResNetConfig(**MODEL), get_policy("fp32"),
                           device="cpu")
    with pytest.raises(ValueError, match="even pool-INPUT"):
        model(torch.zeros(1, 30, 30, 3))
