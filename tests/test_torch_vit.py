"""The port's ViT (frl_distributed_ml_scaffold_tpu_torch/models/vit.py),
its weights (models/convert.py), recipe, ``example_input`` and training
step against the JAX package, on the CPU, inputs from a numpy seed.

A tiny ViT cut from ``imagenet_vitb_fsdp`` by the same overrides in both
packages (32 px, patch 8, D = 64, 2 layers, 4 heads, 10 classes); the
JAX init's params, every bias, LayerNorm scale and the cls token moved
by 0.1 N(0, 1), carried across with ``vit_params_from_jax``; batches of
8 synthetic ImageNet images.

- Logits, ``pool=cls`` and ``pool=mean``, fp32 and bf16_mixed.
- Three ``make_train_step`` steps against the JAX step under the
  recipe's AdamW (weight decay 0.3), global-norm clip 1.0, warmup into a
  cosine and ``remat=full``, fp32 and bf16_mixed.
- The converter fills every parameter; the seeded init follows the JAX
  init's distributions; ``example_input``; the refusals.

Tolerances (``_torch_parity.LOGIT_TOL`` / ``TRAIN_TOL``, shared with
test_torch_video_mlp.py), set from the largest difference measured here:
- logits, relative to max(1, max|ref|): fp32 1e-5 (measured 3.9e-7);
  bf16_mixed 3e-2 (measured 1.0e-2). Under bf16 the two frameworks round
  at other places (the softmax, the fused bias adds, GELU); the JAX
  package's own bf16 logits lie 6.1e-3 from its fp32 ones here.
- train steps, fp32: loss and grad_norm 3e-5 relative (measured 1.8e-6
  and 2.8e-6), accuracies equal, params 1e-5 absolute (measured 2.1e-6),
  their mean 1e-6 (3.8e-8). bf16_mixed: loss and grad_norm 2e-2
  relative (measured 5.3e-3 and 5.8e-3, both at the third step, after
  two Adam steps from params that rounding already moved apart); params
  within Adam's bound, twice the summed lr (measured 43 % of it), their
  mean within 5 % of it (measured 0.6 %).
- Adam's early steps are about lr sign(g): a gradient within rounding of
  0 moves a param by up to lr one way in one framework and the other way
  in the other. The key projection's bias has an exact gradient of 0
  (the softmax ignores a per-query constant), so under both policies that
  leaf is held only to Adam's bound (measured 2 % of it in fp32, 92 %
  under bf16_mixed).

Seconds on the CPU, run alone: see CHANGES.md.
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

from _jit import jit_init
from _torch_parity import (
    LOGIT_TOL,
    TRAIN_TOL,
    TINY_TRAIN,
    TINY_VIDEO,
    TINY_VIT,
    hold_train,
    jax_init_perturbed,
    jax_train,
    port_train,
    recipe_pair,
)

from frl_distributed_ml_scaffold_tpu.models.vit import ViT as JaxViT
from frl_distributed_ml_scaffold_tpu.precision import get_policy as jax_policy
from frl_distributed_ml_scaffold_tpu.trainer import tasks as jtasks
from frl_distributed_ml_scaffold_tpu_torch.config import schema as tschema
from frl_distributed_ml_scaffold_tpu_torch.data.imagenet import ImageNet
from frl_distributed_ml_scaffold_tpu_torch.models import create_model
from frl_distributed_ml_scaffold_tpu_torch.models import vit as tvit
from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
    init_vit_params,
    vit_params_from_jax,
)
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
from frl_distributed_ml_scaffold_tpu_torch.trainer import tasks as ttasks

BATCH, STEPS = 8, 3


def _configs(pool: str = "cls", policy: str = "bf16_mixed"):
    return recipe_pair("imagenet_vitb_fsdp", TINY_VIT + TINY_TRAIN + [
        f"model.pool={pool}", f"data.global_batch_size={BATCH}",
        f"precision.policy={policy}"])


@functools.lru_cache(maxsize=None)
def _params(pool: str) -> dict:
    j, _ = _configs(pool)
    return jax_init_perturbed(JaxViT(j.model, jax_policy("fp32")),
                              np.zeros((1, 32, 32, 3), np.float32))


def _batches(cfg, n: int = STEPS) -> list:
    data = ImageNet(cfg.data, split="train")
    return [data.batch(s, BATCH) for s in range(n)]


@pytest.mark.parametrize("policy", ["fp32", "bf16_mixed"])
@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_logits_match_jax(pool, policy):
    j, t = _configs(pool, policy)
    params = _params(pool)
    x = _batches(t, 1)[0]["image"]
    jmodel = JaxViT(j.model, jax_policy(policy))
    want = np.asarray(jax.jit(
        lambda p, x: jmodel.apply({"params": p}, x))(params, x))
    model = create_model(t.model, get_policy(policy), device="cpu")
    model.load_state_dict(vit_params_from_jax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (BATCH, 10)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= LOGIT_TOL[policy] * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("policy", ["fp32", "bf16_mixed"])
def test_train_steps_match_jax(policy):
    """Three steps of the recipe's optimizer under ``remat=full``: loss,
    accuracy, grad_norm and lr per step, every param after the last."""
    j, t = _configs("cls", policy)
    assert t.trainer.remat == "full" and t.optimizer.grad_clip_norm == 1.0
    params, batches = _params("cls"), _batches(t)
    ref = jax_train(j, JaxViT(j.model, jax_policy(policy)), params, batches)
    ref["params"] = vit_params_from_jax(ref["params"])
    model = create_model(t.model, get_policy(policy), device="cpu")
    got = port_train(t, model, vit_params_from_jax(params), batches)
    assert ref["lr"][0] == 0.0 and got["state"].step == STEPS
    hold_train(got, ref, **TRAIN_TOL[policy])


def test_converter_fills_every_parameter():
    """``vit_params_from_jax`` gives every parameter of the port's model
    its flax leaf: the keys are the model's, every element is carried,
    and the heads are flattened head-major."""
    for pool in ("cls", "mean"):
        _, t = _configs(pool)
        params = _params(pool)
        sd = vit_params_from_jax(params)
        model = create_model(t.model, get_policy("fp32"), device="cpu")
        assert sd.keys() == model.state_dict().keys()
        model.load_state_dict(sd)
        assert sum(v.numel() for v in sd.values()) == sum(
            np.size(v) for v in jax.tree.leaves(params))
        assert ("cls_token" in sd) == (pool == "cls")
    attn = params["EncoderBlock_1"]["MultiHeadDotProductAttention_0"]
    q = sd["blocks.1.attn.query.weight"].view(4, 16, 64)  # [H, hd, D]
    np.testing.assert_array_equal(q.numpy(),
                                  attn["query"]["kernel"].transpose(1, 2, 0))
    out = sd["blocks.1.attn.out.weight"].view(64, 4, 16)  # [D, H, hd]
    np.testing.assert_array_equal(out.numpy(),
                                  attn["out"]["kernel"].transpose(2, 0, 1))
    conv = params["Conv_0"]["kernel"]  # (p, p, C, D)
    np.testing.assert_array_equal(sd["embed.weight"].view(64, 8, 8, 3).numpy(),
                                  conv.transpose(3, 0, 1, 2))


def test_patchify_is_the_strided_convolution():
    """``patchify`` and a product equal the stride-equals-kernel
    convolution, with the tokens row-major over the patch grid, and a
    remainder that no patch covers dropped (flax ``VALID``)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 19, 21, 3)).astype(np.float64))
    w = torch.from_numpy(rng.standard_normal((5, 3, 4, 4)))  # OIHW
    conv = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, stride=4)
    want = conv.permute(0, 2, 3, 1).reshape(2, 4 * 5, 5)
    got = tvit.patchify(x, (4, 4)) @ w.permute(2, 3, 1, 0).reshape(48, 5)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_init_follows_the_jax_init():
    """``init_vit_params``: the JAX init's shapes (in the port's names),
    zero biases and cls token, unit LayerNorm scales, normal(0.02)
    position embeddings, and lecun-normal kernels truncated at two
    standard deviations, whose spread matches the JAX init's."""
    j, t = _configs()
    ref = vit_params_from_jax(jax.device_get(jit_init(
        JaxViT(j.model, jax_policy("fp32")),
        jnp.zeros((1, 32, 32, 3)))["params"]))
    sd = init_vit_params(t.model, torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in sd.items()} == {
        k: v.shape for k, v in ref.items()}
    for name, v in sd.items():
        if name == "pos_embedding":
            assert abs(float(v.std()) / 0.02 - 1) < 0.1
        elif name == "cls_token" or name.endswith(".bias"):
            assert torch.equal(v, torch.zeros_like(v)), name
        elif v.dim() == 1:
            assert torch.equal(v, torch.ones_like(v)), name
        else:
            std = (1.0 / v.shape[1]) ** 0.5
            assert float(v.abs().max()) <= 2 * std / 0.8796256610342398, name
            if v.numel() >= 4096:
                assert abs(float(v.std()) / std - 1) < 0.1, name
                assert abs(float(v.std()) / float(ref[name].std()) - 1) < 0.1


@pytest.mark.parametrize("name, overrides", [
    ("imagenet_vitb_fsdp", TINY_VIT + ["model.pool=mean"]),
    ("ego4d_video_elastic", TINY_VIDEO),
    ("mnist_mlp", ["model.hidden_sizes=(64,32)", "data.data_dir=null"]),
])
def test_recipes_and_overrides_match_jax(name, overrides):
    """The three recipes, as published and under overrides (tuple fields
    among them), mean the same in both packages: every section the port
    reads."""
    for ov in ([], overrides + TINY_TRAIN + ["precision.policy=fp32"]):
        j, t = recipe_pair(name, ov)
        assert t.name == j.name == name
        for section in ("model", "precision", "data", "trainer",
                        "optimizer", "mesh", "parallel", "serving"):
            assert dataclasses.asdict(getattr(t, section)) == (
                dataclasses.asdict(getattr(j, section))), section


@pytest.mark.parametrize("name", ["imagenet", "mnist", "video_synthetic",
                                  "lm_synthetic"])
def test_example_input_matches_jax(name):
    cfg = dict(name=name, image_size=12, channels=3, num_frames=4,
               seq_len=16)
    from frl_distributed_ml_scaffold_tpu.config import schema as jschema

    want = jtasks.example_input(jschema.DataConfig(**cfg), None, 2)
    got = ttasks.example_input(tschema.DataConfig(**cfg), None, 2)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert not got[k].any()
    with pytest.raises(KeyError, match="no example input"):
        ttasks.example_input(tschema.DataConfig(name="nope"), None)


def test_refusals():
    """The tensor-parallel hooks and an unknown pool raise; the hooks
    name ROADMAP A11. Training dropout runs with a seed and
    raises without one; eval ignores it."""
    _, t = _configs()
    pol = get_policy("fp32")
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        tvit.ViT(t.model, pol, tp_overlap=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        tvit.EncoderBlock(64, 4, 4, pol, "cpu", tp=object())
    with pytest.raises(ValueError, match="pool"):
        tvit.ViT(dataclasses.replace(t.model, pool="max"), pol, device="cpu")
    model = tvit.ViT(dataclasses.replace(t.model, dropout=0.1), pol,
                     device="cpu")
    model.load_state_dict(init_vit_params(t.model, torch.Generator()))
    x = torch.zeros(1, 32, 32, 3)
    assert tuple(model(x).shape) == (1, 10)  # eval: dropout is a no-op
    with pytest.raises(ValueError, match="needs a seed"):
        model(x, train=True)
    assert tuple(model(x, train=True, rng=0).shape) == (1, 10)
