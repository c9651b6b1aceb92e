"""The port's ResNet (frl_distributed_ml_scaffold_tpu_torch/models/
resnet.py), its weights (models/convert.py), config and data against the
JAX package, on the CPU, inputs from a numpy seed.

- Forward logits and the new ``batch_stats``, train and eval, at depth
  10 (basic blocks) and 50 (bottlenecks), 32 px, the JAX variables
  carried across with ``resnet_params_from_jax`` (BatchNorm scales,
  biases and running statistics drawn from a seed so every branch
  counts);
- flax ``SAME`` padding, with a case that symmetric padding fails;
- the converter for both flax trees (``BatchNorm_i`` and, under
  ``model.fused_bn``, ``FusedBatchNorm_i``), the seeded init, the
  recipe, ``SyntheticImages`` bit for bit, and the refusals.

Tolerances, relative to max(1, max|ref|): fp32 logits and statistics
1e-3 (convolutions summed in another order, 10-50 layers deep; at depth
50 in train mode the JAX package's own fp32 logits are 2.2e-3 from an
fp64 run of the port, 5e-4 of their scale, and the port's 4e-4);
bf16_mixed 5e-2 (the frameworks round bf16 activations at other places).
bf16_mixed is not compared at depth 50 in train mode: normalising by
the statistics of a 16-image batch, that network moves its logits by
O(1) under bf16 rounding alone, in both frameworks (measured: 2.49 for
the JAX package's and 2.60 for the port's bf16 logits against their own
fp32 ones, logits of ~4.3), so the two frameworks' roundings cannot
agree there; the training test holds bf16_mixed at depth 10.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import fused_names, jax_resnet_variables

from frl_distributed_ml_scaffold_tpu.config import recipes as jrecipes
from frl_distributed_ml_scaffold_tpu.config import schema as jschema
from frl_distributed_ml_scaffold_tpu.config.core import (
    apply_overrides as japply,
)
from frl_distributed_ml_scaffold_tpu.data.synthetic import (
    SyntheticImages as JaxSyntheticImages,
)
from frl_distributed_ml_scaffold_tpu.models.resnet import ResNet as JaxResNet
from frl_distributed_ml_scaffold_tpu.precision import get_policy as jax_policy
from frl_distributed_ml_scaffold_tpu_torch import config as tconfig
from frl_distributed_ml_scaffold_tpu_torch.config import schema as tschema
from frl_distributed_ml_scaffold_tpu_torch.data.imagenet import ImageNet
from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticImages
from frl_distributed_ml_scaffold_tpu_torch.models import create_model
from frl_distributed_ml_scaffold_tpu_torch.models import mlp as tmlp
from frl_distributed_ml_scaffold_tpu_torch.models import resnet as tresnet
from frl_distributed_ml_scaffold_tpu_torch.models import video as tvideo
from frl_distributed_ml_scaffold_tpu_torch.models import vit as tvit
from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
    init_resnet_params,
    resnet_params_from_jax,
)
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

CLASSES, IMAGE, BATCH = 10, 32, 16
TOL = {"fp32": 1e-3, "bf16_mixed": 5e-2}


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, tol, scale)


def _port(depth, policy, variables, fused=False):
    cfg = tschema.ResNetConfig(depth=depth, num_classes=CLASSES,
                               fused_bn=fused)
    model = tresnet.ResNet(cfg, get_policy(policy), device="cpu")
    params, extras = resnet_params_from_jax(variables["params"],
                                            variables["batch_stats"])
    model.load_state_dict({**params, **extras["batch_stats"]})
    return model, params, extras


@functools.lru_cache(maxsize=None)
def _variables(depth):
    return jax_resnet_variables(depth, CLASSES, IMAGE)


@pytest.mark.parametrize("depth,train,policy", [
    (10, True, "fp32"), (10, False, "fp32"), (10, True, "bf16_mixed"),
    (10, False, "bf16_mixed"), (50, True, "fp32"), (50, False, "fp32"),
    (50, False, "bf16_mixed"),
])
def test_forward_matches_jax(depth, train, policy):
    """Logits and, in train mode, the new running statistics against the
    JAX ResNet's apply."""
    variables = _variables(depth)
    x = np.random.default_rng(depth).standard_normal(
        (BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    jmodel = JaxResNet(jschema.ResNetConfig(depth=depth, num_classes=CLASSES),
                       jax_policy(policy))
    jvars = jax.tree.map(jnp.asarray, variables)
    if train:
        jlogits, jnew = jax.jit(lambda v, a: jmodel.apply(
            v, a, train=True, mutable=["batch_stats"]))(jvars, x)
    else:
        jlogits = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
            jvars, x)
    model, _, extras = _port(depth, policy, variables)
    logits, updates = model(torch.from_numpy(x), train=train)
    assert logits.dtype == torch.float32 and logits.shape == (BATCH, CLASSES)
    _close(logits, jlogits, TOL[policy], "logits")
    if not train:
        assert updates == {}
        return
    _, want = resnet_params_from_jax(variables["params"],
                                     jax.device_get(jnew["batch_stats"]))
    assert updates.keys() == want["batch_stats"].keys()
    for name, w in want["batch_stats"].items():
        _close(updates[name], w.numpy(), TOL[policy], name)
    # The forward returns the statistics; the module's buffers keep theirs.
    for name, b in model.named_buffers():
        torch.testing.assert_close(b, extras["batch_stats"][name])


def test_same_padding_is_asymmetric_like_flax():
    """flax ``SAME`` pads (2, 3) for the 7x7/s2 stem on an even input and
    (0, 1) for a 3x3/s2 convolution or pool: the port matches flax there,
    and PyTorch's symmetric ``padding=`` (same output shape, every window
    a pixel off) does not."""
    assert tresnet.same_pads(224, 7, 2) == (2, 3)
    assert tresnet.same_pads(112, 3, 2) == (0, 1)
    assert tresnet.same_pads(56, 3, 1) == (1, 1)
    assert tresnet.same_pads(56, 1, 2) == (0, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    for k, stride in ((7, 2), (3, 2)):
        conv = fnn.Conv(8, (k, k), strides=(stride, stride), padding="SAME",
                        use_bias=False)
        kernel = rng.standard_normal((k, k, 3, 8)).astype(np.float32)
        want = np.asarray(conv.apply({"params": {"kernel": kernel}}, x))
        port = tresnet.Conv(3, 8, k, stride)
        with torch.no_grad():
            port.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        got = port(torch.from_numpy(x)).detach()
        _close(got, want, 1e-5, f"conv{k}")
        sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                       port.weight.detach(), stride=stride,
                       padding=k // 2).permute(0, 2, 3, 1)
        assert sym.shape == got.shape
        assert float((sym - got).abs().max()) > 1e-2
    want = np.asarray(fnn.max_pool(x, (3, 3), strides=(2, 2),
                                   padding="SAME"))
    got = tresnet.max_pool_same(torch.from_numpy(x))
    _close(got, want, 0.0, "pool")
    sym = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2,
                       padding=1).permute(0, 2, 3, 1)
    assert sym.shape == got.shape and not torch.equal(sym, got)


@pytest.mark.parametrize("depth", [10, 50])
def test_params_from_jax_fill_every_parameter_under_both_trees(depth):
    """The converter reads the JAX tree with ``BatchNorm_i`` names and
    with ``FusedBatchNorm_i`` names alike, and fills every parameter and
    buffer of the port's model (161 leaves and 53 BatchNorms at depth
    50)."""
    v = _variables(depth)
    model = tresnet.ResNet(tschema.ResNetConfig(depth=depth,
                                                num_classes=CLASSES),
                           get_policy("fp32"), device="cpu")
    plain = resnet_params_from_jax(v["params"], v["batch_stats"])
    fused = resnet_params_from_jax(fused_names(v["params"]),
                                   fused_names(v["batch_stats"]))
    for params, extras in (plain, fused):
        assert params.keys() == dict(model.named_parameters()).keys()
        assert extras["batch_stats"].keys() == dict(
            model.named_buffers()).keys()
        for k, t in model.state_dict().items():
            got = params.get(k, extras["batch_stats"].get(k))
            assert got.shape == t.shape, k
    for a, b in zip(plain[0].values(), fused[0].values()):
        assert torch.equal(a, b)
    if depth == 50:
        assert len(plain[0]) == 161
        assert len(model.batch_norms()) == 53
        # ResNet-50's 25557032 parameters, less the Dense head's 990
        # classes beyond these 10 (2049 parameters each).
        assert sum(p.numel() for p in plain[0].values()) == (
            25557032 - 990 * 2049)


def test_init_resnet_params_follows_jax_init_distributions():
    """Seeded init: the JAX tree's shapes, LeCun-normal kernels (std
    sqrt(1 / fan_in), truncated at 2 std), zero Dense bias, BatchNorm
    scale 1 and bias 0, scale 0 on every block's last BatchNorm, running
    mean 0 and var 1."""
    cfg = tschema.ResNetConfig(depth=50, num_classes=CLASSES)
    params, extras = init_resnet_params(cfg, torch.Generator().manual_seed(0))
    v = _variables(50)
    ref, ref_extras = resnet_params_from_jax(v["params"], v["batch_stats"])
    assert {k: t.shape for k, t in params.items()} == {
        k: t.shape for k, t in ref.items()}
    assert extras["batch_stats"].keys() == ref_extras["batch_stats"].keys()
    for name, t in params.items():
        if name.endswith(".bn2.scale"):
            assert torch.equal(t, torch.zeros_like(t)), name
        elif name.endswith(".scale"):
            assert torch.equal(t, torch.ones_like(t)), name
        elif name.endswith(".bias"):
            assert torch.equal(t, torch.zeros_like(t)), name
        else:
            std = (1.0 / t[0].numel()) ** 0.5
            if t.numel() >= 4096:
                assert abs(float(t.std()) / std - 1) < 0.1, name
            assert float(t.abs().max()) <= 2 * std / 0.8796256610342398, name
    for name, s in extras["batch_stats"].items():
        want = 0.0 if name.endswith(".mean") else 1.0
        assert torch.equal(s, torch.full_like(s, want)), name


def test_recipe_and_overrides_match_jax():
    """``imagenet_rn50_ddp`` with the rn50 path's overrides means the same
    in both packages."""
    ov = ["model.fused_bn=true", "data.global_batch_size=256",
          "optimizer.name=fused_adamw", "model.stem=conv7"]
    j = japply(jrecipes.imagenet_rn50_ddp(), ov)
    t = tconfig.apply_overrides(tconfig.get_config("imagenet_rn50_ddp"), ov)
    assert t.name == j.name
    for section in ("model", "precision", "data", "trainer", "optimizer",
                    "mesh", "parallel"):
        assert dataclasses.asdict(getattr(t, section)) == (
            dataclasses.asdict(getattr(j, section))), section


def test_synthetic_images_match_jax():
    """``SyntheticImages`` batches (and ``ImageNet``'s without a
    ``data_dir``) are the JAX ones, bit for bit."""
    for split in ("train", "eval"):
        for seed in (0, 3):
            cfg = dict(name="imagenet", image_size=8, channels=3,
                       num_classes=7, shuffle_seed=seed)
            t = SyntheticImages(tschema.DataConfig(**cfg), split=split)
            j = JaxSyntheticImages(jschema.DataConfig(**cfg), split=split)
            net = ImageNet(tschema.DataConfig(**cfg), split=split)
            for step, off in ((0, 0), (5, 0), (2, 1)):
                want = j.batch(step, 3, off)
                for got in (t.batch(step, 3, off), net.batch(step, 3, off)):
                    assert got.keys() == want.keys() == {"image", "label"}
                    assert got["image"].dtype == np.float32
                    assert got["label"].dtype == np.int32
                    np.testing.assert_array_equal(got["image"],
                                                  want["image"])
                    np.testing.assert_array_equal(got["label"],
                                                  want["label"])


def test_create_model_and_refusals():
    """``create_model`` dispatches on the family (the MLP, ViT and video
    families build from their own configs); what the slice does not
    port raises, naming its ROADMAP item."""
    pol = get_policy("fp32")
    cfg = tschema.ResNetConfig(depth=10, num_classes=CLASSES)
    assert isinstance(create_model(cfg, pol, device="cpu"), tresnet.ResNet)
    if not torch.cuda.is_available():  # the entry point defaults to cuda
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model(cfg, pol)
    s2d = create_model(dataclasses.replace(cfg, stem="s2d",
                                           pool_grad="mask"), pol,
                       device="cpu")
    assert tuple(s2d.stem_s2d.weight.shape) == (64, 12, 4, 4)
    assert not hasattr(s2d, "stem_conv")
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        tresnet.ResNet(cfg, pol, param_hooks=object(), device="cpu")
    with pytest.raises(ValueError, match="stem"):
        create_model(dataclasses.replace(cfg, stem="conv9"), pol,
                     device="cpu")
    with pytest.raises(ValueError, match="pool_grad"):
        create_model(dataclasses.replace(cfg, pool_grad="nope"), pol,
                     device="cpu")
    for own, cls in ((tschema.MLPConfig(), tmlp.MLP),
                     (tschema.ViTConfig(), tvit.ViT),
                     (tschema.VideoConfig(), tvideo.VideoClassifier)):
        assert type(create_model(own, pol, device="meta")) is cls
    with pytest.raises(KeyError, match="unknown model family"):
        create_model(dataclasses.replace(cfg, family="nope"), pol)
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        ImageNet(tschema.DataConfig(name="imagenet", data_dir="/data",
                                    streaming=True), split="train")
