"""Weights for the port's models: carried across from the JAX package's
params, or made from a seed on the card (which has no JAX) with the JAX
inits' distributions.

GPT:

The JAX params tree (``jax.device_get`` of the flax tree: nested dicts
of numpy arrays) stacks every block leaf on a leading ``[L]`` axis:
``wte/embedding``, ``wpe``,
``blocks/{ln1,ln2}/{scale,bias}``,
``blocks/attn/{query,key,value,out}/{kernel,bias}``,
``blocks/mlp/{fc_in,fc_out}/{kernel,bias}``, ``ln_f/{scale,bias}``.
A flax ``Dense.kernel`` is ``[in, out]``; a torch ``Linear.weight`` is
``[out, in]``.

ResNet: the flax tree names modules by class and order: ``Conv_0`` (the
stem, HWIO kernel; the port's weights are OIHW; ``stem_s2d`` under
``model.stem=s2d``, a (4, 4, 12, F) kernel), ``BatchNorm_0`` (or
``FusedBatchNorm_0`` under ``model.fused_bn``: the subclass's name), the
blocks ``BottleneckBlock_i`` / ``BasicBlock_i`` (their convolutions and
BatchNorms numbered in call order, the projection last) and ``Dense_0``.
The BatchNorm running statistics are the ``batch_stats`` collection; the
port carries them as ``extras["batch_stats"]``, keyed by the BatchNorm
modules' buffer names.

ViT and the video classifier (``models/vit.py``, ``models/video.py``):
``Conv_0{kernel (p, p, C, D) or (t, h, w, C, D), bias}`` becomes the
``embed`` Linear (the kernel flattened over everything but D, the order
``patchify`` flattens a patch in), ``cls_token (1, 1, D)`` (ViT with
``pool=cls``) and ``pos_embedding (1, N, D)`` stay as they are;
``EncoderBlock_i{LayerNorm_0, MultiHeadDotProductAttention_0{query, key,
value: kernel (D, H, hd), bias (H, hd); out: kernel (H, hd, D), bias
(D)}, LayerNorm_1, MlpBlock_0{Dense_0, Dense_1}}`` becomes ``blocks.i``
``{ln1, attn.{query,key,value,out}, ln2, mlp.{fc_in,fc_out}}`` with the
heads flattened; the final ``LayerNorm_0`` and ``Dense_0`` become ``ln``
and ``head``. MLP: ``Dense_i`` becomes ``dense.i``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
    GPTConfig,
    MLPConfig,
    ResNetConfig,
    VideoConfig,
    ViTConfig,
)
from frl_distributed_ml_scaffold_tpu_torch.precision import Policy

# flax variance_scaling(1, fan_in, truncated_normal) divides the standard
# deviation by this, the std of a unit normal truncated at +-2.
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(shape, fan_in: int, generator: torch.Generator, dtype):
    """flax ``lecun_normal``: truncated at two standard deviations, the
    standard deviation corrected for the truncation."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(shape, dtype=dtype, device=generator.device)
    return torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                       generator=generator)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


_DENSE = (
    ("attn", "query"), ("attn", "key"), ("attn", "value"), ("attn", "out"),
    ("mlp", "fc_in"), ("mlp", "fc_out"),
)


def params_from_jax(tree: dict, cfg: GPTConfig) -> dict[str, torch.Tensor]:
    """The JAX package's GPT params (numpy leaves) as the port's state
    dict (CPU tensors; ``load_state_dict`` moves and casts them)."""

    blocks = tree["blocks"]
    sd = {
        "wte.weight": _t(tree["wte"]["embedding"]),
        "wpe": _t(tree["wpe"]),
        "ln_f.weight": _t(tree["ln_f"]["scale"]),
        "ln_f.bias": _t(tree["ln_f"]["bias"]),
    }
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}."
        for ln in ("ln1", "ln2"):
            sd[pre + ln + ".weight"] = _t(blocks[ln]["scale"][i])
            sd[pre + ln + ".bias"] = _t(blocks[ln]["bias"][i])
        for sub, name in _DENSE:
            leaf = blocks[sub][name]
            sd[f"{pre}{sub}.{name}.weight"] = _t(leaf["kernel"][i].T)
            sd[f"{pre}{sub}.{name}.bias"] = _t(leaf["bias"][i])
    return sd


def init_params(
    cfg: GPTConfig, generator: torch.Generator, dtype=torch.float32
) -> dict[str, torch.Tensor]:
    """A seeded state dict following the JAX model's init distributions:
    normal(0.02) for ``wte``/``wpe``, LeCun-normal (truncated at two
    standard deviations, flax's ``lecun_normal``) for Dense kernels, zero
    biases, unit LayerNorm scales. Tensors are made on the generator's
    device. The numbers differ from the JAX init's (another generator);
    the distributions are the same."""
    dev = generator.device
    d, f = cfg.hidden_dim, cfg.hidden_dim * cfg.mlp_ratio

    def normal(shape, std):
        w = torch.empty(shape, dtype=dtype, device=dev)
        return torch.nn.init.normal_(w, std=std, generator=generator)

    def lecun(out_f, in_f):
        return _lecun_normal((out_f, in_f), in_f, generator, dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=dev)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    sd = {
        "wte.weight": normal((cfg.vocab_size, d), 0.02),
        "wpe": normal((cfg.seq_len, d), 0.02),
        "ln_f.weight": ones(d),
        "ln_f.bias": zeros(d),
    }
    shapes = {
        "query": (d, d), "key": (d, d), "value": (d, d), "out": (d, d),
        "fc_in": (f, d), "fc_out": (d, f),
    }
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}."
        for ln in ("ln1", "ln2"):
            sd[pre + ln + ".weight"] = ones(d)
            sd[pre + ln + ".bias"] = zeros(d)
        for sub, name in _DENSE:
            out_f, in_f = shapes[name]
            sd[f"{pre}{sub}.{name}.weight"] = lecun(out_f, in_f)
            sd[f"{pre}{sub}.{name}.bias"] = zeros(out_f)
    return sd


# The port's convolutions and BatchNorms of one block, in the flax
# block's call order (``Conv_i`` / ``BatchNorm_i``).
_BLOCK_LAYERS = {
    "BottleneckBlock": (("conv0", "bn0"), ("conv1", "bn1"), ("conv2", "bn2"),
                        ("proj_conv", "proj_bn")),
    "BasicBlock": (("conv0", "bn0"), ("conv1", "bn1"),
                   ("proj_conv", "proj_bn")),
}


def _bn_prefix(tree: dict) -> str:
    return "FusedBatchNorm" if any(k.startswith("FusedBatchNorm")
                                   for k in tree) else "BatchNorm"


def resnet_params_from_jax(params: dict, batch_stats: dict
                           ) -> tuple[dict, dict]:
    """The JAX package's ResNet ``params`` and ``batch_stats`` (numpy
    leaves) as the port's ``(params, extras)``: params by the port's
    parameter names, ``extras = {"batch_stats": {buffer name: tensor}}``
    (CPU tensors)."""

    out, stats = {}, {}

    def bn(port: str, p_tree: dict, s_tree: dict, name: str):
        out[f"{port}.scale"] = _t(p_tree[name]["scale"])
        out[f"{port}.bias"] = _t(p_tree[name]["bias"])
        stats[f"{port}.mean"] = _t(s_tree[name]["mean"])
        stats[f"{port}.var"] = _t(s_tree[name]["var"])

    def conv(port: str, kernel):
        out[f"{port}.weight"] = _t(np.transpose(kernel, (3, 2, 0, 1)))

    top_bn = _bn_prefix(params)
    if "stem_s2d" in params:
        conv("stem_s2d", params["stem_s2d"]["kernel"])
    else:
        conv("stem_conv", params["Conv_0"]["kernel"])
    bn("stem_bn", params, batch_stats, f"{top_bn}_0")
    blocks = sorted(
        (k for k in params if k.split("_")[0] in _BLOCK_LAYERS),
        key=lambda k: int(k.rsplit("_", 1)[1]))
    for i, key in enumerate(blocks):
        p_tree, s_tree = params[key], batch_stats[key]
        layers = _BLOCK_LAYERS[key.rsplit("_", 1)[0]]
        n = sum(k.startswith("Conv_") for k in p_tree)
        prefix = _bn_prefix(p_tree)
        for j, (c_name, b_name) in enumerate(layers[:n]):
            conv(f"blocks.{i}.{c_name}", p_tree[f"Conv_{j}"]["kernel"])
            bn(f"blocks.{i}.{b_name}", p_tree, s_tree, f"{prefix}_{j}")
    out["head.weight"] = _t(np.transpose(params["Dense_0"]["kernel"]))
    out["head.bias"] = _t(params["Dense_0"]["bias"])
    return out, {"batch_stats": stats}


def init_resnet_params(cfg: ResNetConfig, generator: torch.Generator, *,
                       in_channels: int = 3, dtype=torch.float32
                       ) -> tuple[dict, dict]:
    """Seeded ``(params, extras)`` for the port's ``ResNet`` following the
    JAX model's init distributions: flax ``lecun_normal`` (truncated at
    two standard deviations, the standard deviation corrected for it;
    fan-in = kh * kw * in, 4 * 4 * 12 for the s2d stem) for conv and
    Dense kernels, zero Dense bias,
    BatchNorm scale 1 and bias 0 except scale 0 on the last BatchNorm of
    every block, running mean 0 and var 1. Tensors are made on the
    generator's device. The numbers differ from the JAX init's (another
    generator); the distributions are the same."""
    from frl_distributed_ml_scaffold_tpu_torch.models.resnet import (
        BOTTLENECK,
        ResNet,
    )

    dev = generator.device
    shapes = ResNet(cfg, Policy(), in_channels=in_channels, device="meta")
    last_bn = ".bn2.scale" if BOTTLENECK[cfg.depth] else ".bn1.scale"
    params = {}
    for name, p in shapes.named_parameters():
        if name.endswith(".weight") and p.dim() >= 2:  # conv and Dense
            params[name] = _lecun_normal(p.shape, p[0].numel(), generator,
                                         dtype)
        elif name.endswith(".scale") and not name.endswith(last_bn):
            params[name] = torch.ones(p.shape, dtype=dtype, device=dev)
        else:  # biases, and the zero-initialised last BatchNorm scales
            params[name] = torch.zeros(p.shape, dtype=dtype, device=dev)
    stats = {name: (torch.zeros if name.endswith(".mean") else torch.ones)(
                 b.shape, dtype=torch.float32, device=dev)
             for name, b in shapes.named_buffers()}
    return params, {"batch_stats": stats}


def s2d_stem_weights(w7: torch.Tensor) -> torch.Tensor:
    """The exact rewrite of a 7x7 stride-2 SAME stem kernel (F, C, 7, 7)
    as the 4x4 stride-1 kernel (F, 4C, 4, 4) over space-to-depth(2)
    input (the JAX package's ``s2d_stem_weights``, in OIHW).

    SAME pads (2, 3) for k=7, s=2, so output pixel x reads input
    a = 2x + i - 2, i in [0, 7). In s2d coordinates a = 2u + di with
    u = x + k - 1 (SAME pads (1, 2) for k=4, s=1), so i = 2k + di: the 7x7
    taps relabel one to one onto (k, di), and (3, 1) (i = 7) stays 0."""
    f, c, k7, _ = w7.shape
    if k7 != 7:
        raise ValueError(f"expected a 7x7 stem kernel, got {tuple(w7.shape)}")
    w4 = w7.new_zeros((f, 4 * c, 4, 4))
    for kh in range(4):
        for dh in range(2):
            ih = 2 * kh + dh
            if ih >= 7:
                continue
            for kw in range(4):
                for dw in range(2):
                    iw = 2 * kw + dw
                    if iw >= 7:
                        continue
                    ch = (dh * 2 + dw) * c
                    w4[:, ch: ch + c, kh, kw] = w7[:, :, ih, iw]
    return w4


def _dense(sd: dict, port: str, leaf: dict) -> None:
    sd[port + ".weight"] = _t(np.transpose(leaf["kernel"]))
    sd[port + ".bias"] = _t(leaf["bias"])


def _numbered(tree: dict, prefix: str) -> list[str]:
    """``tree``'s keys ``<prefix>_<i>`` in order of i."""
    return sorted((k for k in tree if k.rsplit("_", 1)[0] == prefix),
                  key=lambda k: int(k.rsplit("_", 1)[1]))


def mlp_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The JAX package's MLP params (numpy leaves) as the port's state
    dict (CPU tensors)."""
    sd: dict[str, torch.Tensor] = {}
    for i, key in enumerate(_numbered(tree, "Dense")):
        _dense(sd, f"dense.{i}", tree[key])
    return sd


def vit_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The JAX package's ViT params (numpy leaves) as the port's state
    dict (CPU tensors)."""
    kernel = np.asarray(tree["Conv_0"]["kernel"])
    sd = {"embed.weight": _t(kernel.reshape(-1, kernel.shape[-1]).T),
          "embed.bias": _t(tree["Conv_0"]["bias"]),
          "pos_embedding": _t(tree["pos_embedding"])}
    if "cls_token" in tree:
        sd["cls_token"] = _t(tree["cls_token"])

    def ln(port: str, leaf: dict):
        sd[port + ".weight"] = _t(leaf["scale"])
        sd[port + ".bias"] = _t(leaf["bias"])

    for i, key in enumerate(_numbered(tree, "EncoderBlock")):
        block, pre = tree[key], f"blocks.{i}."
        ln(pre + "ln1", block["LayerNorm_0"])
        ln(pre + "ln2", block["LayerNorm_1"])
        attn = block["MultiHeadDotProductAttention_0"]
        for name in ("query", "key", "value"):
            k = np.asarray(attn[name]["kernel"])  # (D, H, hd)
            sd[f"{pre}attn.{name}.weight"] = _t(k.reshape(k.shape[0], -1).T)
            sd[f"{pre}attn.{name}.bias"] = _t(np.reshape(attn[name]["bias"],
                                                         -1))
        k = np.asarray(attn["out"]["kernel"])  # (H, hd, D)
        sd[pre + "attn.out.weight"] = _t(k.reshape(-1, k.shape[-1]).T)
        sd[pre + "attn.out.bias"] = _t(attn["out"]["bias"])
        _dense(sd, pre + "mlp.fc_in", block["MlpBlock_0"]["Dense_0"])
        _dense(sd, pre + "mlp.fc_out", block["MlpBlock_0"]["Dense_1"])
    ln("ln", tree["LayerNorm_0"])
    _dense(sd, "head", tree["Dense_0"])
    return sd


# The video classifier's tree is the ViT's without ``cls_token``, its
# ``Conv_0`` kernel five-dimensional.
video_params_from_jax = vit_params_from_jax


def _init_like(model: torch.nn.Module, generator: torch.Generator,
               dtype) -> dict[str, torch.Tensor]:
    """A seeded state dict for ``model`` (built on the meta device) with
    the flax inits of the ViT, video and MLP models: ``lecun_normal``
    for every Dense and embedding kernel (fan-in: the weight's second
    dim), zero biases and cls token, unit LayerNorm scales, normal(0.02)
    position embeddings. Tensors are made on the generator's device."""
    dev = generator.device
    sd = {}
    for name, p in model.named_parameters():
        if name == "pos_embedding":
            w = torch.empty(p.shape, dtype=dtype, device=dev)
            sd[name] = torch.nn.init.normal_(w, std=0.02, generator=generator)
        elif name == "cls_token" or name.endswith(".bias"):
            sd[name] = torch.zeros(p.shape, dtype=dtype, device=dev)
        elif p.dim() == 1:  # LayerNorm scales
            sd[name] = torch.ones(p.shape, dtype=dtype, device=dev)
        else:
            sd[name] = _lecun_normal(p.shape, p.shape[1], generator, dtype)
    return sd


def init_mlp_params(cfg: MLPConfig, generator: torch.Generator, *,
                    in_features: int = 784, dtype=torch.float32) -> dict:
    """Seeded weights for the port's ``MLP`` (``_init_like``). The
    numbers differ from the JAX init's (another generator); the
    distributions are the same."""
    from frl_distributed_ml_scaffold_tpu_torch.models.mlp import MLP

    return _init_like(MLP(cfg, Policy(), in_features=in_features,
                          device="meta"), generator, dtype)


def init_vit_params(cfg: ViTConfig, generator: torch.Generator, *,
                    in_channels: int = 3, dtype=torch.float32) -> dict:
    """Seeded weights for the port's ``ViT`` (``_init_like``), as
    ``init_mlp_params``."""
    from frl_distributed_ml_scaffold_tpu_torch.models.vit import ViT

    return _init_like(ViT(cfg, Policy(), in_channels=in_channels,
                          device="meta"), generator, dtype)


def init_video_params(cfg: VideoConfig, generator: torch.Generator, *,
                      in_channels: int = 3, dtype=torch.float32) -> dict:
    """Seeded weights for the port's ``VideoClassifier``
    (``_init_like``), as ``init_mlp_params``."""
    from frl_distributed_ml_scaffold_tpu_torch.models.video import (
        VideoClassifier,
    )

    return _init_like(VideoClassifier(cfg, Policy(), in_channels=in_channels,
                                      device="meta"), generator, dtype)
