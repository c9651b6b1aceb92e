"""Weights for the port's ``GPT`` and ``ResNet``: carried across from
the JAX package's params, or made from a seed.

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
stem, HWIO kernel; the port's weights are OIHW), ``BatchNorm_0`` (or
``FusedBatchNorm_0`` under ``model.fused_bn``: the subclass's name), the
blocks ``BottleneckBlock_i`` / ``BasicBlock_i`` (their convolutions and
BatchNorms numbered in call order, the projection last) and ``Dense_0``.
The BatchNorm running statistics are the ``batch_stats`` collection; the
port carries them as ``extras["batch_stats"]``, keyed by the BatchNorm
modules' buffer names.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
    GPTConfig,
    ResNetConfig,
)

_DENSE = (
    ("attn", "query"), ("attn", "key"), ("attn", "value"), ("attn", "out"),
    ("mlp", "fc_in"), ("mlp", "fc_out"),
)


def params_from_jax(tree: dict, cfg: GPTConfig) -> dict[str, torch.Tensor]:
    """The JAX package's GPT params (numpy leaves) as the port's state
    dict (CPU tensors; ``load_state_dict`` moves and casts them)."""

    def t(a):
        return torch.from_numpy(np.array(a, copy=True))

    blocks = tree["blocks"]
    sd = {
        "wte.weight": t(tree["wte"]["embedding"]),
        "wpe": t(tree["wpe"]),
        "ln_f.weight": t(tree["ln_f"]["scale"]),
        "ln_f.bias": t(tree["ln_f"]["bias"]),
    }
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}."
        for ln in ("ln1", "ln2"):
            sd[pre + ln + ".weight"] = t(blocks[ln]["scale"][i])
            sd[pre + ln + ".bias"] = t(blocks[ln]["bias"][i])
        for sub, name in _DENSE:
            leaf = blocks[sub][name]
            sd[f"{pre}{sub}.{name}.weight"] = t(leaf["kernel"][i].T)
            sd[f"{pre}{sub}.{name}.bias"] = t(leaf["bias"][i])
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
        # flax variance_scaling(1, fan_in, truncated_normal): the stddev
        # is corrected for the truncation at +-2.
        std = math.sqrt(1.0 / in_f) / 0.87962566103423978
        w = torch.empty((out_f, in_f), dtype=dtype, device=dev)
        return torch.nn.init.trunc_normal_(
            w, std=std, a=-2 * std, b=2 * std, generator=generator
        )

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

    def t(a):
        return torch.from_numpy(np.array(a, copy=True))

    out, stats = {}, {}

    def bn(port: str, p_tree: dict, s_tree: dict, name: str):
        out[f"{port}.scale"] = t(p_tree[name]["scale"])
        out[f"{port}.bias"] = t(p_tree[name]["bias"])
        stats[f"{port}.mean"] = t(s_tree[name]["mean"])
        stats[f"{port}.var"] = t(s_tree[name]["var"])

    def conv(port: str, kernel):
        out[f"{port}.weight"] = t(np.transpose(kernel, (3, 2, 0, 1)))

    top_bn = _bn_prefix(params)
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
    out["head.weight"] = t(np.transpose(params["Dense_0"]["kernel"]))
    out["head.bias"] = t(params["Dense_0"]["bias"])
    return out, {"batch_stats": stats}


def init_resnet_params(cfg: ResNetConfig, generator: torch.Generator, *,
                       in_channels: int = 3, dtype=torch.float32
                       ) -> tuple[dict, dict]:
    """Seeded ``(params, extras)`` for the port's ``ResNet`` following the
    JAX model's init distributions: flax ``lecun_normal`` (truncated at
    two standard deviations, the standard deviation corrected for it;
    fan-in = kh * kw * in) for conv and Dense kernels, zero Dense bias,
    BatchNorm scale 1 and bias 0 except scale 0 on the last BatchNorm of
    every block, running mean 0 and var 1. Tensors are made on the
    generator's device. The numbers differ from the JAX init's (another
    generator); the distributions are the same."""
    from frl_distributed_ml_scaffold_tpu_torch.models.resnet import (
        BOTTLENECK,
        ResNet,
    )
    from frl_distributed_ml_scaffold_tpu_torch.precision import Policy

    dev = generator.device
    shapes = ResNet(cfg, Policy(), in_channels=in_channels, device="meta")
    last_bn = ".bn2.scale" if BOTTLENECK[cfg.depth] else ".bn1.scale"
    params = {}
    for name, p in shapes.named_parameters():
        if name.endswith(".weight") and p.dim() >= 2:  # conv and Dense
            fan_in = p[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(p.shape, dtype=dtype, device=dev)
            params[name] = torch.nn.init.trunc_normal_(
                w, std=std, a=-2 * std, b=2 * std, generator=generator)
        elif name.endswith(".scale") and not name.endswith(last_bn):
            params[name] = torch.ones(p.shape, dtype=dtype, device=dev)
        else:  # biases, and the zero-initialised last BatchNorm scales
            params[name] = torch.zeros(p.shape, dtype=dtype, device=dev)
    stats = {name: (torch.zeros if name.endswith(".mean") else torch.ones)(
                 b.shape, dtype=torch.float32, device=dev)
             for name, b in shapes.named_buffers()}
    return params, {"batch_stats": stats}
