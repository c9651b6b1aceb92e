"""Weights for the port's ``GPT``: carried across from the JAX package's
params, or made from a seed.

The JAX params tree (``jax.device_get`` of the flax tree: nested dicts
of numpy arrays) stacks every block leaf on a leading ``[L]`` axis:
``wte/embedding``, ``wpe``,
``blocks/{ln1,ln2}/{scale,bias}``,
``blocks/attn/{query,key,value,out}/{kernel,bias}``,
``blocks/mlp/{fc_in,fc_out}/{kernel,bias}``, ``ln_f/{scale,bias}``.
A flax ``Dense.kernel`` is ``[in, out]``; a torch ``Linear.weight`` is
``[out, in]``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from frl_distributed_ml_scaffold_tpu_torch.config.schema import GPTConfig

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
