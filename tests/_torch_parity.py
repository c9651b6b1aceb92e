"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

One tiny GPT config (2 layers, d=128, 4 heads so head_dim is 32 and the
JAX decode kernel really runs, vocab 512, 128 context), initialised ONCE
in the JAX package and carried into the port with ``params_from_jax``;
and the JAX ResNet's variables, carried across with
``resnet_params_from_jax``.
"""

from __future__ import annotations

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np

from _jit import jit_init

from frl_distributed_ml_scaffold_tpu.config.schema import GPTConfig as JaxGPTConfig
from frl_distributed_ml_scaffold_tpu.config.schema import (
    ResNetConfig as JaxResNetConfig,
)
from frl_distributed_ml_scaffold_tpu.models.gpt import GPT as JaxGPT
from frl_distributed_ml_scaffold_tpu.models.resnet import ResNet as JaxResNet
from frl_distributed_ml_scaffold_tpu.precision import get_policy as jax_policy
from frl_distributed_ml_scaffold_tpu_torch.config.schema import GPTConfig
from frl_distributed_ml_scaffold_tpu_torch.models.convert import params_from_jax
from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

TINY = dict(
    vocab_size=512, num_layers=2, num_heads=4, hidden_dim=128, seq_len=128,
)

jax_decode_attention = importlib.import_module(
    "frl_distributed_ml_scaffold_tpu.ops.decode_attention"
)


def jax_params():
    """The JAX model's params (numpy leaves; fp32 under every policy)."""
    model = JaxGPT(JaxGPTConfig(**TINY), jax_policy("fp32"))
    variables = jit_init(model, jnp.zeros((1, 8), jnp.int32), train=False)
    return jax.device_get(variables["params"])


def build_pair(params, policy: str, **model):
    """(JAX GPT, port GPT on the CPU carrying ``params``) under ``policy``;
    ``model`` overrides fields of both configs (``kv_cache_quant=...``)."""
    jmodel = JaxGPT(JaxGPTConfig(**TINY, **model), jax_policy(policy))
    cfg = GPTConfig(**TINY, **model)
    tmodel = GPT(cfg, get_policy(policy), device="cpu")
    tmodel.load_state_dict(params_from_jax(params, cfg))
    return jmodel, tmodel


@contextlib.contextmanager
def pallas_interpret():
    """Route the JAX package's decode attention through its Pallas kernel
    in interpret mode (its own tests' hook)."""
    jax_decode_attention.FORCE_INTERPRET = True
    try:
        yield
    finally:
        jax_decode_attention.FORCE_INTERPRET = None


def jax_resnet_variables(depth: int, num_classes: int, image: int,
                         seed: int = 0, spread: float | None = 0.3) -> dict:
    """The JAX ResNet's variables (numpy leaves, fp32, ``model.fused_bn``
    off). Unless ``spread`` is None, every BatchNorm's scale (1 + spread
    N(0, 1)), bias and running mean (spread / 3 N(0, 1)) and running var
    (U(0.5, 1.5)) are drawn from a numpy seed: the init's zero scale on
    each block's last BatchNorm would leave every residual branch out of
    a forward comparison."""
    model = JaxResNet(JaxResNetConfig(depth=depth, num_classes=num_classes),
                      jax_policy("fp32"))
    variables = jax.device_get(jit_init(
        model, jnp.zeros((1, image, image, 3), jnp.float32), train=False))
    rng = np.random.default_rng(seed)

    def perturb(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = perturb(v)
            elif k == "scale":
                out[k] = (1 + spread * rng.standard_normal(v.shape)).astype(
                    np.float32)
            elif k in ("bias", "mean"):
                out[k] = (spread / 3 * rng.standard_normal(v.shape)).astype(
                    np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    if spread is None:
        return jax.tree.map(np.asarray, dict(variables))
    return {"params": perturb(variables["params"]),
            "batch_stats": perturb(variables["batch_stats"])}


def fused_names(tree):
    """A ResNet tree with flax's ``BatchNorm_i`` module names as
    ``FusedBatchNorm_i``, the names the JAX model gives them under
    ``model.fused_bn``."""
    if not isinstance(tree, dict):
        return tree
    return {(f"Fused{k}" if k.startswith("BatchNorm_") else k): fused_names(v)
            for k, v in tree.items()}
