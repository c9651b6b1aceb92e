"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

One tiny GPT config (2 layers, d=128, 4 heads so head_dim is 32 and the
JAX decode kernel really runs, vocab 512, 128 context), initialised ONCE
in the JAX package and carried into the port with ``params_from_jax``.
"""

from __future__ import annotations

import contextlib
import importlib

import jax
import jax.numpy as jnp

from _jit import jit_init

from frl_distributed_ml_scaffold_tpu.config.schema import GPTConfig as JaxGPTConfig
from frl_distributed_ml_scaffold_tpu.models.gpt import GPT as JaxGPT
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


def build_pair(params, policy: str):
    """(JAX GPT, port GPT on the CPU carrying ``params``) under ``policy``."""
    jmodel = JaxGPT(JaxGPTConfig(**TINY), jax_policy(policy))
    cfg = GPTConfig(**TINY)
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
