"""The recipes the serving slice runs, under the JAX package's names.

Only the sections the slice reads are kept (model, precision, serving):
the trainer, optimizer and data sections arrive with the training slice,
and the serving recipe's 2-way ``model`` mesh axis with mesh sharding
(ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses

from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
    ExperimentConfig,
    GPTConfig,
    PrecisionConfig,
)


def gpt2_medium_zero1() -> ExperimentConfig:
    """GPT-2-medium: 24 layers, d=1024, 16 heads, 50257 vocab, 1024 ctx."""
    return ExperimentConfig(
        name="gpt2_medium_zero1",
        model=GPTConfig(
            vocab_size=50257, num_layers=24, num_heads=16, hidden_dim=1024,
            seq_len=1024,
        ),
        precision=PrecisionConfig(policy="bf16_mixed"),
    )


def gpt2_medium_serve() -> ExperimentConfig:
    """The GPT-2-medium weights served through the continuous-batching
    engine with the hand-written decode kernel
    (``model.decode_attention=flash``)."""
    base = gpt2_medium_zero1()
    return base.replace(
        name="gpt2_medium_serve",
        model=dataclasses.replace(base.model, decode_attention="flash"),
    )


_RECIPES = {
    "gpt2_medium_zero1": gpt2_medium_zero1,
    "gpt2_medium_serve": gpt2_medium_serve,
}


def get_config(name: str) -> ExperimentConfig:
    if name not in _RECIPES:
        raise KeyError(
            f"unknown config {name!r}; available: {sorted(_RECIPES)}"
        )
    return _RECIPES[name]()
