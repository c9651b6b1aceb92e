"""The recipes the port runs, under the JAX package's names: GPT-2
serving and training, and ResNet-50 training.

Every section the port reads is kept (model, data, trainer, optimizer,
mesh, parallel, precision, serving), with the JAX recipe's values. The
mesh sections name the JAX recipes' multi-device layouts; the port runs
them on one card, where ``zero1`` and ``fsdp=-1`` are the replicated
layout (ROADMAP queue A item 7 brings meshes of more than one card).
"""

from __future__ import annotations

import dataclasses

from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
    DataConfig,
    ExperimentConfig,
    GPTConfig,
    MeshConfig,
    OptimizerConfig,
    ParallelConfig,
    PrecisionConfig,
    ResNetConfig,
    TrainerConfig,
)


def gpt2_medium_zero1() -> ExperimentConfig:
    """GPT-2-medium LM: 24 layers, d=1024, 16 heads, 50257 vocab, 1024
    ctx; global batch 64 in 8 microbatches, dots remat, AdamW with a
    cosine schedule and a global-norm clip, ZeRO-1 optimizer sharding."""
    return ExperimentConfig(
        name="gpt2_medium_zero1",
        model=GPTConfig(
            vocab_size=50257, num_layers=24, num_heads=16, hidden_dim=1024,
            seq_len=1024,
        ),
        data=DataConfig(
            name="lm_synthetic", global_batch_size=64, seq_len=1024,
            vocab_size=50257,
        ),
        trainer=TrainerConfig(
            total_steps=100000, grad_accum=8, remat="dots", log_every=50
        ),
        optimizer=OptimizerConfig(
            name="adamw", learning_rate=3e-4, weight_decay=0.1, b2=0.95,
            schedule="cosine", warmup_steps=2000, grad_clip_norm=1.0,
        ),
        mesh=MeshConfig(data=1, fsdp=-1),
        parallel=ParallelConfig(
            param_sharding="replicated", opt_sharding="zero1"
        ),
        precision=PrecisionConfig(policy="bf16_mixed"),
    )


def gpt2_medium_serve() -> ExperimentConfig:
    """The GPT-2-medium weights served through the continuous-batching
    engine with the hand-written decode kernel
    (``model.decode_attention=flash``). The JAX recipe's 2-way ``model``
    axis is kept in the config; the port serves on one card."""
    base = gpt2_medium_zero1()
    return base.replace(
        name="gpt2_medium_serve",
        model=dataclasses.replace(base.model, decode_attention="flash"),
        mesh=MeshConfig(data=-1, fsdp=1, model=2),
        parallel=ParallelConfig(param_sharding="replicated"),
    )


def gpt2_long() -> ExperimentConfig:
    """Long context on one device: 8k tokens through the flash kernels,
    the chunked-vocab loss and full remat."""
    base = gpt2_medium_zero1()
    return base.replace(
        name="gpt2_long",
        model=GPTConfig(
            vocab_size=50257, num_layers=24, num_heads=16, hidden_dim=1024,
            seq_len=8192, attention="flash", lm_loss_chunk=256,
        ),
        data=DataConfig(name="lm_synthetic", global_batch_size=8,
                        seq_len=8192),
        mesh=MeshConfig(data=-1),
        parallel=ParallelConfig(param_sharding="replicated"),
        trainer=dataclasses.replace(base.trainer, grad_accum=8,
                                    remat="full"),
    )


def imagenet_rn50_ddp() -> ExperimentConfig:
    """BASELINE config 2: ResNet-50 on ImageNet, data parallel (the DDP
    equivalent), bf16_mixed; SGD with nesterov momentum, weight decay and
    a cosine schedule after warmup, no grad clip. ``global_batch_size``
    is the whole 16-chip run's."""
    return ExperimentConfig(
        name="imagenet_rn50_ddp",
        model=ResNetConfig(depth=50, num_classes=1000),
        data=DataConfig(
            name="imagenet", global_batch_size=1024, image_size=224,
            channels=3, num_classes=1000,
        ),
        trainer=TrainerConfig(total_steps=112590, log_every=100,
                              eval_every=5000),
        optimizer=OptimizerConfig(
            name="sgd", learning_rate=0.4, momentum=0.9, weight_decay=1e-4,
            schedule="cosine", warmup_steps=1565,
        ),
        mesh=MeshConfig(data=-1),
        parallel=ParallelConfig(param_sharding="replicated"),
        precision=PrecisionConfig(policy="bf16_mixed"),
    )


_RECIPES = {
    "gpt2_medium_zero1": gpt2_medium_zero1,
    "gpt2_medium_serve": gpt2_medium_serve,
    "gpt2_long": gpt2_long,
    "imagenet_rn50_ddp": imagenet_rn50_ddp,
}


def get_config(name: str) -> ExperimentConfig:
    if name not in _RECIPES:
        raise KeyError(
            f"unknown config {name!r}; available: {sorted(_RECIPES)}"
        )
    return _RECIPES[name]()
