"""The recipes the port runs, under the JAX package's names: GPT-2
serving and training, and the training of the BASELINE model families
(MNIST MLP, ResNet-50, ViT-B/16, the video classifier).

Every section is kept (model, data, trainer, optimizer, mesh, parallel,
precision, checkpoint, serving), with the JAX recipe's values. The mesh
sections are the JAX recipes' layouts, laid over the run's ranks
(``dist/mesh.py``): on one card ``zero1`` and ``fsdp=-1`` are the
replicated layout; over N ranks they split the state (``parallel/``).
``gpt2_tp`` needs an even rank count (``model=2``). The five
``*_overlap*`` recipes run the overlap schedule (``parallel/
schedule.py``); ``gpt2_medium_tp_overlap`` and its ``_int8`` twin need
``model > 1``, the ``fsdp_tp`` pair ``model=2``. ``gpt2_ring`` splits
its 8192 tokens over ``seq=4`` (ring attention; ``ops/
ring_attention.py``) and ``gpt2_moe`` its 8 experts over ``expert=4``
(``models/moe.py``): both need a multiple of 4 ranks, or their mesh
overridden (``mesh.seq=1`` with ``model.attention=flash``,
``mesh.expert=1``) on one card. ``gpt2_pp``, ``gpt2_pp_circular``
(SPMD backend: GPipe, circular) and ``gpt2_pipeline_mpmd`` (1F1B) lay
their 4 stages over ``pipe=4``: 4 ranks, one stage each, or
``mesh.pipe=1`` to run every stage of the SPMD two in one process.
"""

from __future__ import annotations

import dataclasses

from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
    CheckpointConfig,
    DataConfig,
    ExperimentConfig,
    GPTConfig,
    MeshConfig,
    MLPConfig,
    MoEConfig,
    OptimizerConfig,
    ParallelConfig,
    PrecisionConfig,
    ResNetConfig,
    TrainerConfig,
    VideoConfig,
    ViTConfig,
)


def mnist_mlp() -> ExperimentConfig:
    """BASELINE config 1: an MLP on MNIST, single-process smoke test."""
    return ExperimentConfig(
        name="mnist_mlp",
        model=MLPConfig(hidden_sizes=(512, 256), num_classes=10),
        data=DataConfig(name="mnist", global_batch_size=256, image_size=28,
                        channels=1),
        trainer=TrainerConfig(total_steps=1500, log_every=100,
                              eval_every=500, eval_steps=20),
        optimizer=OptimizerConfig(name="adamw", learning_rate=1e-3,
                                  schedule="cosine", warmup_steps=50),
        mesh=MeshConfig(data=-1),
        precision=PrecisionConfig(policy="fp32"),
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
    (``model.decode_attention=flash``), over the JAX recipe's mesh: the
    engine serves over its ``model=2`` ranks when built inside
    ``mesh_context(build_mesh(cfg.mesh))`` with ``build_engine(...,
    rules=gpt_tp_rules())`` (8 of the 16 heads a rank; along ``data``
    the ranks share the requests, the contiguous cache's rows split
    over them), and on one card without a mesh."""
    base = gpt2_medium_zero1()
    return base.replace(
        name="gpt2_medium_serve",
        model=dataclasses.replace(base.model, decode_attention="flash"),
        mesh=MeshConfig(data=-1, fsdp=1, model=2),
        parallel=ParallelConfig(param_sharding="replicated"),
    )


def gpt2_medium_adafactor() -> ExperimentConfig:
    """The flagship on Adafactor: ``gpt2_medium_zero1`` with adafactor
    at lr 1e-2 (its update is relative, so AdamW's 3e-4 would barely
    move it) and no weight decay. The factored second moment keeps a row
    and a column a matrix: 3271452 bytes of optimizer state for the
    GPT-2-medium model against AdamW's 2838585344 (``chip_smoke.py``'s
    ``adafactor_path``)."""
    base = gpt2_medium_zero1()
    return base.replace(
        name="gpt2_medium_adafactor",
        optimizer=dataclasses.replace(
            base.optimizer, name="adafactor", learning_rate=1e-2,
            weight_decay=0.0,
        ),
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


def gpt2_tp() -> ExperimentConfig:
    """Tensor-parallel transformer: Megatron column / row splits over a
    ``model`` axis of 2 (``models/gpt.py`` ``gpt_tp_rules``)."""
    base = gpt2_medium_zero1()
    return base.replace(
        name="gpt2_tp",
        mesh=MeshConfig(data=-1, model=2),
        parallel=ParallelConfig(param_sharding="replicated"),
        trainer=base.trainer,
    )


def gpt2_ring() -> ExperimentConfig:
    """Sequence-parallel long context: 8k tokens split over a ``seq``
    axis of 4, ring attention over the flash kernels."""
    base = gpt2_medium_zero1()
    return base.replace(
        name="gpt2_ring",
        model=GPTConfig(
            vocab_size=50257, num_layers=24, num_heads=16, hidden_dim=1024,
            seq_len=8192, attention="ring",
        ),
        data=DataConfig(name="lm_synthetic", global_batch_size=8,
                        seq_len=8192),
        mesh=MeshConfig(data=-1, seq=4),
        parallel=ParallelConfig(param_sharding="replicated",
                                sequence="ring"),
        trainer=dataclasses.replace(base.trainer, grad_accum=1),
    )


def gpt2_moe() -> ExperimentConfig:
    """Expert-parallel MoE LM: 12 layers, 8 experts top-2 over an
    ``expert`` axis of 4."""
    base = gpt2_medium_zero1()
    return base.replace(
        name="gpt2_moe",
        model=GPTConfig(
            vocab_size=50257, num_layers=12, num_heads=16, hidden_dim=1024,
            seq_len=1024, moe=MoEConfig(num_experts=8, top_k=2),
        ),
        mesh=MeshConfig(data=-1, expert=4),
        parallel=ParallelConfig(param_sharding="replicated"),
    )


def gpt2_pp() -> ExperimentConfig:
    """Pipeline-parallel LM: 4 stages over the ``pipe`` axis, GPipe
    schedule with 8 microbatches (bubble = 3/11 of a step)."""
    base = gpt2_medium_zero1()
    return base.replace(
        name="gpt2_pp",
        model=GPTConfig(
            vocab_size=50257, num_layers=24, num_heads=16, hidden_dim=1024,
            seq_len=1024, pipeline_stages=4, pipeline_microbatches=8,
        ),
        mesh=MeshConfig(data=-1, pipe=4),
        parallel=ParallelConfig(param_sharding="replicated"),
        trainer=dataclasses.replace(base.trainer, grad_accum=1),
    )


def gpt2_pipeline_mpmd() -> ExperimentConfig:
    """The ``gpt2_pp`` operating point on the MPMD backend
    (``parallel/mpmd_pipeline.py``): one stage program a pipe rank,
    driven in 1F1B order, so a stage holds min(S, M) = 4 microbatch
    activations instead of GPipe's 8."""
    base = gpt2_pp()
    return base.replace(
        name="gpt2_pipeline_mpmd",
        model=dataclasses.replace(base.model, pipeline_impl="mpmd"),
    )


def gpt2_pp_circular() -> ExperimentConfig:
    """Circular (interleaved) pipeline: the 4 stages of ``gpt2_pp``
    each hold 2 layer groups, cutting the bubble from 3/11 to 3/19 of a
    step at the cost of rotating activations through the ring twice."""
    base = gpt2_pp()
    return base.replace(
        name="gpt2_pp_circular",
        model=dataclasses.replace(base.model, pipeline_circular_repeat=2),
    )


def gpt2_medium_fsdp_overlap() -> ExperimentConfig:
    """The LM under overlap-scheduled FSDP (``parallel/fsdp_overlap.py``):
    params split over ``fsdp``, each block gathering its own shards one
    block ahead and reduce-scattering its gradient as its backward
    ends."""
    base = gpt2_medium_zero1()
    return base.replace(
        name="gpt2_medium_fsdp_overlap",
        mesh=MeshConfig(data=1, fsdp=-1),
        parallel=ParallelConfig(
            param_sharding="fsdp",
            opt_sharding="like_params",
            fsdp_overlap=True,
            fsdp_prefetch=1,
        ),
    )


def gpt2_medium_tp_overlap() -> ExperimentConfig:
    """The LM under tensor parallelism on the collective-matmul rings
    (``parallel/tp_overlap.py``): the four per-block ``model`` products
    as bidirectional rings, the residual stream split over ``model``
    along the tokens between them."""
    base = gpt2_medium_zero1()
    return base.replace(
        name="gpt2_medium_tp_overlap",
        mesh=MeshConfig(data=1, model=-1),
        parallel=ParallelConfig(
            param_sharding="replicated",
            opt_sharding="zero1",
            tp_overlap=True,
        ),
    )


def gpt2_medium_tp_overlap_int8() -> ExperimentConfig:
    """``gpt2_medium_tp_overlap`` with int8 rings: chunks and scales on
    the wire, the products through ``qdot``, straight-through
    gradients (``ops/quantization.py``)."""
    base = gpt2_medium_tp_overlap()
    return base.replace(
        name="gpt2_medium_tp_overlap_int8",
        parallel=dataclasses.replace(base.parallel, low_precision="int8"),
    )


def gpt2_medium_fsdp_tp_overlap() -> ExperimentConfig:
    """Both schedules at once: the blockwise FSDP gathers over ``fsdp``
    and the collective-matmul rings over ``model=2``."""
    base = gpt2_medium_zero1()
    return base.replace(
        name="gpt2_medium_fsdp_tp_overlap",
        mesh=MeshConfig(data=1, fsdp=-1, model=2),
        parallel=ParallelConfig(
            param_sharding="fsdp",
            opt_sharding="like_params",
            fsdp_overlap=True,
            fsdp_prefetch=1,
            tp_overlap=True,
        ),
    )


def gpt2_medium_fsdp_tp_overlap_int8() -> ExperimentConfig:
    """``gpt2_medium_fsdp_tp_overlap`` with int8 rings."""
    base = gpt2_medium_fsdp_tp_overlap()
    return base.replace(
        name="gpt2_medium_fsdp_tp_overlap_int8",
        parallel=dataclasses.replace(base.parallel, low_precision="int8"),
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


def imagenet_vitb_fsdp() -> ExperimentConfig:
    """BASELINE config 3: ViT-B/16 on ImageNet, FSDP full-shard and full
    remat; AdamW with weight decay, a cosine schedule after warmup and a
    global-norm clip. ``fsdp=-1`` takes every rank: one card holds every
    param whole, N ranks split each one of ``fsdp_min_size`` elements or
    more over N."""
    return ExperimentConfig(
        name="imagenet_vitb_fsdp",
        model=ViTConfig(image_size=224, patch_size=16, hidden_dim=768,
                        num_layers=12, num_heads=12, num_classes=1000),
        data=DataConfig(
            name="imagenet", global_batch_size=1024, image_size=224,
            channels=3, num_classes=1000,
        ),
        trainer=TrainerConfig(total_steps=93500, remat="full",
                              log_every=100, eval_every=5000),
        optimizer=OptimizerConfig(
            name="adamw", learning_rate=3e-3, weight_decay=0.3,
            schedule="cosine", warmup_steps=10000, grad_clip_norm=1.0,
        ),
        mesh=MeshConfig(data=1, fsdp=-1),
        parallel=ParallelConfig(param_sharding="fsdp"),
        precision=PrecisionConfig(policy="bf16_mixed"),
    )


def imagenet_rn101_ddp() -> ExperimentConfig:
    """ResNet-101 on the RN50 recipe (the same schedule, depth-101
    bottleneck stacks)."""
    base = imagenet_rn50_ddp()
    return base.replace(
        name="imagenet_rn101_ddp",
        model=dataclasses.replace(base.model, depth=101),
    )


def imagenet_vitl_fsdp() -> ExperimentConfig:
    """ViT-L/16 (307M params) on the ViT-B FSDP recipe."""
    base = imagenet_vitb_fsdp()
    return base.replace(
        name="imagenet_vitl_fsdp",
        model=dataclasses.replace(
            base.model, hidden_dim=1024, num_layers=24, num_heads=16
        ),
    )


def ego4d_video_elastic() -> ExperimentConfig:
    """BASELINE config 5: the video-clip classifier, full remat, AdamW
    with a clip, checkpoints every 500 steps (``checkpoint/manager.py``,
    read by ``trainer/loop.py``). The JAX recipe runs under the elastic
    supervisor, which the port's launcher refuses (``--elastic``,
    ROADMAP A13)."""
    return ExperimentConfig(
        name="ego4d_video_elastic",
        model=VideoConfig(num_frames=8, num_classes=400),
        data=DataConfig(
            name="video_synthetic", global_batch_size=64, image_size=224,
            channels=3, num_frames=8, num_classes=400,
        ),
        trainer=TrainerConfig(total_steps=30000, remat="full", log_every=50),
        optimizer=OptimizerConfig(
            name="adamw", learning_rate=1e-3, weight_decay=0.05,
            schedule="cosine", warmup_steps=2500, grad_clip_norm=1.0,
        ),
        mesh=MeshConfig(data=1, fsdp=-1),
        parallel=ParallelConfig(param_sharding="fsdp"),
        precision=PrecisionConfig(policy="bf16_mixed"),
        checkpoint=CheckpointConfig(enabled=True, save_every=500,
                                    max_to_keep=3),
    )


_RECIPES = {
    "mnist_mlp": mnist_mlp,
    "gpt2_medium_zero1": gpt2_medium_zero1,
    "gpt2_medium_serve": gpt2_medium_serve,
    "gpt2_medium_adafactor": gpt2_medium_adafactor,
    "gpt2_long": gpt2_long,
    "gpt2_tp": gpt2_tp,
    "gpt2_ring": gpt2_ring,
    "gpt2_moe": gpt2_moe,
    "gpt2_pp": gpt2_pp,
    "gpt2_pp_circular": gpt2_pp_circular,
    "gpt2_pipeline_mpmd": gpt2_pipeline_mpmd,
    "gpt2_medium_fsdp_overlap": gpt2_medium_fsdp_overlap,
    "gpt2_medium_tp_overlap": gpt2_medium_tp_overlap,
    "gpt2_medium_tp_overlap_int8": gpt2_medium_tp_overlap_int8,
    "gpt2_medium_fsdp_tp_overlap": gpt2_medium_fsdp_tp_overlap,
    "gpt2_medium_fsdp_tp_overlap_int8": gpt2_medium_fsdp_tp_overlap_int8,
    "imagenet_rn50_ddp": imagenet_rn50_ddp,
    "imagenet_rn101_ddp": imagenet_rn101_ddp,
    "imagenet_vitb_fsdp": imagenet_vitb_fsdp,
    "imagenet_vitl_fsdp": imagenet_vitl_fsdp,
    "ego4d_video_elastic": ego4d_video_elastic,
}


def list_configs() -> list[str]:
    return sorted(_RECIPES)


def get_config(name: str) -> ExperimentConfig:
    if name not in _RECIPES:
        raise KeyError(
            f"unknown config {name!r}; available: {sorted(_RECIPES)}"
        )
    return _RECIPES[name]()
