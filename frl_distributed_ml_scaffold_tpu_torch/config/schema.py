"""Config schema of the port, as typed frozen dataclasses.

Field-for-field copies of the JAX package's ``GPTConfig``,
``ResNetConfig``, ``MoEConfig``, ``ServingConfig``, ``PrecisionConfig``,
``OptimizerConfig``, ``TrainerConfig``, ``DataConfig``, ``MeshConfig``
and ``ParallelConfig``, so one override string means the same thing to
both packages. The port keeps its own copy: it imports
nothing of the JAX package. Fields whose feature is not ported yet are
kept (so recipes and overrides stay identical) and refused where they
would take effect (``models/gpt.py``, ``serving/engine.py``), each with
the ROADMAP item that brings it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class MeshConfig:
    """Logical device-mesh shape. The port runs on one card: every axis
    of size 1 (``data = -1`` absorbs the one device). Larger meshes are
    refused where they would take effect (``trainer/train_step.py``,
    ROADMAP queue A item 7)."""

    data: int = -1
    fsdp: int = 1
    model: int = 1
    seq: int = 1
    expert: int = 1
    pipe: int = 1
    dcn_data: int = 1

    def axis_sizes(self) -> dict[str, int]:
        return {
            "data": self.data,
            "fsdp": self.fsdp,
            "model": self.model,
            "seq": self.seq,
            "expert": self.expert,
            "pipe": self.pipe,
        }


@dataclass(frozen=True)
class ParallelConfig:
    """How state is laid out over the mesh. On one card every layout is
    the replicated one: ``opt_sharding="zero1"`` shards the optimizer
    state over an fsdp axis of size 1, which leaves it whole."""

    param_sharding: str = "replicated"  # replicated | fsdp
    opt_sharding: str = "like_params"  # like_params | zero1
    sequence: str = "none"  # none | ring | ulysses
    fsdp_min_size: int = 1024
    fsdp_overlap: bool = False
    fsdp_prefetch: int = 1
    tp_overlap: bool = False
    low_precision: str = "none"  # none | int8 | fp8_e4m3 | fp8_e5m2
    schedule: str = "auto"


@dataclass(frozen=True)
class PrecisionConfig:
    """Mixed-precision policy name (``precision.py``)."""

    policy: str = "bf16_mixed"  # fp32 | bf16 | bf16_mixed


@dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer and learning-rate schedule (``trainer/optimizers.py``).
    The port runs ``adamw``, ``sgd`` (each with the optional global-norm
    clip) and ``fused_adamw`` (``ops/fused_adamw.py``); the others raise,
    naming ROADMAP queue A item 10."""

    name: str = "adamw"  # adamw | sgd | adam | adafactor | lion | fused_adamw
    learning_rate: float = 1e-3
    warmup_steps: int = 0
    schedule: str = "constant"  # constant | cosine | linear | wsd
    weight_decay: float = 0.0
    b1: float = 0.9
    # None = the optimizer's own canonical default (0.999 for the adam
    # family, 0.99 for lion); an explicit value is always honored.
    b2: Optional[float] = None
    eps: float = 1e-8
    momentum: float = 0.9  # sgd only
    grad_clip_norm: Optional[float] = None
    # "wsd" only: fraction of post-warmup steps spent in the final linear
    # decay (the rest holds the peak LR).
    wsd_decay_fraction: float = 0.2


@dataclass(frozen=True)
class TrainerConfig:
    """The training loop's knobs. The port's ``make_train_step`` reads
    ``grad_accum``, ``remat``, ``seed``, ``ema_decay`` and
    ``offload_opt_state`` (refused); the loop's own knobs (logging,
    eval, profiling, watchdog, checkpoints) are kept for the loop
    (ROADMAP queue A item 6)."""

    total_steps: int = 1000
    grad_accum: int = 1
    remat: str = "none"  # none | full | dots
    log_every: int = 50
    eval_every: int = 0  # 0 = no eval during training
    eval_steps: int = 10
    seed: int = 0
    profile_steps: int = 0
    profile_start_step: int = 10
    # Exponential moving average of params (ema = d*ema + (1-d)*params).
    # 0 = off.
    ema_decay: float = 0.0
    init_params_path: str = ""
    tensorboard: bool = False
    stall_timeout_s: float = 0.0
    stall_timeout_first_beat_scale: float = 5.0
    tracing: bool = True
    offload_opt_state: bool = False
    preempt_save: bool = True


@dataclass(frozen=True)
class DataConfig:
    """Input pipeline selection. The port has ``SyntheticLM``
    (``data/synthetic.py``) for ``lm_synthetic`` and the synthetic
    ``ImageNet`` (``data/imagenet.py``) for ``imagenet``."""

    name: str = "synthetic_mnist"
    global_batch_size: int = 128
    image_size: int = 28
    num_classes: int = 10
    channels: int = 1
    seq_len: int = 1024
    vocab_size: int = 50257
    num_frames: int = 8
    shuffle_seed: int = 0
    data_dir: Optional[str] = None
    prefetch: int = 2
    streaming: bool = False
    streaming_refresh_every: int = 256
    loader_max_retries: int = 2
    loader_retry_backoff_s: float = 0.05


@dataclass(frozen=True)
class ServingConfig:
    """Serving knobs of the continuous-batching engine. The port runs
    the bucketed contiguous cache, the paged pool with the prefix cache
    and ``speculate=ngram``, each over a bf16/fp32 or a quantized cache
    (``model.kv_cache_quant``); ``ServingEngine`` refuses the rest
    (``speculate=draft``, disaggregation, deadlines, load shedding)."""

    # Bounded admission (load shedding); 0 = unbounded.
    max_queue_depth: int = 0
    # Per-request deadline in seconds from submit; 0 = none.
    default_deadline_s: float = 0.0
    # > 0 = paged KV pool of fixed-size blocks; 0 = bucketed contiguous.
    kv_block_size: int = 0
    kv_pool_blocks: int = 0
    prefix_cache: bool = True
    # Speculative decoding on the paged engine: off | ngram | draft.
    speculate: str = "off"
    speculate_k: int = 4
    # Disaggregated prefill/decode workers.
    disaggregate: bool = False
    prefill_max_per_tick: int = 1
    handoff_retries: int = 2


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block; ``num_experts = 0`` disables it."""

    num_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    router_z_loss: float = 1e-3
    num_groups: int = 0
    dispatch: str = "einsum"  # einsum | sort


@dataclass(frozen=True)
class GPTConfig:
    family: str = "gpt"
    vocab_size: int = 50257
    num_layers: int = 24
    num_heads: int = 16
    hidden_dim: int = 1024
    seq_len: int = 1024
    mlp_ratio: int = 4
    dropout: float = 0.0
    # GPT-2's LayerNorm epsilon (HF checkpoints are trained with 1e-5).
    layer_norm_epsilon: float = 1e-5
    # Training attention: dense | ring | ulysses | flash. Decode-mode
    # prefill is dense whatever this says.
    attention: str = "dense"
    # Single-token decode attention: "flash" = the hand-written kernel
    # (ops/decode_attention.py), "dense" = the plain masked reference.
    decode_attention: str = "flash"
    # Quantized KV cache ("none" | "int8" | "fp8_e4m3"; fp8_e5m2 is also
    # accepted, as by the reference): K/V stored as 1-byte payloads with
    # per-(row, position, head) bf16 scales beside them, each written
    # token quantized once over its own head vector
    # (ops/quantization.py); the decode and verify kernels read the
    # payloads and scales in place (ops/csrc/quant_attention.cu).
    kv_cache_quant: str = "none"
    lm_loss_chunk: int = 0
    moe: MoEConfig = field(default_factory=MoEConfig)
    pipeline_stages: int = 1
    pipeline_microbatches: int = 0
    pipeline_impl: str = "spmd"  # spmd | mpmd
    pipeline_circular_repeat: int = 1
    pipeline_stage_remat: bool = False
    block_remat: str = "none"


@dataclass(frozen=True)
class ResNetConfig:
    family: str = "resnet"
    depth: int = 50  # 10 | 18 | 34 | 50 | 101 | 152
    num_classes: int = 1000
    width_multiplier: int = 1
    # "conv7" = the 7x7/s2 stem; "s2d" = the space-to-depth rewrite
    # (refused by the port's model, ROADMAP queue A item 9).
    stem: str = "conv7"
    # Stem max-pool backward: "scatter" = autodiff (first max wins);
    # "mask" = the compare-and-sum pass (refused by the port's model).
    pool_grad: str = "scatter"
    # Train-mode BatchNorm through the hand-written backward kernels
    # (ops/fused_bn.py): the same forward, the backward as two passes.
    fused_bn: bool = False


@dataclass(frozen=True)
class ExperimentConfig:
    """The sections of a run config the port reads: the model
    (``GPTConfig`` or ``ResNetConfig``; ``models.create_model`` dispatches
    on its ``family``), its training (data,
    trainer, optimizer, mesh, parallel), precision and serving. The JAX
    package's checkpoint and elastic sections, and its ``workdir``,
    arrive with the training loop (ROADMAP queue A item 6)."""

    name: str = "experiment"
    model: Any = field(default_factory=GPTConfig)
    data: DataConfig = field(default_factory=DataConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)
