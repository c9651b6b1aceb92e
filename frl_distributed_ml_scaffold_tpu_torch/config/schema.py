"""Config schema of the port, as typed frozen dataclasses.

Field-for-field copies of the JAX package's ``GPTConfig``,
``ResNetConfig``, ``ViTConfig``, ``VideoConfig``, ``MLPConfig``,
``MoEConfig``, ``ServingConfig``, ``PrecisionConfig``,
``OptimizerConfig``, ``TrainerConfig``, ``CheckpointConfig``,
``ElasticConfig``, ``DataConfig``, ``MeshConfig`` and ``ParallelConfig``,
so one override string means the same thing to both packages. The port
keeps its own copy: it imports nothing of the JAX package. Fields whose
feature is not ported yet are kept (so recipes and overrides stay
identical) and refused where they would take effect (``models/gpt.py``,
``serving/engine.py``, ``trainer/loop.py``, ``launcher/launch.py``), each
with the ROADMAP item that brings it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class MeshConfig:
    """Logical device-mesh shape over the run's ranks (one per device;
    ``dist/mesh.py``): ``data``, ``fsdp`` and ``model`` split the batch,
    the params and the tensor-parallel products, ``seq`` every row's
    tokens (ring or Ulysses attention) and ``expert`` the MoE experts;
    one axis may be ``-1`` and absorb the ranks left; ``pipe`` the
    pipeline stages, one a rank (``mesh.pipe == model.pipeline_stages``;
    ``parallel/pipeline.py``), beside ``data`` only: ``fsdp``, ``model``,
    ``seq`` and ``expert`` inside a pipeline are refused (ROADMAP
    A12)."""

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
    """How the state is laid out over the mesh (``parallel/``): params
    ``replicated`` or split over ``fsdp`` (leaves of ``fsdp_min_size``
    elements and more), the optimizer state ``like_params`` or split over
    ``fsdp`` (``zero1``). Over an fsdp axis of size 1 every layout is the
    replicated one."""

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
    """Optimizer and learning-rate schedule (``trainer/optimizers.py``):
    ``adamw``, ``adam``, ``sgd``, ``lion`` and ``adafactor`` (each with
    the optional global-norm clip) and ``fused_adamw``
    (``ops/fused_adamw.py``)."""

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
    """The training loop's knobs. ``make_train_step`` reads
    ``grad_accum``, ``remat``, ``ema_decay`` and ``offload_opt_state``
    (the state in pinned host memory, on a card); ``trainer/loop.py``
    ``Trainer``
    reads the rest: ``total_steps``, ``log_every``, ``eval_every`` /
    ``eval_steps``, ``seed`` (the seeded init), ``profile_steps`` /
    ``profile_start_step`` (a ``torch.profiler`` window),
    ``tensorboard``, ``stall_timeout_s`` /
    ``stall_timeout_first_beat_scale`` (the stall watchdog),
    ``tracing`` (host spans, ``trace_events.json``) and ``preempt_save``
    (the SIGTERM checkpoint) and ``init_params_path`` (a flax msgpack
    params file to start from: ``checkpoint/flax_msgpack.py``). ``seed``
    also seeds training dropout."""

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
class CheckpointConfig:
    """Checkpoints of the train state (``checkpoint/manager.py``).
    ``restore_redistribute`` restores through the redistribution service
    (each rank reads about 1/N of every leaf, then the plan moves it to
    the trainer's layout), its chunks bounded by
    ``redistribute_scratch_mb`` (0: unbounded); the elastic supervisor's
    re-formed world sets it."""

    enabled: bool = False
    save_every: int = 1000
    max_to_keep: int = 3
    async_save: bool = True
    resume: bool = True  # restore the latest committed checkpoint
    restore_redistribute: bool = False
    redistribute_scratch_mb: int = 0


@dataclass(frozen=True)
class ElasticConfig:
    """The checkpoint-restart supervisor's knobs (``launcher/elastic.py``,
    run by ``--elastic``), the JAX package's fields and defaults: the
    restart budget and its backoff (``faults/retry.py``), the budget's
    reset after a long child run, the shrink to settled survivors after
    ``shrink_after`` failures (0: never), the membership heartbeats'
    staleness and retirement, and the grow-back watcher."""

    max_restarts: int = 3
    backoff_s: float = 1.0
    max_backoff_s: float = 300.0
    heartbeat_retire_after: int = 10
    reset_after_s: float = 600.0
    shrink_after: int = 0
    peer_timeout_s: float = 60.0
    grow: bool = True


@dataclass(frozen=True)
class DataConfig:
    """Input pipeline selection. The port has ``SyntheticLM``
    (``data/synthetic.py``) for ``lm_synthetic``, ``TokenBinLM``
    (``data/lm.py``) for ``lm``, ``ImageNet`` (``data/imagenet.py``) for
    ``imagenet``, ``MNIST`` (``data/mnist.py``) for ``mnist`` and
    ``VideoClips`` (``data/video.py``) for ``video``; ``data_dir`` names
    their shards or token bins. ``streaming`` reads the train split
    through the growing views of ``data/streaming.py``, re-scanned every
    ``streaming_refresh_every`` steps."""

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
    """Serving knobs of the continuous-batching engine: the queue bound
    and default deadline, the bucketed contiguous cache or the paged pool
    with the prefix cache, speculation (``ngram``, or ``draft`` with a
    draft model) over a bf16/fp32 or a quantized cache
    (``model.kv_cache_quant``), and the disaggregated prefill/decode
    workers (``build_engine`` dispatches on ``disaggregate``)."""

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
    # Pipeline parallelism: > 1 stages the block stack over the ``pipe``
    # axis (``parallel/pipeline.py``: "spmd", the GPipe or circular
    # timeline; ``parallel/mpmd_pipeline.py``: "mpmd", the 1F1B loop).
    # ``pipeline_microbatches`` 0 means the stage count.
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
    # (a 4x4/s1 convolution over 12 channels).
    stem: str = "conv7"
    # Stem max-pool backward: "scatter" = autodiff (first max wins);
    # "mask" = the compare-and-sum pass (ties split the gradient).
    pool_grad: str = "scatter"
    # Train-mode BatchNorm through the hand-written backward kernels
    # (ops/fused_bn.py): the same forward, the backward as two passes.
    fused_bn: bool = False


@dataclass(frozen=True)
class MLPConfig:
    family: str = "mlp"
    hidden_sizes: tuple[int, ...] = (512, 256)
    num_classes: int = 10
    dropout: float = 0.0


@dataclass(frozen=True)
class ViTConfig:
    family: str = "vit"
    image_size: int = 224
    patch_size: int = 16
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    num_classes: int = 1000
    dropout: float = 0.0
    pool: str = "cls"  # cls | mean


@dataclass(frozen=True)
class VideoConfig:
    """Video-clip classifier (BASELINE config 5): a ViT over tubelet
    embeddings of a frame stack."""

    family: str = "video"
    image_size: int = 224
    num_frames: int = 8
    tubelet_size: tuple[int, int, int] = (2, 16, 16)  # (t, h, w)
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    num_classes: int = 400
    dropout: float = 0.0


@dataclass(frozen=True)
class ExperimentConfig:
    """A run config: the model (``GPTConfig``, ``ResNetConfig``,
    ``ViTConfig``, ``VideoConfig`` or ``MLPConfig``;
    ``models.create_model`` dispatches on its ``family``), its training
    (data, trainer, optimizer, mesh, parallel, checkpoint), precision,
    serving and the elastic supervisor's section, and ``workdir``: the
    loop writes ``<workdir>/<name>/`` (``trainer/loop.py``)."""

    name: str = "experiment"
    model: Any = field(default_factory=GPTConfig)
    data: DataConfig = field(default_factory=DataConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    elastic: ElasticConfig = field(default_factory=ElasticConfig)
    workdir: str = "/tmp/frl_tpu_runs"

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)
