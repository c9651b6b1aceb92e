"""Config schema of the serving slice, as typed frozen dataclasses.

Field-for-field copies of the JAX package's ``GPTConfig``, ``MoEConfig``,
``ServingConfig`` and ``PrecisionConfig``, so one override string means
the same thing to both packages. The port keeps its own copy: it imports
nothing of the JAX package. Fields whose feature is not ported yet are
kept (so recipes and overrides stay identical) and refused where they
would take effect (``models/gpt.py``, ``serving/engine.py``), each with
the ROADMAP item that brings it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class PrecisionConfig:
    """Mixed-precision policy name (``precision.py``)."""

    policy: str = "bf16_mixed"  # fp32 | bf16 | bf16_mixed


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
class ExperimentConfig:
    """The sections of a run config the serving slice reads."""

    name: str = "experiment"
    model: Any = field(default_factory=GPTConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)
