"""Serving subsystem of the port: the continuous-batching engine over the
bucketed contiguous KV cache or the paged block pool (with the shared
prefix cache and n-gram speculation), decoding through the hand-written
kernels of ops/decode_attention.py."""

from frl_distributed_ml_scaffold_tpu_torch.serving.engine import (
    Completion,
    ServeRequest,
    ServingEngine,
    ngram_propose,
)


def build_engine(model, *, serving, **kw):
    """Config-driven engine construction: dispatch on
    ``serving.disaggregate``; the engine reads the paged and speculation
    knobs (``kv_block_size``, ``kv_pool_blocks``, ``prefix_cache``,
    ``speculate``, ``speculate_k``) from ``serving``. ``kw`` passes
    through (num_slots, eos_id, device, ...)."""
    if serving.disaggregate:
        raise NotImplementedError(
            "serving.disaggregate=True (prefill/decode workers + SLO "
            "scheduler) is not ported yet (ROADMAP queue A item 3)"
        )
    return ServingEngine(model, serving=serving, **kw)


__all__ = [
    "Completion",
    "ServeRequest",
    "ServingEngine",
    "build_engine",
    "ngram_propose",
]
