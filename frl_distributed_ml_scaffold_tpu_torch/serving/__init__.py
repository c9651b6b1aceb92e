"""Serving subsystem of the port: the continuous-batching engine over the
bucketed contiguous KV cache, decoding through the hand-written decode
kernel (ops/decode_attention.py)."""

from frl_distributed_ml_scaffold_tpu_torch.serving.engine import (
    Completion,
    ServeRequest,
    ServingEngine,
)


def build_engine(model, *, serving, **kw):
    """Config-driven engine construction: dispatch on
    ``serving.disaggregate``. ``kw`` passes through (num_slots, eos_id,
    device, ...)."""
    if serving.disaggregate:
        raise NotImplementedError(
            "serving.disaggregate=True (prefill/decode workers + SLO "
            "scheduler) is not ported yet (ROADMAP queue A item 3)"
        )
    return ServingEngine(model, serving=serving, **kw)


__all__ = ["Completion", "ServeRequest", "ServingEngine", "build_engine"]
