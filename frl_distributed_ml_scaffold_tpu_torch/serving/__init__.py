"""Serving subsystem of the port: the continuous-batching engine over the
bucketed contiguous KV cache or the paged block pool (with the shared
prefix cache and n-gram or draft-model speculation), decoding through the
hand-written kernels of ops/decode_attention.py; and the disaggregated
prefill/decode split with the multi-tenant SLO scheduler on top
(serving/scheduler.py)."""

from frl_distributed_ml_scaffold_tpu_torch.serving.engine import (
    CacheGrowError,
    Completion,
    ServeRequest,
    ServingEngine,
    ngram_propose,
)
from frl_distributed_ml_scaffold_tpu_torch.serving.scheduler import (
    SLO_CLASSES,
    DisaggServingEngine,
    PrefillWorker,
    TenantSpec,
)


def build_engine(model, *, serving, rules=None, **kw):
    """Config-driven engine construction: dispatch on
    ``serving.disaggregate`` to the ``DisaggServingEngine`` or the
    colocated ``ServingEngine``; both read the paged, speculation, queue
    and deadline knobs from ``serving``. ``kw`` passes through
    (num_slots, eos_id, tenants, draft_model, device, ...). ``rules``
    (placing the params onto a model-sharded serving layout) is refused:
    the port serves on one card (ROADMAP queue A item 5, A7)."""
    if rules is not None:
        raise NotImplementedError(
            "build_engine(rules=...) (tensor-parallel serving params on a "
            "mesh) is not ported yet (ROADMAP queue A item 5, A7)"
        )
    cls = DisaggServingEngine if serving.disaggregate else ServingEngine
    return cls(model, serving=serving, **kw)


__all__ = [
    "CacheGrowError",
    "Completion",
    "DisaggServingEngine",
    "PrefillWorker",
    "SLO_CLASSES",
    "ServeRequest",
    "ServingEngine",
    "TenantSpec",
    "build_engine",
    "ngram_propose",
]
