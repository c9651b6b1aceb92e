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


def build_engine(model, *, serving, rules=None, layout=None, **kw):
    """Config-driven engine construction: dispatch on
    ``serving.disaggregate`` to the ``DisaggServingEngine`` or the
    colocated ``ServingEngine``; both read the paged, speculation, queue
    and deadline knobs from ``serving``. ``kw`` passes through
    (num_slots, eos_id, tenants, draft_model, prefill_env, device, ...).

    ``rules``: the model's tensor-parallel partition rules (``models/
    gpt.py`` ``gpt_tp_rules()``). Given inside ``mesh_context(env)``, the
    model's parameters are first placed on this rank's shards
    (``parallel.partition.shard_params_for_serving``, in place) and the
    engine serves over the mesh; with no current mesh they do nothing,
    as in the JAX package. The engine keeps ``rules``: a re-spread and a
    prefill partition's replica place the params by them (None: whole
    on every rank). ``layout``: the training ``StateLayout`` whose
    shards the model holds, which then move through the redistribution
    service (the train-to-serve handoff; every rank of both meshes
    calls this)."""
    if rules is not None:
        from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
            current_mesh_env,
        )
        from frl_distributed_ml_scaffold_tpu_torch.parallel.partition import (
            shard_params_for_serving,
        )

        env = current_mesh_env()
        if env is not None:
            shard_params_for_serving(model, env, rules, layout=layout)
    cls = DisaggServingEngine if serving.disaggregate else ServingEngine
    return cls(model, serving=serving, rules=rules, **kw)


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
