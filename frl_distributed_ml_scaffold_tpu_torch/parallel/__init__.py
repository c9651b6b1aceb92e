"""The parallelism layer: the port of the JAX package's ``parallel/``
for DP, FSDP, ZeRO-1 and TP, as specs over one mesh.

- DP: every param whole, the batch split over ``("data", "fsdp")``; the
  step all-reduces the gradients.
- FSDP: params split over ``fsdp`` on their largest divisible dim,
  gathered for the step, gradients reduce-scattered.
- ZeRO-1: params whole, the optimizer state split over ``fsdp``.
- TP: Megatron column / row splits over ``model`` by the models' rules
  (``models/gpt.py`` ``gpt_tp_rules``, ``models/vit.py``
  ``vit_tp_rules``), the forward's collectives in
  ``tensor_parallel.py``.

``partition.py`` derives the specs (and places a model's parameters on a
serving mesh: ``shard_params_for_serving``), ``layout.py`` holds them
for a run and moves tensors between them. The overlap schedule
(``schedule.py``) rewrites the FSDP gathers block by block
(``fsdp_overlap.py``) and the TP products as collective-matmul rings
(``tp_overlap.py``, ``ops/collective_matmul.py``), with low precision on
the rings' wire.
"""

from frl_distributed_ml_scaffold_tpu_torch.parallel.partition import (
    JaxLeaf,
    PartitionRules,
    fsdp_spec_for,
    jax_leaves,
    jax_spec_of,
    opt_state_specs,
    param_specs,
    shard_params_for_serving,
)
