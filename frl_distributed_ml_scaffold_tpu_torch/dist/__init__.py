"""The distributed layer: the port of the JAX package's ``dist/``, on
``torch.distributed``.

- ``initialize.py``: process bring-up (one process per rank; NCCL on
  the cards, gloo on the CPU when asked for);
- ``mesh.py``: the logical mesh over the ranks, with the JAX package's
  axis names, order and layout, and a process group per set of axes;
- ``collectives.py``: the collectives over the mesh's axes by name, and
  the host-level ones.
"""

from frl_distributed_ml_scaffold_tpu_torch.dist.initialize import (
    initialize_distributed,
    process_count,
    process_index,
    shutdown_distributed,
)
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
    MeshEnv,
    build_mesh,
    local_batch_size,
)
from frl_distributed_ml_scaffold_tpu_torch.dist import collectives
