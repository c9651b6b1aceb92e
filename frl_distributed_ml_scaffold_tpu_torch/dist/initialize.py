"""Process bring-up: the port of the JAX package's ``dist/initialize.py``.

One process per rank. ``initialize_distributed`` joins this process to
the run's ``torch.distributed`` process group: NCCL when the ranks run on
cards (the default), gloo only when the caller asks for the CPU
(``device="cpu"``). A topology of one process initialises nothing, as in
the JAX package: every collective of the mesh is then the identity.

Environment contract, the JAX package's: ``FRL_TPU_COORDINATOR``
(``host:port`` of rank 0's rendezvous, or a ``file://`` path),
``FRL_TPU_NUM_PROCESSES``, ``FRL_TPU_PROCESS_ID`` and
``FRL_TPU_INIT_TIMEOUT_S`` (the rendezvous timeout, 300 s by default).
Explicit arguments win over the variables. Nothing is detected from the
platform: a multi-process run names its size, rank and coordinator.

Rank ``r`` drives card ``cuda:{r % torch.cuda.device_count()}``.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

_INITIALIZED = False


def local_device(process_id: int, device: str | torch.device | None = None
                 ) -> torch.device:
    """This rank's device: ``cuda:{process_id % device_count}`` for a
    CUDA run (``device`` None or ``cuda``; raises without a card), the
    CPU when asked for."""
    from frl_distributed_ml_scaffold_tpu_torch import resolve_device

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    resolve_device(dev)  # raises without a card
    return torch.device("cuda", process_id % torch.cuda.device_count())


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | torch.device | None = None,
) -> None:
    """Join the run's process group when more than one process is
    configured; safe to call unconditionally (a second call, or a
    one-process topology, does nothing).

    Resolution order: explicit arguments, then the ``FRL_TPU_*``
    variables. ``device`` picks the backend: NCCL for ``cuda`` (the
    default; the rank's card becomes the current device), gloo for
    ``cpu``."""
    global _INITIALIZED
    if _INITIALIZED or dist.is_initialized():
        return
    coordinator_address = (coordinator_address
                           or os.environ.get("FRL_TPU_COORDINATOR"))
    if num_processes is None and "FRL_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["FRL_TPU_NUM_PROCESSES"])
    if process_id is None and "FRL_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["FRL_TPU_PROCESS_ID"])
    if num_processes is None or num_processes == 1:
        if num_processes is None and coordinator_address is not None:
            raise ValueError(
                "a coordinator without a process count: the port detects "
                "no cluster; pass --num-processes and --process-id (or "
                "FRL_TPU_NUM_PROCESSES / FRL_TPU_PROCESS_ID)")
        return
    if process_id is None or coordinator_address is None:
        raise ValueError(
            f"num_processes={num_processes} needs a process id and a "
            "coordinator address (--process-id / --coordinator or "
            "FRL_TPU_PROCESS_ID / FRL_TPU_COORDINATOR)")
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id {process_id} out of range for {num_processes} "
            "processes")
    dev = local_device(process_id, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    init_method = (coordinator_address
                   if coordinator_address.startswith(("file://", "tcp://"))
                   else f"tcp://{coordinator_address}")
    timeout_s = int(os.environ.get("FRL_TPU_INIT_TIMEOUT_S", "300"))
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    _INITIALIZED = True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def shutdown_distributed() -> None:
    """Leave the process group this module joined (a no-op otherwise)."""
    global _INITIALIZED
    if _INITIALIZED and dist.is_initialized():
        dist.destroy_process_group()
    _INITIALIZED = False
