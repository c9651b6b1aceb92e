"""Collectives over the mesh's axes: the port of the JAX package's
``dist/collectives.py``, on ``torch.distributed``.

**Device tier**: the JAX functions that run inside ``shard_map`` over a
mesh axis become calls over the mesh's group of that axis (or tuple of
axes), on this rank's shard: ``all_reduce`` / ``all_mean`` (sum and
mean all-reduce), ``all_gather``, ``reduce_scatter``, ``broadcast``
(from coordinate ``source``), ``permute`` (``(src, dst)`` coordinate
pairs; a shard nobody sends to is zeros, as ``lax.ppermute`` makes it),
``ring_shift``, ``all_to_all``, ``axis_index`` and ``axis_size``. Each
takes a tensor or a dict of tensors, and the mesh (``env``; default the
current one, ``dist/mesh.py`` ``mesh_context``). Over an axis of size 1
each is the identity and communicates nothing. None is differentiable:
the autograd pairs that the models need are in
``parallel/tensor_parallel.py``.

**Host tier**, process-level coordination over every rank:
``host_all_gather`` (each rank's array stacked on a new leading axis),
``host_broadcast`` (rank 0's value to all) and ``barrier``; in one
process they return their input and do nothing.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
    MeshEnv,
    current_mesh_env,
)

AxisName = str | tuple[str, ...]


def _env(env: MeshEnv | None) -> MeshEnv:
    env = env or current_mesh_env()
    if env is None:
        raise RuntimeError("no mesh: pass env= or enter mesh_context(env)")
    return env


def _map(fn, x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    return fn(x)


# ----------------------------- device tier --------------------------------


def all_reduce(x: Any, axis: AxisName, *, env: MeshEnv | None = None) -> Any:
    """Sum over the members of ``axis``."""
    group = _env(env).group(axis)
    if group is None:
        return x

    def one(a):
        out = a.clone()
        dist.all_reduce(out, group=group)
        return out

    return _map(one, x)


def all_mean(x: Any, axis: AxisName, *, env: MeshEnv | None = None) -> Any:
    """Mean over the members of ``axis`` (the DDP gradient average)."""
    n = _env(env).axis_size(axis)
    return _map(lambda a: a / n, all_reduce(x, axis, env=env))


def all_gather(x: Any, axis: AxisName, *, gather_axis: int = 0,
               tiled: bool = True, env: MeshEnv | None = None) -> Any:
    """Every member's shard, concatenated along ``gather_axis`` in
    coordinate order (``tiled``) or stacked on a new axis there."""
    env = _env(env)
    group = env.group(axis)

    def one(a):
        if group is None:
            return a if tiled else a.unsqueeze(gather_axis)
        parts = [torch.empty_like(a) for _ in range(env.axis_size(axis))]
        dist.all_gather(parts, a.contiguous(), group=group)
        return (torch.cat if tiled else torch.stack)(parts, gather_axis)

    return _map(one, x)


def reduce_scatter(x: Any, axis: AxisName, *, scatter_axis: int = 0,
                   env: MeshEnv | None = None) -> Any:
    """Sum over the members of ``axis``, then this member's chunk of
    ``scatter_axis`` (which the axis size must divide)."""
    env = _env(env)
    group = env.group(axis)
    n = env.axis_size(axis)

    def one(a):
        if group is None:
            return a
        if a.shape[scatter_axis] % n:
            raise ValueError(f"dim {scatter_axis} of {tuple(a.shape)} not "
                             f"divisible by axis {axis!r} of size {n}")
        chunks = [c.contiguous() for c in a.chunk(n, scatter_axis)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=group)
        return out

    return _map(one, x)


def broadcast(x: Any, axis: str, *, source: int = 0,
              env: MeshEnv | None = None) -> Any:
    """Coordinate ``source``'s value to every member of ``axis``."""
    env = _env(env)
    group = env.group(axis)
    if group is None:
        return x
    src = env.group_ranks(axis)[source]

    def one(a):
        out = a.clone()
        dist.broadcast(out, src=src, group=group)
        return out

    return _map(one, x)


def permute(x: Any, axis: str, perm: Sequence[tuple[int, int]], *,
            env: MeshEnv | None = None) -> Any:
    """Point-to-point over ``axis``: ``perm`` holds ``(src, dst)``
    coordinate pairs; a member that no pair sends to gets zeros."""
    env = _env(env)
    me, ranks = env.axis_index(axis), env.group_ranks(axis)
    group = env.group(axis)

    def one(a):
        out = torch.zeros_like(a)
        ops = []
        for src, dst in perm:
            if src == me and dst == me:
                out.copy_(a)
            elif src == me:
                ops.append(dist.P2POp(dist.isend, a.contiguous(), ranks[dst],
                                      group))
            elif dst == me:
                ops.append(dist.P2POp(dist.irecv, out, ranks[src], group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    return _map(one, x)


def ring_shift(x: Any, axis: str, *, shift: int = 1,
               env: MeshEnv | None = None) -> Any:
    """Rotate the shards around the ring of ``axis`` by ``shift``."""
    n = _env(env).axis_size(axis)
    return permute(x, axis, [(i, (i + shift) % n) for i in range(n)],
                   env=env)


def all_to_all(x: Any, axis: str, *, split_axis: int, concat_axis: int,
               tiled: bool = True, env: MeshEnv | None = None) -> Any:
    """Chunk ``split_axis`` over the members of ``axis``, send chunk j to
    member j, and concatenate what arrives along ``concat_axis`` (or
    stack it there when not ``tiled``)."""
    env = _env(env)
    group = env.group(axis)
    n = env.axis_size(axis)

    def one(a):
        if group is None:
            return a if tiled else a.unsqueeze(concat_axis)
        ins = [c.contiguous() for c in a.chunk(n, split_axis)]
        outs = [torch.empty_like(c) for c in ins]
        dist.all_to_all(outs, ins, group=group)
        return (torch.cat if tiled else torch.stack)(outs, concat_axis)

    return _map(one, x)


def axis_index(axis: AxisName, *, env: MeshEnv | None = None) -> int:
    """This rank's coordinate along ``axis``."""
    return _env(env).axis_index(axis)


def axis_size(axis: AxisName, *, env: MeshEnv | None = None) -> int:
    """The number of members of ``axis``."""
    return _env(env).axis_size(axis)


# ------------------------------ host tier ---------------------------------


def _multi() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def host_all_gather(x: Any) -> np.ndarray:
    """Every process's array, stacked on a new leading axis in rank
    order (``[1, ...]`` in one process)."""
    x = np.asarray(x)
    if not _multi():
        return x[None]
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, x)
    return np.stack(parts)


def host_broadcast(x: Any) -> Any:
    """Process 0's value (any picklable object) on every process."""
    if not _multi():
        return x
    box = [x]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier(name: str = "barrier") -> None:
    """Block until every process reaches this point."""
    del name
    if _multi():
        dist.barrier()
