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

**Async tier**, what the overlap schedule needs (``ops/
collective_matmul.py``'s rings, ``parallel/fsdp_overlap.py``'s block
gathers): ``exchange_start`` posts one ring hop's sends and receives
over an axis and ``all_gather_start`` one all-gather along a dim; each
returns a ``Pending`` whose ``wait()`` gives the received tensors, so
the caller computes between the post and the wait (the ring attention's
hops too). ``reduce_scatter_dim``
(and ``all_gather_dim``, the wait of ``all_gather_start``) handle a dim
the axis does not divide by the padded bounds of ``parallel/layout.py``.
``wire_bytes`` counts the bytes this process sends point to point, and
its chunks of ``all_to_all`` bound for the other members, by axis and
dtype, at the send (payloads and scales alike). ``all_to_all`` posts
its chunks point to point too: not every gloo build has the collective,
and NCCL's is grouped sends and receives all the same.

A gloo group does not take CUDA tensors in point-to-point sends, all-
gathers or reduce-scatters, so on a gloo group a CUDA tensor is staged
through pinned host memory there and back (``staged_bytes`` counts what
was staged, by collective); an NCCL group takes the device tensor as it
is, and nothing is staged on the CPU.

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
    stack it there when not ``tiled``). The chunks sent to the other
    members count in ``wire_bytes``."""
    env = _env(env)
    group = env.group(axis)
    n = env.axis_size(axis)

    def one(a):
        if group is None:
            return a if tiled else a.unsqueeze(concat_axis)
        ins = [c.contiguous() for c in a.chunk(n, split_axis)]
        me = env.axis_index(axis)
        others = [(c, j) for j, c in enumerate(ins) if j != me]
        outs = exchange_start(others, others, axis, env=env).wait()
        outs.insert(me, ins[me])
        return (torch.cat if tiled else torch.stack)(outs, concat_axis)

    return _map(one, x)


def axis_index(axis: AxisName, *, env: MeshEnv | None = None) -> int:
    """This rank's coordinate along ``axis``."""
    return _env(env).axis_index(axis)


def axis_size(axis: AxisName, *, env: MeshEnv | None = None) -> int:
    """The number of members of ``axis``."""
    return _env(env).axis_size(axis)


# ------------------------------ async tier --------------------------------

#: Bytes this process sent point to point: ``{axis: {dtype: bytes}}``.
wire_bytes: dict[str, dict[str, int]] = {}

#: Bytes staged through pinned host memory for gloo, by collective.
staged_bytes: dict[str, int] = {"p2p": 0, "all_gather": 0,
                                "reduce_scatter": 0}


def reset_counters() -> None:
    wire_bytes.clear()
    for k in staged_bytes:
        staged_bytes[k] = 0


def dtype_name(dtype: torch.dtype) -> str:
    """``float32``, ``int8``, ``float8_e4m3fn``: the JAX dtype names."""
    return str(dtype).removeprefix("torch.")


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor, kind: str) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    staged_bytes[kind] += t.numel() * t.element_size()
    return host


class Pending:
    """Posted communication; ``wait()`` finishes it and returns what it
    produced (``finish`` of the received tensors)."""

    def __init__(self, reqs, finish):
        self._reqs, self._finish, self._out = reqs, finish, None
        self._done = False

    def wait(self):
        if not self._done:
            for r in self._reqs:
                r.wait()
            self._out = self._finish()
            self._done = True
        return self._out


def exchange_start(sends: Sequence[tuple[torch.Tensor, int]],
                   recvs: Sequence[tuple[torch.Tensor, int]], axis: str, *,
                   env: MeshEnv | None = None) -> Pending:
    """Post point-to-point sends ``(tensor, dst coordinate)`` and
    receives ``(like, src coordinate)`` over ``axis`` in one batch; the
    ``Pending`` gives the received tensors (shaped and typed like their
    ``like``) in order. Counts the sent bytes in ``wire_bytes``."""
    env = _env(env)
    ranks, group = env.group_ranks(axis), env.group(axis)
    counts = wire_bytes.setdefault(axis, {})
    ops, outs, back = [], [], []
    for t, dst in sends:
        t = t.contiguous()
        name = dtype_name(t.dtype)
        counts[name] = counts.get(name, 0) + t.numel() * t.element_size()
        if _staged(group, t):
            t = _to_host(t, "p2p")
        ops.append(dist.P2POp(dist.isend, t, ranks[dst], group))
    for like, src in recvs:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device=like.device)
        if _staged(group, buf):
            host = torch.empty(like.shape, dtype=like.dtype,
                               pin_memory=True)
            back.append((buf, host))
            staged_bytes["p2p"] += buf.numel() * buf.element_size()
            ops.append(dist.P2POp(dist.irecv, host, ranks[src], group))
        else:
            ops.append(dist.P2POp(dist.irecv, buf, ranks[src], group))
        outs.append(buf)
    reqs = dist.batch_isend_irecv(ops) if ops else []

    def finish():
        for buf, host in back:
            buf.copy_(host)
        return outs

    return Pending(reqs, finish)


def all_gather_start(x: torch.Tensor, axis: str, dim: int, n: int, *,
                     env: MeshEnv | None = None) -> Pending:
    """Post the all-gather over ``axis`` of ``x``, this member's chunk of
    a dim ``dim`` of size ``n``; the ``Pending`` gives the whole tensor
    (the short last chunk padded for the exchange, then cut)."""
    env = _env(env)
    group, k = env.group(axis), env.axis_size(axis)
    c = -(-n // k)
    if x.shape[dim] < c:
        pad = list(x.shape)
        pad[dim] = c - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim)
    x = x.contiguous()
    dev = x.device
    if _staged(group, x):
        x = _to_host(x, "all_gather")
    parts = [torch.empty_like(x) for _ in range(k)]
    req = dist.all_gather(parts, x, group=group, async_op=True)
    return Pending([req], lambda: torch.cat(parts, dim).narrow(
        dim, 0, n).to(dev))


def all_gather_dim(x: torch.Tensor, axis: str, dim: int, n: int, *,
                   env: MeshEnv | None = None) -> torch.Tensor:
    """``all_gather_start(...).wait()``."""
    return all_gather_start(x, axis, dim, n, env=env).wait()


def reduce_scatter_dim(g: torch.Tensor, axis: str, dim: int, *,
                       env: MeshEnv | None = None) -> torch.Tensor:
    """The sum of ``g`` over the members of ``axis``, and this member's
    chunk of ``dim`` by the padded bounds (``ceil(n / k)`` rows a
    member, the last cut at n)."""
    env = _env(env)
    group, k, i = env.group(axis), env.axis_size(axis), env.axis_index(axis)
    n = g.shape[dim]
    c = -(-n // k)
    if c * k != n:
        pad = list(g.shape)
        pad[dim] = c * k - n
        g = torch.cat([g, g.new_zeros(pad)], dim)
    dev = g.device
    chunks = [ch.contiguous() for ch in g.chunk(k, dim)]
    if _staged(group, g):
        chunks = [_to_host(ch, "reduce_scatter") for ch in chunks]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    lo, hi = min(i * c, n), min((i + 1) * c, n)
    return out.narrow(dim, 0, hi - lo).to(dev)


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
