"""The redistribution plan EXECUTOR: the port of the JAX package's
``redistribute/executor.py``, over ``torch.distributed``.

Every rank runs ``execute`` on the same plan with its own local tensors
and gets its own destination tensors back; a rank that holds nothing of
a leaf on one side takes part all the same (it sends, receives, or does
nothing, as the plan says). By kind:

- ``collective``: the atoms' groups of the mesh (``MeshEnv.group``):
  first the adds (a local slice), then one all_to_all a move, then one
  tiled all-gather over every dropped atom at once, each atom on its own
  dim (the bytes sent are those of one gather a drop). Each makes its
  output once and fills it in place, a group member a round by point to
  point sends, so beside it a rank holds at most one block in flight.
  ``NAIVE_GATHER_SCATTER`` switches the body to the naive reference,
  which gathers every source atom (the whole leaf on every rank) and
  then slices the destination back out: the oracle the tests hold the
  program to, and what it must not do.
- ``chunked``: point-to-point sends over the world group, a round at a
  time, in which a rank sends or receives one chunk at most; a chunk
  lands straight in the destination tensor where its place there is
  contiguous, so a rank holds its destination shard and one chunk in
  flight at most.
- ``host``: each rank narrows its own region of a tensor it can read
  whole (a checkpoint file's memory map) and copies it to the device.

On a gloo group a CUDA tensor is staged through pinned host memory,
there and back (``collectives.staged_bytes`` counts it), as the
collectives do; NCCL takes it as it is.

Bookkeeping: ``execute`` stamps ``executed_scratch_bytes`` and
``executed_bytes_sent`` on the plan. The first is MEASURED
(``_Transient``): the most bytes that the tensors allocated while one
leaf moved held on the destination device at once, besides the leaf's
destination tensor (its result, which the port assembles in place) and
its source; the tests and the card hold it to the plan's
``peak_scratch_bytes``, which also counts a destination shard (the JAX
cost model's assembly window), so a move that held more than one chunk
in flight, or staged a whole leaf, fails that check. The second is the
bytes this rank sent to other ranks, its sends to itself left out
(summed over the ranks it equals ``bytes_moved``), also added to
``sent_bytes`` by kind.
``donate=True`` releases each source leaf's storage as soon as its
destination exists, before the next leaf moves, so a tree moves with
one leaf's source and destination live, not two trees. A failed plan or
send raises; nothing falls back to another path.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from frl_distributed_ml_scaffold_tpu_torch.dist.collectives import (
    _staged,
    _to_host,
)
from frl_distributed_ml_scaffold_tpu_torch.dist.initialize import (
    process_index,
)
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import AXES, MeshEnv
from frl_distributed_ml_scaffold_tpu_torch.redistribute.plan import (
    LeafPlan,
    Region,
    RedistributionPlan,
    Transition,
)

#: True swaps every collective program for the naive reference (module
#: docstring): the tests' oracle.
NAIVE_GATHER_SCATTER = False

#: Bytes this process sent to other ranks, by plan kind.
sent_bytes: dict[str, int] = {"collective": 0, "chunked": 0, "host": 0}


def reset_counters() -> None:
    for k in sent_bytes:
        sent_bytes[k] = 0


def _rel(index: Region, base: Region) -> tuple[slice, ...]:
    """A whole-leaf region as slices relative to ``base``'s origin."""
    return tuple(slice(a - b0, b - b0)
                 for (a, b), (b0, _) in zip(index, base))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes, flat (every dtype travels as uint8: gloo has no
    fp8)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


# ------------------------------------------------------------- transport


def _exchange(sends, recvs, group=None) -> int:
    """Post ``sends`` and ``recvs`` (``[(view, peer global rank)]``) as
    one batch and wait for it. A view that is contiguous travels as it
    is: it is sent from, or received into, in place. Another one goes
    through a contiguous copy (a send) or a contiguous buffer copied in
    after (a receive). Over gloo a CUDA tensor is staged through pinned
    host memory. Returns the bytes sent."""
    ops, after, sent = [], [], 0
    for view, peer in sends:
        t = _bytes(view if view.is_contiguous() else view.contiguous())
        sent += _nbytes(t)
        if _staged(group, t):
            t = _to_host(t, "p2p")
        ops.append(dist.P2POp(dist.isend, t, peer, group))
    for view, peer in recvs:
        buf = view if view.is_contiguous() else torch.empty(
            view.shape, dtype=view.dtype, device=view.device)
        b = _bytes(buf)
        host = None
        if _staged(group, b):
            host = torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
        ops.append(dist.P2POp(dist.irecv, b if host is None else host,
                              peer, group))
        after.append((view, buf, b, host))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for view, buf, b, host in after:
        if host is not None:
            b.copy_(host)
        if buf is not view:
            view.copy_(buf)
    return sent


# ------------------------------------------------------------ collective


def _atom_index(env: MeshEnv, rank: int, names: tuple[str, ...]) -> int:
    """``rank``'s flattened index within an atom's group (major to minor
    in the atom's own order)."""
    c = dict(zip(AXES, (int(i) for i in np.argwhere(env.ranks == rank)[0])))
    idx = 0
    for n in names:
        idx = idx * env.shape[n] + c[n]
    return idx


def _members(env: MeshEnv, names: tuple[str, ...]) -> list[int]:
    """The global ranks of this rank's group over ``names``, in the
    atom's index order."""
    ranks = env.group_ranks(names)
    return sorted(ranks, key=lambda r: _atom_index(env, r, names))


def _gather(x: torch.Tensor, env: MeshEnv, atoms) -> torch.Tensor:
    """Tiled all-gather of ``x`` over the atoms ``[(names, dim)]`` at
    once: every member's ``x`` lands in the block its index in each atom
    gives it on that atom's dim. The output is made once and filled in
    place, a member a round (round s: send to the member s after this
    one, receive from the member s before it), so one received block at
    most is held beside it."""
    names = tuple(n for a, _ in atoms for n in a)
    group = env.group(names)
    if group is None:
        return x
    members = _members(env, names)
    k, me = len(members), members.index(env.rank)
    shape = list(x.shape)
    for a, dim in atoms:
        shape[dim] *= int(np.prod([env.shape[n] for n in a]))
    out = torch.empty(shape, dtype=x.dtype, device=x.device)

    def block(r: int) -> torch.Tensor:
        v = out
        for a, dim in atoms:
            n = x.shape[dim]
            v = v.narrow(dim, _atom_index(env, r, a) * n, n)
        return v

    block(env.rank).copy_(x)
    xc = x if x.is_contiguous() else x.contiguous()
    for s in range(1, k):
        frm = members[(me - s) % k]
        sent_bytes["collective"] += _exchange(
            [(xc, members[(me + s) % k])], [(block(frm), frm)], group)
    return out


def _all_to_all(x: torch.Tensor, env: MeshEnv, names, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    """Chunk ``split_dim`` over the atom's members, chunk j to member j,
    and concatenate what arrives along ``concat_dim``: into one output
    made once, a member a round, as ``_gather`` does."""
    group = env.group(names)
    if group is None:
        return x
    members = _members(env, names)
    k, me = len(members), members.index(env.rank)
    s_len = x.shape[split_dim] // k
    c_len = x.shape[concat_dim]
    shape = list(x.shape)
    shape[split_dim], shape[concat_dim] = s_len, c_len * k
    out = torch.empty(shape, dtype=x.dtype, device=x.device)

    def piece(j: int) -> torch.Tensor:
        return x.narrow(split_dim, j * s_len, s_len)

    def slot(j: int) -> torch.Tensor:
        return out.narrow(concat_dim, j * c_len, c_len)

    slot(me).copy_(piece(me))
    for s in range(1, k):
        to, frm = (me + s) % k, (me - s) % k
        sent_bytes["collective"] += _exchange(
            [(piece(to), members[to])], [(slot(frm), members[frm])], group)
    return out


def _slice_atom(x: torch.Tensor, env: MeshEnv, names, dim: int
                ) -> torch.Tensor:
    k = int(np.prod([env.shape[n] for n in names]))
    piece = x.shape[dim] // k
    return x.narrow(dim, _atom_index(env, env.rank, names) * piece, piece)


def _collective_body(tr: Transition, x: torch.Tensor, env: MeshEnv
                     ) -> torch.Tensor:
    """Adds (a local slice) first, moves (all_to_all) next, drops (one
    tiled all-gather over every dropped atom, each on its own dim)
    last."""
    for names, dim in tr.adds:
        x = _slice_atom(x, env, names, dim)
    for names, src_dim, dst_dim in tr.moves:
        x = _all_to_all(x, env, names, dst_dim, src_dim)
    if tr.drops:
        x = _gather(x, env, tr.drops)
    return x


def _naive_body(tr: Transition, x: torch.Tensor, env: MeshEnv
                ) -> torch.Tensor:
    """The whole-leaf staging reference: gather EVERY source atom, then
    slice every destination atom back out."""
    for atom in tr.src_atoms:
        x = _gather(x, env, [atom])
    for names, dim in tr.dst_atoms:
        x = _slice_atom(x, env, names, dim)
    return x


def _execute_collective(plan: LeafPlan, x: torch.Tensor) -> torch.Tensor:
    env = plan.dst.env
    body = _naive_body if NAIVE_GATHER_SCATTER else _collective_body
    out = body(plan.transition, x, env)
    if (out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
            or not out.is_contiguous()):
        out = out.clone(memory_format=torch.contiguous_format)
    return out


# --------------------------------------------------------------- chunked


def _rounds(chunks) -> list[list]:
    """The moving chunks in rounds, first fit in the plan's order: a rank
    sends or receives one chunk a round at most, so it never holds more
    than one chunk in flight."""
    rounds, busy = [], []
    for c in chunks:
        if not c.moves:
            continue
        for r, ranks in enumerate(busy):
            if c.src_rank not in ranks and c.dst_rank not in ranks:
                break
        else:
            r = len(rounds)
            rounds.append([])
            busy.append(set())
        rounds[r].append(c)
        busy[r] |= {c.src_rank, c.dst_rank}
    return rounds


def _execute_chunked(plan: LeafPlan, x: torch.Tensor | None, me: int,
                     device) -> tuple[torch.Tensor | None, int]:
    """Point-to-point chunk moves (module docstring), a round at a time
    (``_rounds``). The destination tensor is made when the first chunk
    arrives (a rank's sends before then hold no destination beside
    them), a chunk lands straight in its place there when that place is
    contiguous, and is sent straight from the source's when that is; the
    chunks this rank holds itself are copied in last. Returns this
    rank's destination tensor (None when it holds none) and the bytes it
    sent."""
    src_map = plan.src.regions(plan.shape)
    dst_map = plan.dst.regions(plan.shape)
    my_src, my_dst = src_map.get(me), dst_map.get(me)
    box: list[torch.Tensor] = []

    def dst() -> torch.Tensor:
        if not box:
            box.append(torch.empty(tuple(b - a for a, b in my_dst),
                                   dtype=plan.torch_dtype, device=device))
        return box[0]

    sent = 0
    for chunks in _rounds(plan.chunks):
        sends = [(x[_rel(c.index, my_src)], c.dst_rank)
                 for c in chunks if c.src_rank == me]
        recvs = [(dst()[_rel(c.index, my_dst)], c.src_rank)
                 for c in chunks if c.dst_rank == me]
        if sends or recvs:
            sent += _exchange(sends, recvs)
    for c in plan.chunks:
        if not c.moves and c.dst_rank == me:
            dst()[_rel(c.index, my_dst)] = x[_rel(c.index, my_src)]
    sent_bytes["chunked"] += sent
    return (dst() if my_dst is not None else None), sent


# -------------------------------------------------------------- dispatch


def _check_source(plan: LeafPlan, x: torch.Tensor | None, me: int) -> None:
    """This rank's source tensor is its region of the plan's source, or
    the plan would move the wrong bytes."""
    region = plan.src.regions(plan.shape).get(me)
    if region is None:
        return
    if x is None or tuple(x.shape) != tuple(b - a for a, b in region):
        raise ValueError(
            f"{plan.path}: rank {me} holds "
            f"{None if x is None else tuple(x.shape)}, the plan's source "
            f"region is {region}")


def check_sources(plan: RedistributionPlan, tree: dict[str, Any]) -> None:
    """Raise unless this rank's tensors (``tree`` by path) are its
    regions of every leaf's source: what a caller runs before it touches
    any other state, so a plan that does not fit the tensors fails while
    nothing has moved yet."""
    me = process_index()
    for lp in plan.leaves:
        if lp.src is not None:
            _check_source(lp, tree.get(lp.path), me)


def _run_leaf(plan: LeafPlan, x: torch.Tensor | None, dev
              ) -> tuple[torch.Tensor | None, int]:
    me = process_index()
    if plan.src is not None:
        _check_source(plan, x, me)
    if plan.kind == "identity":
        return x, 0
    if plan.kind == "host":
        region = plan.dst.regions(plan.shape).get(me)
        if region is None:
            return None, 0
        out = x[tuple(slice(a, b) for a, b in region)].to(
            dev, plan.torch_dtype, copy=True).contiguous()
        return out, 0
    if plan.kind == "collective":
        if not plan.src.holds(me):
            return None, 0
        before = sent_bytes["collective"]
        out = _execute_collective(plan, x)
        return out, sent_bytes["collective"] - before
    return _execute_chunked(plan, x, me, dev)


class _Transient(TorchDispatchMode):
    """Measures the scratch of a leaf's move on ``device``: every tensor
    an operator returns there whose storage is new (none of the
    operator's inputs' storages) is held by a weak reference to its
    storage, and after each operator the storages still alive are noted.
    ``peak(out)`` is the most bytes alive at once besides ``out``, the
    leaf's destination tensor (its result, assembled in place): the
    storage alive at the end at ``out``'s address, not an earlier one
    freed there. Neither the source (made before) counts, nor what the
    transport allocates below the operators (gloo's own buffers) or off
    the device (pinned host staging)."""

    def __init__(self, device):
        super().__init__()
        self.device_type = torch.device(device).type
        #: every storage seen, in order: (address, weak reference, bytes)
        self.seen: list[tuple[int, StorageWeakRef, int]] = []
        self.live: dict[int, int] = {}  # address -> index into seen
        self.samples: list[tuple[int, ...]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {t.untyped_storage().data_ptr()
                  for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if (not isinstance(t, torch.Tensor)
                    or t.device.type != self.device_type):
                continue
            st = t.untyped_storage()
            ptr = st.data_ptr()
            if not ptr or ptr in inputs:
                continue
            i = self.live.get(ptr)
            if i is None or self.seen[i][1].expired():
                self.live[ptr] = len(self.seen)
                self.seen.append((ptr, StorageWeakRef(st), st.nbytes()))
        self.live = {p: i for p, i in self.live.items()
                     if not self.seen[i][1].expired()}
        self.samples.append(tuple(self.live.values()))
        return out

    def peak(self, out: torch.Tensor | None) -> int:
        skip = None
        if out is not None:
            skip = self.live.get(out.untyped_storage().data_ptr())
            if skip is not None and self.seen[skip][1].expired():
                skip = None
        return max((sum(self.seen[i][2] for i in s if i != skip)
                    for s in self.samples), default=0)


def _release(x: torch.Tensor, keep: torch.Tensor | None) -> None:
    """Free ``x``'s storage when it is its own (not a view into a larger
    buffer) and ``keep`` does not share it."""
    if keep is not None and keep.untyped_storage().data_ptr() == \
            x.untyped_storage().data_ptr():
        return
    st = x.untyped_storage()
    if x.storage_offset() == 0 and st.nbytes() == _nbytes(x):
        st.resize_(0)


def execute(plan: RedistributionPlan, tree: dict[str, Any], *,
            donate: bool = True, device=None) -> dict[str, torch.Tensor]:
    """Run a tree plan leaf by leaf on this rank's source tensors
    (``tree`` by path; a path this rank holds nothing of may be absent
    or None). Returns this rank's destination tensors by path (the paths
    it holds a region of). ``device`` places what this rank receives
    (default: the source tensor's device). With ``donate`` each source
    leaf's storage is released once its destination exists. Stamps
    ``executed_scratch_bytes`` and ``executed_bytes_sent`` on the plan."""
    me = process_index()
    peak, sent = 0, 0
    dev = device
    if dev is None:
        dev = next((t.device for t in tree.values()
                    if isinstance(t, torch.Tensor)), None)
    out: dict[str, torch.Tensor] = {}
    for lp in plan.leaves:
        x = tree.get(lp.path)
        leaf_dev = dev if dev is not None else (
            x.device if x is not None else torch.device("cpu"))
        with _Transient(leaf_dev) as transient:
            y, n = _run_leaf(lp, x, leaf_dev)
        peak = max(peak, transient.peak(y))
        sent += n
        if lp.dst.holds(me):
            if y is None:
                raise RuntimeError(f"{lp.path}: rank {me} got no tensor "
                                   "for its destination region")
            out[lp.path] = y
        if (donate and x is not None and lp.kind != "host"
                and lp.kind != "identity"):
            _release(x, y)
    plan.executed_scratch_bytes = peak
    plan.executed_bytes_sent = sent
    return out
