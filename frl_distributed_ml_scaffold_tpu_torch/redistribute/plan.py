"""The redistribution PLAN compiler: the port of the JAX package's
``redistribute/plan.py``.

``compile_leaf_plan`` takes a leaf's whole shape, its dtype, where it is
now and where it must go, and emits the transfer program: the chunks of
the leaf that each rank sends to each other rank, never a whole copy
staged on every rank (unless the destination is itself whole on every
rank). Nothing here communicates or allocates: a plan is computed from
placements alone, so one process prices a move over a mesh of any size.

A leaf's layout is a ``Placement``: a mesh (``dist/mesh.py``
``MeshEnv``) and a spec in ``parallel/partition.py``'s form (one entry a
dim: None, an axis name, or a tuple of names that split the dim jointly,
major to minor). Rank r holds the region its mesh coordinate gives it: a
split dim of size n over k members gives member i the rows of
``parallel/layout.py`` ``chunk_bounds`` (``ceil(n / k)`` a member, the
last cut at n), so an odd dim splits unevenly, where the JAX package's
``NamedSharding`` refuses to. ``owner`` restricts the holders to one
``pipe`` coordinate (a pipeline stage's parameters). A rank plays the
part of the JAX device at the same mesh coordinate.

The plan is three things at once:

- a program (``redistribute/executor.py`` runs it over
  ``torch.distributed``);
- a cost model: ``bytes_moved`` (the chunks that change rank),
  ``bytes_lower_bound`` (the bytes each destination rank does not
  already hold, the floor any redistribution must move) and
  ``peak_scratch_bytes`` (the largest transient the executor may hold);
- a record the checkpoint restore and the serving seams keep
  (``last_restore_plan``, ``replica_plan``, the re-spread's plans).

Kinds, chosen a leaf:

- ``identity``: every rank already holds its destination region.
- ``collective``: same mesh, and an "atom-clean" spec change (each axis
  atom stays on its dim, moves whole to another, or appears on one side
  only; each dim touched by one change at most; every split even): one
  slice / all_to_all / all_gather program over the atoms' groups.
- ``chunked``: everything else (another mesh, a subset of the ranks,
  uneven splits, unclean changes): point-to-point sends a chunk at a
  time, bounded by the scratch budget.
- ``host``: the source is a tensor every rank can read whole (a file's
  memory map): each rank narrows its own region.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from frl_distributed_ml_scaffold_tpu_torch.dist import collectives
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import AXES, MeshEnv
from frl_distributed_ml_scaffold_tpu_torch.parallel.layout import chunk_bounds

Region = tuple[tuple[int, int], ...]


# --------------------------------------------------------------- dtypes


def dtype_name(dtype) -> str:
    """``float32``, ``bfloat16``, ``int8``, ``float8_e4m3fn``: the JAX
    names, from a torch dtype or a name."""
    return dtype if isinstance(dtype, str) else collectives.dtype_name(dtype)


def itemsize(dtype) -> int:
    return torch.empty((), dtype=getattr(torch, dtype_name(dtype))
                       ).element_size()


# ------------------------------------------------------------ placements


def atoms_of(spec, ndim: int) -> list[tuple[tuple[str, ...], int]] | None:
    """A spec as ``[(atom names, dim)]``; None when it has more entries
    than dims. An entry tuple is ONE atom (its names split the dim
    jointly, major to minor)."""
    entries = list(spec)
    if len(entries) > ndim:
        return None
    out = []
    for dim, e in enumerate(entries):
        if e is None:
            continue
        names = (e,) if isinstance(e, str) else tuple(e)
        if names:
            out.append((names, dim))
    return out


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf lives: split over ``env`` by ``spec``, held by the
    ranks of the ``pipe`` coordinate ``owner`` only when it is set."""

    env: MeshEnv
    spec: tuple
    owner: int | None = None

    @property
    def ranks(self) -> list[int]:
        """The ranks that hold a region, in mesh order."""
        return [r for r, _ in self._coords()]

    def _coords(self):
        for idx in np.ndindex(*self.env.ranks.shape):
            c = dict(zip(AXES, idx))
            if self.owner is not None and c["pipe"] != self.owner:
                continue
            yield int(self.env.ranks[idx]), c

    def holds(self, rank: int) -> bool:
        return rank in self.ranks

    def regions(self, shape: Sequence[int]) -> dict[int, Region]:
        """Every holding rank's region of a leaf of whole ``shape``."""
        atoms = atoms_of(self.spec, len(shape))
        if atoms is None:
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"{len(shape)} dims of {tuple(shape)}")
        sizes = self.env.shape
        out = {}
        for rank, c in self._coords():
            region = [(0, int(n)) for n in shape]
            for names, dim in atoms:
                k, i = 1, 0
                for n in names:
                    k *= sizes[n]
                    i = i * sizes[n] + c[n]
                region[dim] = chunk_bounds(int(shape[dim]), k, i)
            out[rank] = tuple(region)
        return out

    def describe(self) -> str:
        owner = "" if self.owner is None else f" pipe={self.owner}"
        return f"{tuple(self.spec)}{owner}"


@dataclasses.dataclass(frozen=True)
class Abstract:
    """A leaf as the plan sees it: its whole shape, its dtype and where
    it lives now (None: a host tensor every rank can read)."""

    shape: tuple[int, ...]
    dtype: str
    placement: Placement | None

    @classmethod
    def of(cls, shape, dtype, placement) -> "Abstract":
        return cls(tuple(int(s) for s in shape), dtype_name(dtype),
                   placement)


# --------------------------------------------------------------- regions


def _region_size(region: Region) -> int:
    n = 1
    for a, b in region:
        n *= max(0, b - a)
    return n


def _intersect(r1: Region, r2: Region) -> Region | None:
    out = []
    for (a1, b1), (a2, b2) in zip(r1, r2):
        a, b = max(a1, a2), min(b1, b2)
        if a >= b:
            return None
        out.append((a, b))
    return tuple(out)


def _split_region(region: Region, limit_elems: int) -> list[Region]:
    """A region in pieces of at most ``limit_elems`` elements, cut along
    the largest extent first (the chunking that bounds the executor's
    transfer buffers)."""
    if _region_size(region) <= limit_elems or limit_elems <= 0:
        return [region]
    ext = [b - a for a, b in region]
    dim = int(np.argmax(ext))
    a, b = region[dim]
    mid = a + (b - a) // 2
    if mid == a:  # one row of a huge inner extent: cut the next dim
        order = np.argsort(ext)[::-1]
        for d in order[1:]:
            if ext[d] > 1:
                dim = int(d)
                a, b = region[dim]
                mid = a + (b - a) // 2
                break
        else:
            return [region]  # one element over budget: irreducible
    left = region[:dim] + ((a, mid),) + region[dim + 1:]
    right = region[:dim] + ((mid, b),) + region[dim + 1:]
    return _split_region(left, limit_elems) + _split_region(right,
                                                            limit_elems)


# ----------------------------------------------------------- plan objects


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One bounded transfer: the ``index`` region of the whole leaf,
    read on ``src_rank`` and delivered to ``dst_rank`` (equal ranks: a
    local copy, nothing on the wire)."""

    src_rank: int
    dst_rank: int
    index: Region
    nbytes: int

    @property
    def moves(self) -> bool:
        return self.src_rank != self.dst_rank


@dataclasses.dataclass
class Transition:
    """An atom-clean same-mesh spec change (the ``collective`` kind's
    program), built by ``analyze_transition``."""

    #: every source atom as (names, dim): the naive reference gathers
    #: them all (the whole-leaf staging the program exists to avoid).
    src_atoms: list[tuple[tuple[str, ...], int]]
    #: every destination atom as (names, dim).
    dst_atoms: list[tuple[tuple[str, ...], int]]
    #: atoms only in the destination: a local slice, no communication.
    adds: list[tuple[tuple[str, ...], int]]
    #: atoms that change dim: one all_to_all each.
    moves: list[tuple[tuple[str, ...], int, int]]
    #: atoms only in the source: one all_gather each.
    drops: list[tuple[tuple[str, ...], int]]
    axis_sizes: dict[str, int]

    def atom_size(self, names: tuple[str, ...]) -> int:
        return int(np.prod([self.axis_sizes[n] for n in names],
                           dtype=np.int64))


@dataclasses.dataclass
class LeafPlan:
    """The compiled redistribution of ONE leaf."""

    path: str
    shape: tuple[int, ...]
    dtype: str
    src: Placement | None
    dst: Placement
    kind: str  # identity | collective | chunked | host
    chunks: list[Chunk]
    transition: Transition | None
    bytes_moved: int
    bytes_lower_bound: int
    peak_scratch_bytes: int

    @property
    def leaf_bytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * itemsize(self.dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def to_dict(self) -> dict:
        return {
            "path": self.path,
            "shape": list(self.shape),
            "dtype": self.dtype,
            "src": "host" if self.src is None else self.src.describe(),
            "dst": self.dst.describe(),
            "kind": self.kind,
            "leaf_bytes": self.leaf_bytes,
            "bytes_moved": self.bytes_moved,
            "bytes_lower_bound": self.bytes_lower_bound,
            "peak_scratch_bytes": self.peak_scratch_bytes,
            "n_chunks": len(self.chunks),
        }


@dataclasses.dataclass
class RedistributionPlan:
    """A whole tree's redistribution: the leaves' programs and the
    aggregate cost model. The executor stamps ``executed_scratch_bytes``
    (this rank's measured transient peak, held <= ``peak_scratch_bytes``
    by the tests) and ``executed_bytes_sent`` (what this rank sent to
    other ranks)."""

    leaves: list[LeafPlan]
    scratch_limit_bytes: int | None = None
    executed_scratch_bytes: int = 0
    executed_bytes_sent: int = 0

    @property
    def bytes_moved(self) -> int:
        return sum(l.bytes_moved for l in self.leaves)

    @property
    def bytes_lower_bound(self) -> int:
        return sum(l.bytes_lower_bound for l in self.leaves)

    @property
    def peak_scratch_bytes(self) -> int:
        return max((l.peak_scratch_bytes for l in self.leaves), default=0)

    @property
    def total_bytes(self) -> int:
        return sum(l.leaf_bytes for l in self.leaves)

    def kinds(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for l in self.leaves:
            out[l.kind] = out.get(l.kind, 0) + 1
        return dict(sorted(out.items()))

    def to_dict(self) -> dict:
        return {
            "leaves": [l.to_dict() for l in self.leaves],
            "bytes_moved": self.bytes_moved,
            "bytes_lower_bound": self.bytes_lower_bound,
            "peak_scratch_bytes": self.peak_scratch_bytes,
            "total_bytes": self.total_bytes,
            "scratch_limit_bytes": self.scratch_limit_bytes,
        }

    def summary_lines(self) -> list[str]:
        return [
            f"redistribution plan: {len(self.leaves)} leaves "
            + ", ".join(f"{k}={v}" for k, v in self.kinds().items()),
            f"  bytes_moved={self.bytes_moved} "
            f"(lower bound {self.bytes_lower_bound}) "
            f"peak_scratch={self.peak_scratch_bytes} "
            f"of {self.total_bytes} total",
        ]


# ------------------------------------------------------- spec transitions


def analyze_transition(src_spec, dst_spec, env: MeshEnv,
                       shape: Sequence[int]) -> Transition | None:
    """A same-mesh spec change as the atom-clean ``Transition`` the
    collective executor runs, or None when it is not cleanly expressible
    (the plan is then ``chunked``): every source / destination atom pair
    is identical or name-disjoint, each dim is touched by one add, move
    or drop at most, and every split extent divides evenly."""
    sizes = dict(env.shape)
    src_atoms = atoms_of(src_spec, len(shape))
    dst_atoms = atoms_of(dst_spec, len(shape))
    if src_atoms is None or dst_atoms is None:
        return None
    for a, _ in src_atoms:
        for b, _ in dst_atoms:
            if a != b and set(a) & set(b):
                return None
    for atoms in (src_atoms, dst_atoms):
        dims = [d for _, d in atoms]
        if len(dims) != len(set(dims)):
            return None
    src_by_atom = {a: d for a, d in src_atoms}
    dst_by_atom = {a: d for a, d in dst_atoms}
    adds, moves, drops = [], [], []
    for a, d in dst_atoms:
        if a not in src_by_atom:
            adds.append((a, d))
        elif src_by_atom[a] != d:
            moves.append((a, src_by_atom[a], d))
    for a, d in src_atoms:
        if a not in dst_by_atom:
            drops.append((a, d))
    touched = [d for _, d in adds] + [d for _, d in drops]
    for _, sd, dd in moves:
        touched += [sd, dd]
    if len(touched) != len(set(touched)):
        return None
    unchanged_dims = {d for a, d in src_atoms if dst_by_atom.get(a) == d}
    if unchanged_dims & set(touched):
        return None
    tr = Transition(src_atoms=src_atoms, dst_atoms=dst_atoms, adds=adds,
                    moves=moves, drops=drops, axis_sizes=sizes)
    for a, d in src_atoms + dst_atoms:
        if shape[d] % tr.atom_size(a) != 0:
            return None
    for a, _, dd in moves:
        if shape[dd] % tr.atom_size(a) != 0:
            return None
    return tr


def _same_mesh(src: Placement | None, dst: Placement) -> bool:
    return (src is not None and src.owner == dst.owner
            and src.env.ranks.shape == dst.env.ranks.shape
            and np.array_equal(src.env.ranks, dst.env.ranks))


# ------------------------------------------------------------ compilation


def _index_maps(placement: Placement, shape):
    """{rank: region} plus {region: [holder ranks]} for the distinct
    regions of a placement."""
    dev_map = placement.regions(shape)
    holders: dict[Region, list[int]] = {}
    for rank, region in dev_map.items():
        holders.setdefault(region, []).append(rank)
    for ids in holders.values():
        ids.sort()
    return dev_map, holders


def compile_leaf_plan(shape: Sequence[int], dtype: Any,
                      src: Placement | None, dst: Placement, *,
                      scratch_limit_bytes: int | None = None,
                      path: str = "") -> LeafPlan:
    """Compile ONE leaf's redistribution (module docstring) from its
    whole shape, dtype and placements; nothing is allocated."""
    shape = tuple(int(s) for s in shape)
    name = dtype_name(dtype)
    isz = itemsize(name)
    dst_map, _ = _index_maps(dst, shape)
    max_dst_shard = max((_region_size(r) * isz for r in dst_map.values()),
                        default=0)

    def plan(kind, chunks=(), transition=None, moved=0, lower=0, peak=0):
        return LeafPlan(path=path, shape=shape, dtype=name, src=src,
                        dst=dst, kind=kind, chunks=list(chunks),
                        transition=transition, bytes_moved=moved,
                        bytes_lower_bound=lower, peak_scratch_bytes=peak)

    if src is None:
        total = sum(_region_size(r) * isz for r in dst_map.values())
        return plan("host", moved=total, lower=total, peak=max_dst_shard)

    src_map, src_holders = _index_maps(src, shape)
    if sorted(src_map) == sorted(dst_map) and all(
            src_map[d] == dst_map[d] for d in dst_map):
        return plan("identity")

    # The chunk decomposition (the cost model of every kind). Each
    # destination region's cover is its intersection with the distinct
    # source regions; the holder is the destination rank itself when it
    # holds the piece (a free local copy), else the holder with the
    # fewest bytes assigned so far, ties to the lowest rank.
    assigned: dict[int, int] = {}
    chunks: list[Chunk] = []
    lower = 0
    limit_elems = (max(1, scratch_limit_bytes // isz)
                   if scratch_limit_bytes else 0)
    for dst_rank in sorted(dst_map):
        region = dst_map[dst_rank]
        for src_region, holder_ids in sorted(src_holders.items()):
            inter = _intersect(region, src_region)
            if inter is None:
                continue
            nbytes = _region_size(inter) * isz
            if dst_rank in holder_ids:
                holder = dst_rank
            else:
                holder = min(holder_ids,
                             key=lambda h: (assigned.get(h, 0), h))
                lower += nbytes
            assigned[holder] = assigned.get(holder, 0) + nbytes
            pieces = (_split_region(inter, limit_elems) if limit_elems
                      else [inter])
            for piece in pieces:
                chunks.append(Chunk(holder, dst_rank, piece,
                                    _region_size(piece) * isz))
    moved = sum(c.nbytes for c in chunks if c.moves)

    transition = (analyze_transition(src.spec, dst.spec, dst.env, shape)
                  if _same_mesh(src, dst) else None)
    if transition is not None:
        src_local = max((_region_size(r) * isz for r in src_map.values()),
                        default=0)
        # One source shard and one destination shard live a rank.
        return plan("collective", chunks, transition, moved, lower,
                    src_local + max_dst_shard)

    # Chunked: a destination shard's assembly (only when more than one
    # chunk feeds it) plus one chunk in flight.
    per_dst: dict[int, list[Chunk]] = {}
    for c in chunks:
        per_dst.setdefault(c.dst_rank, []).append(c)
    peak = 0
    for dst_rank, cs in per_dst.items():
        shard_bytes = _region_size(dst_map[dst_rank]) * isz
        buf = shard_bytes if len(cs) > 1 else 0
        peak = max(peak, buf + max(c.nbytes for c in cs))
    return plan("chunked", chunks, None, moved, lower, peak)


def compile_tree_plan(tree: dict[str, Abstract], dst: dict[str, Placement],
                      *, scratch_limit_bytes: int | None = None
                      ) -> RedistributionPlan:
    """Compile a flat tree's redistribution: ``tree`` maps each path to
    its ``Abstract`` leaf (whole shape, dtype, current placement), ``dst``
    each path to its destination placement, in the same paths."""
    if list(tree) != list(dst):
        missing = sorted(set(tree) ^ set(dst))[:5]
        raise ValueError(
            f"tree has {len(tree)} leaves and dst {len(dst)}; the paths "
            f"must match (differing: {missing})")
    return RedistributionPlan(
        leaves=[compile_leaf_plan(leaf.shape, leaf.dtype, leaf.placement,
                                  dst[path],
                                  scratch_limit_bytes=scratch_limit_bytes,
                                  path=path)
                for path, leaf in tree.items()],
        scratch_limit_bytes=scratch_limit_bytes)


# ------------------------------------------------- restore (even) layouts


def restore_layout_spec(shape: Sequence[int], target_spec, env: MeshEnv,
                        *, owner: int | None = None) -> tuple:
    """The memory-efficient RESTORE layout of a checkpoint leaf: the
    target spec with every populated axis the target does not use laid
    onto the largest unsplit dim it divides, so each rank reads about
    1/N of the leaf and the move to the target is a pure drop program
    (tiled all-gathers on their own dims). Axes that fit nowhere are shed
    from the minor end. Under ``owner`` (one pipeline stage holds the
    leaf) ``pipe`` is not laid on."""
    sizes = env.shape
    entries = list(target_spec) + [None] * (len(shape) - len(target_spec))
    used: set[str] = set()
    for e in entries:
        if e is not None:
            used.update((e,) if isinstance(e, str) else e)
    remaining = [a for a in AXES if sizes[a] > 1 and a not in used
                 and not (owner is not None and a == "pipe")]
    while remaining:
        size = int(np.prod([sizes[a] for a in remaining], dtype=np.int64))
        cands = [i for i, (dim, e) in enumerate(zip(shape, entries))
                 if e is None and dim % size == 0 and dim >= size]
        if cands:
            best = max(cands, key=lambda i: shape[i])
            entries[best] = (remaining[0] if len(remaining) == 1
                             else tuple(remaining))
            return tuple(entries)
        remaining = remaining[:-1]
    return tuple(entries)
