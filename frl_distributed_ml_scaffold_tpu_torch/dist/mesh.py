"""The logical device mesh over the run's ranks: the port of the JAX
package's ``dist/mesh.py``.

One process per rank, one rank per device. The mesh names the same
parallelism axes as the JAX mesh, in the same order (``AXES``), and lays
the ranks out over them as the JAX package lays its devices out on the
CPU: row-major over ``AXES``, and with ``dcn_data > 1`` the DCN factor
as the OUTER component of the ``data`` axis (consecutive rank groups
form the "slices", and only the data-axis collective crosses them).

``MeshEnv`` holds, besides the axis sizes and this rank's coordinates,
one ``torch.distributed`` group for every set of populated axes (an
axis of size 1 needs none): the group of the ranks that differ from
this one only along those axes, in the order of their coordinates
(``group``). The collectives (``dist/collectives.py``) run over them by
axis name. The groups are created when the mesh is built, by every rank
in the same order, as ``torch.distributed.new_group`` requires. A mesh
of one device creates none, needs no process group, and every
collective over it is the identity. ``build_mesh(...,
unit_groups=True)`` also creates the groups of ``UNIT_AXES`` at size 1,
so every collective of the step runs, over one rank a copy: how one card
drives the mesh path's collectives.

Batch semantics, the JAX package's: FSDP is data parallelism with the
parameters sharded, so the global batch shards over ``("data",
"fsdp")`` jointly (``BATCH_AXES``); ranks that differ only along
``model``, ``expert`` or ``pipe`` hold the same rows. Ranks along
``seq`` hold the same rows and split their tokens, so the global loss is
the mean over ``LOSS_AXES`` of the ranks' means.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field

import numpy as np
import torch.distributed as dist

from frl_distributed_ml_scaffold_tpu_torch.config.schema import MeshConfig
from frl_distributed_ml_scaffold_tpu_torch.dist.initialize import (
    process_count,
    process_index,
)

# The JAX package's canonical axis order (collective-heaviest last).
AXES: tuple[str, ...] = ("pipe", "data", "fsdp", "seq", "expert", "model")

# Axes that jointly shard the global batch dimension.
BATCH_AXES: tuple[str, ...] = ("data", "fsdp")

# Axes whose ranks hold distinct tokens of the global batch: the batch
# axes and ``seq``.
LOSS_AXES: tuple[str, ...] = BATCH_AXES + ("seq",)

# The axes whose groups ``build_mesh(unit_groups=True)`` keeps at size 1.
UNIT_AXES: tuple[str, ...] = ("data", "fsdp", "model")


def _axes_key(axes) -> tuple[str, ...]:
    """Axis names in ``AXES`` order (a name or a tuple of names)."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    unknown = set(names) - set(AXES)
    if unknown:
        raise KeyError(f"unknown mesh axes {sorted(unknown)}; have {AXES}")
    return tuple(a for a in AXES if a in names)


@dataclass(frozen=True)
class MeshEnv:
    """A resolved mesh: its config, the rank at every coordinate
    (``ranks``, shape ``[sizes of AXES]``), this rank and the groups of
    its populated axis sets; the object the trainer passes around."""

    config: MeshConfig
    ranks: np.ndarray
    rank: int = 0
    unit_groups: bool = False
    _groups: dict = field(default_factory=dict, repr=False, compare=False)

    @functools.cached_property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.ranks.shape))

    @property
    def num_devices(self) -> int:
        return int(self.ranks.size)

    @property
    def member(self) -> bool:
        """Whether this rank is one of the mesh's (a mesh over a subset
        of the world's ranks leaves the others out)."""
        return bool((self.ranks == self.rank).any())

    def axis_size(self, name) -> int:
        """The size of an axis, or the product over a tuple of axes."""
        return int(np.prod([self.shape[a] for a in _axes_key(name)]))

    @property
    def batch_axis_size(self) -> int:
        return self.axis_size(BATCH_AXES)

    @property
    def loss_axis_size(self) -> int:
        return self.axis_size(LOSS_AXES)

    @functools.cached_property
    def coords(self) -> dict[str, int]:
        """This rank's coordinate along every axis."""
        where = np.argwhere(self.ranks == self.rank)[0]
        return dict(zip(AXES, (int(i) for i in where)))

    def axis_index(self, name) -> int:
        """This rank's coordinate along an axis, or its row-major index
        over a tuple of axes (in ``AXES`` order)."""
        idx, c = 0, self.coords
        for a in _axes_key(name):
            idx = idx * self.shape[a] + c[a]
        return idx

    @property
    def batch_index(self) -> int:
        """This rank's share of the global batch: its index over
        ``BATCH_AXES``."""
        return self.axis_index(BATCH_AXES)

    def group_ranks(self, axes) -> list[int]:
        """The ranks that differ from this one only along ``axes``, in
        the order of their coordinates there."""
        key, c = _axes_key(axes), self.coords
        idx = tuple(slice(None) if a in key else c[a] for a in AXES)
        return [int(r) for r in self.ranks[idx].reshape(-1)]

    def _kept(self, axis: str) -> bool:
        return self.shape[axis] > 1 or (self.unit_groups
                                        and axis in UNIT_AXES)

    def group(self, axes):
        """The process group over ``axes`` (this rank's coset), or None
        when they span one rank (nothing to communicate; but see
        ``unit_groups``)."""
        key = tuple(a for a in _axes_key(axes) if self._kept(a))
        if not key:
            return None
        return self._groups[key]


def resolve_axis_sizes(cfg: MeshConfig, n_devices: int) -> dict[str, int]:
    """Fill the ``-1`` wildcard axis and validate the product."""
    sizes = cfg.axis_sizes()
    wild = [k for k, v in sizes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {wild}")
    fixed = int(np.prod([v for v in sizes.values() if v != -1]))
    if wild:
        if n_devices % fixed != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes product "
                f"{fixed}"
            )
        sizes[wild[0]] = n_devices // fixed
    total = int(np.prod(list(sizes.values())))
    if total != n_devices:
        raise ValueError(
            f"mesh {sizes} needs {total} devices but {n_devices} are "
            "available"
        )
    return sizes


def rank_layout(cfg: MeshConfig, n_devices: int) -> np.ndarray:
    """The rank at every mesh coordinate, ``[sizes of AXES]``: row-major,
    and with ``dcn_data > 1`` the JAX package's manual hybrid layout (the
    DCN factor the outer component of ``data``)."""
    sizes = resolve_axis_sizes(cfg, n_devices)
    shape = tuple(sizes[a] for a in AXES)
    ranks = np.arange(n_devices)
    if cfg.dcn_data <= 1:
        return ranks.reshape(shape)
    if sizes["data"] % cfg.dcn_data != 0:
        raise ValueError(
            f"data axis {sizes['data']} not divisible by "
            f"dcn_data={cfg.dcn_data}"
        )
    ici_shape = tuple(sizes[a] // cfg.dcn_data if a == "data" else sizes[a]
                      for a in AXES)
    arr = ranks.reshape((cfg.dcn_data,) + ici_shape)
    # [dcn, pipe, data_ici, ...] -> [pipe, dcn, data_ici, ...]
    return np.moveaxis(arr, 0, 1).reshape(shape)


def one_rank_mesh() -> MeshEnv:
    """The mesh of this process alone (rank 0's coordinates, no group):
    where a layout is asked of a run that has no mesh."""
    cfg = MeshConfig(data=1)
    return MeshEnv(config=cfg, ranks=rank_layout(cfg, 1))


def build_mesh(cfg: MeshConfig, num_devices: int | None = None, *,
               unit_groups: bool = False) -> MeshEnv:
    """The mesh of ``cfg`` over the run's ranks (``num_devices``
    defaults to the process count), with the groups of every set of its
    populated axes (and of ``UNIT_AXES`` with ``unit_groups``). Every
    rank must call it, with the same config."""
    n = process_count() if num_devices is None else num_devices
    ranks = rank_layout(cfg, n)
    env = MeshEnv(config=cfg, ranks=ranks, rank=process_index(),
                  unit_groups=unit_groups)
    populated = [a for a in AXES if env._kept(a)]
    if populated and not dist.is_initialized():
        raise RuntimeError(
            f"mesh {env.shape} spans {n} ranks but no process group is "
            "initialised (dist.initialize_distributed)")
    for k in range(1, len(populated) + 1):
        for key in itertools.combinations(populated, k):
            keep = [i for i, a in enumerate(AXES) if a in key]
            other = [i for i in range(len(AXES)) if i not in keep]
            moved = np.transpose(ranks, other + keep).reshape(
                -1, int(np.prod([ranks.shape[i] for i in keep])))
            for coset in moved:
                members = [int(r) for r in coset]
                if members != sorted(members):
                    # Group ranks follow the global ranks' order; the
                    # collectives index shards by coordinate.
                    raise NotImplementedError(
                        f"mesh {env.shape} with dcn_data={cfg.dcn_data}: "
                        f"the ranks of axes {key} are not in coordinate "
                        "order")
                group = dist.new_group(members)
                if env.rank in members:
                    env._groups[key] = group
    return env


# ---------------------------------------------------------------------------
# The current mesh: the modules that take part in a collective inside the
# forward (sync-BN, the tensor-parallel products, dropout's row offsets)
# read it. The Trainer sets it around every step.
# ---------------------------------------------------------------------------

_CURRENT_ENV: MeshEnv | None = None


def set_current_mesh(env: MeshEnv | None) -> None:
    global _CURRENT_ENV
    _CURRENT_ENV = env


def current_mesh_env() -> MeshEnv | None:
    return _CURRENT_ENV


class mesh_context:
    """Scoped current mesh: ``with mesh_context(env): ...``."""

    def __init__(self, env: MeshEnv | None):
        self.env = env
        self._prev: MeshEnv | None = None

    def __enter__(self):
        self._prev = current_mesh_env()
        set_current_mesh(self.env)
        return self.env

    def __exit__(self, *exc):
        set_current_mesh(self._prev)
        return False


def local_batch_size(global_batch_size: int,
                     env: MeshEnv | None = None) -> int:
    """This rank's rows of the global batch: ``global / batch axes``
    (ranks along ``model`` draw the same rows). Validates evenness."""
    n = 1 if env is None else env.batch_axis_size
    if global_batch_size % n != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by batch mesh "
            f"axes ({n})"
        )
    return global_batch_size // n
