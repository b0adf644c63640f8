"""The mesh: the successor of the ps/worker ClusterSpec (port of
``tfmesos_tpu/parallel/mesh.py``, its data and tensor axes).

The JAX package turns the job counts into mesh axis sizes: ``dp`` (data
parallel, the worker set), ``fsdp`` (parameter sharding, what ps jobs
become) and ``tp`` (Megatron tensor parallelism), ``-1`` absorbing
every device left.  The port lays the ranks out over the axes it has,
one rank a device, in the JAX package's order with ``tp`` innermost
(rank = row-major index over ``dp, fsdp, tp``), and makes one process
group for every set of axes and every coordinate of the others, so a
collective names the axes it runs over (``parallel/collectives.py``).
``sp``, ``pp`` and ``ep`` above 1 (ROADMAP A.10), and every ``dcn.``
axis (the gang slice, A.9 (c)), are refused by name.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

__all__ = ["DATA_AXES", "AXIS_ORDER", "MeshSpec", "RankMesh", "LocalMesh",
           "check_axes", "resolve_axes", "build_mesh"]

DATA_AXES = ("dp", "fsdp")
#: The axes the port builds, outermost first (the JAX ``AXIS_ORDER``
#: without the axes it does not have yet).
AXIS_ORDER = ("dp", "fsdp", "tp")
# The ROADMAP item that brings each axis the port does not have yet.
LATER_AXES = {"sp": "A.10", "pp": "A.10", "ep": "A.10"}

Axes = Union[str, Sequence[str], None]


@dataclass
class MeshSpec:
    """An ordered mapping of axis name -> size."""

    axes: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        for name, size in self.axes.items():
            if size < 1:
                raise ValueError(f"axis {name!r} must have positive size, "
                                 f"got {size}")

    @property
    def size(self) -> int:
        return math.prod(self.axes.values()) if self.axes else 1


def check_axes(axes: Dict[str, int]) -> Dict[str, int]:
    """Return ``axes`` if the port can build them, else raise
    ``ValueError`` naming the axis and its ROADMAP item: any ``dcn.``
    axis, and any axis but dp, fsdp and tp whose size is not 1 (-1
    included: it would absorb devices)."""
    for name, size in axes.items():
        if name.startswith("dcn."):
            raise ValueError(f"not ported yet: mesh axis {name} "
                             f"(ROADMAP A.9 (c))")
        if name not in AXIS_ORDER and size != 1:
            raise ValueError(f"not ported yet: mesh axis {name} (ROADMAP "
                             f"{LATER_AXES.get(name, 'A.10')})")
    return axes


def resolve_axes(axes: Optional[Dict[str, int]], n: int) -> Dict[str, int]:
    """The axis sizes ``axes`` asks for over ``n`` ranks, in
    :data:`AXIS_ORDER` (axes of size 1 that were named are kept; axes
    the port does not build are dropped after :func:`check_axes`): all
    ``dp`` when ``axes`` is empty; at most one -1, which takes what the
    others leave; the sizes must multiply to ``n``."""
    spec = dict(check_axes(dict(axes or {})) or {"dp": -1})
    spec = {a: s for a, s in spec.items() if a in AXIS_ORDER}
    wild = [a for a, s in spec.items() if s == -1]
    if len(wild) > 1:
        raise ValueError(f"at most one axis may be -1, got {wild}")
    if wild:
        fixed = math.prod(s for s in spec.values() if s != -1)
        if n % fixed:
            raise ValueError(f"{n} ranks not divisible by fixed axes {spec}")
        spec[wild[0]] = n // fixed
    ms = MeshSpec(spec)
    if ms.size != n:
        raise ValueError(f"mesh {spec} wants {ms.size} ranks, have {n}")
    return {a: spec[a] for a in AXIS_ORDER if a in spec}


class RankMesh:
    """The ranks laid out over named axes, each rank one device: the part
    of ``DeviceMesh``'s surface the port uses (``size``, ``shape``,
    ``mesh_dim_names``, ``get_group``, ``device_type``), plus the axis
    vocabulary of the JAX ``Mesh``: :meth:`axis_size`, this rank's
    :meth:`coord` on an axis, and :meth:`group` for any set of axes
    (None when that set has one rank, so a collective over it is
    skipped).  ``mesh_dim_names`` are the axes above size 1 (the data
    axis that was named, else ``dp``, when there are none)."""

    def __init__(self, axes: Dict[str, int], rank: int, device_type: str,
                 make_groups: bool = True):
        self.axes = dict(axes)
        self.rank = int(rank)
        self.device_type = device_type
        big = tuple(a for a in AXIS_ORDER if self.axes.get(a, 1) > 1)
        named = [a for a in DATA_AXES if a in self.axes]
        self.mesh_dim_names = big or (named[0] if named else "dp",)
        self._coords = self._unravel(self.rank)
        self._groups: Dict[Tuple[str, ...], object] = {}
        if make_groups:
            self._make_groups(big)

    def _unravel(self, rank: int) -> Dict[str, int]:
        out = {}
        for a in reversed(AXIS_ORDER):
            s = self.axes.get(a, 1)
            out[a] = rank % s
            rank //= s
        return out

    def _make_groups(self, big: Tuple[str, ...]) -> None:
        """One process group per non-empty set of the axes above size 1
        and per coordinate of the other axes.  ``new_group`` is collective
        over the whole world, so every rank makes every group, in the
        same order, and keeps those it belongs to."""
        import torch.distributed as dist

        world = self.size()
        coords = [self._unravel(r) for r in range(world)]
        for k in range(1, len(big) + 1):
            for names in itertools.combinations(big, k):
                others = [a for a in big if a not in names]
                buckets: Dict[Tuple[int, ...], list] = {}
                for r, c in enumerate(coords):
                    buckets.setdefault(tuple(c[a] for a in others),
                                       []).append(r)
                for key in sorted(buckets):
                    g = dist.new_group(buckets[key])
                    if self.rank in buckets[key]:
                        self._groups[names] = g

    @property
    def ndim(self) -> int:
        return len(self.mesh_dim_names)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.axes.get(a, 1) for a in self.mesh_dim_names)

    def _names(self, axes: Axes) -> Tuple[str, ...]:
        """The axes above size 1 among ``axes`` (all the mesh's by
        default, a dim index, a name or names), in mesh order."""
        if axes is None:
            axes = self.mesh_dim_names
        elif isinstance(axes, int):
            axes = (self.mesh_dim_names[axes],)
        elif isinstance(axes, str):
            axes = (axes,)
        return tuple(a for a in AXIS_ORDER if a in axes
                     and self.axes.get(a, 1) > 1)

    def axis_size(self, axes: Axes) -> int:
        """The number of ranks over ``axes`` (1 for an axis the mesh does
        not have)."""
        return math.prod(self.axes.get(a, 1) for a in self._names(axes))

    def size(self, mesh_dim: Axes = None) -> int:
        """Ranks over ``mesh_dim`` (a dim index, an axis name or names),
        all of them by default."""
        if mesh_dim is None:
            return math.prod(self.axes.values()) if self.axes else 1
        return self.axis_size(mesh_dim)

    def coord(self, axes: Axes) -> int:
        """This rank's index along ``axes`` (row-major over several)."""
        idx = 0
        for a in self._names(axes):
            idx = idx * self.axes[a] + self._coords[a]
        return idx

    def group(self, axes: Axes):
        """This rank's process group over ``axes``, or None when they hold
        one rank."""
        names = self._names(axes)
        return self._groups[names] if names else None

    def get_group(self, mesh_dim: Axes = None):
        g = self.group(mesh_dim)
        if g is None:
            raise RuntimeError("a size-1 mesh has no process group")
        return g

    def only(self, axes: Axes) -> "RankMesh":
        """This mesh seen along ``axes`` alone: the same ranks and process
        groups, every other axis dropped (a batcher runs its model on
        the tp axis of a data x tp mesh, each data shard on its own)."""
        names = self._names(axes)
        sub = RankMesh({a: self.axes[a] for a in names}, self.coord(names),
                       self.device_type, make_groups=False)
        sub._groups = {k: g for k, g in self._groups.items()
                       if set(k) <= set(names)}
        return sub

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """The data axes above size 1 (the JAX ``sharding.data_axes``)."""
        return tuple(a for a in DATA_AXES if self.axes.get(a, 1) > 1)

    @property
    def tp(self) -> int:
        return self.axes.get("tp", 1)

    def __repr__(self) -> str:
        inner = ", ".join(f"{a}={s}" for a, s in self.axes.items())
        return f"{type(self).__name__}(({inner}), {self.device_type!r})"


class LocalMesh(RankMesh):
    """The size-1 mesh of a run with one rank: no process group."""

    def __init__(self, device_type: str, axis: str = "dp",
                 axes: Optional[Dict[str, int]] = None):
        super().__init__(axes or {axis: 1}, 0, device_type,
                         make_groups=False)


def build_mesh(axes: Optional[Dict[str, int]] = None,
               world_size: Optional[int] = None, device_type: str = "cpu",
               rank: Optional[int] = None) -> RankMesh:
    """The mesh over every rank: a :class:`RankMesh` over the axes
    ``axes`` resolves to (:func:`resolve_axes`; the process group must
    exist: ``runtime.initialize``), a :class:`LocalMesh` at one rank.
    ``world_size`` and ``rank`` default to the process group's, else 1
    and 0."""
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if live else 1
    spec = resolve_axes(axes, world_size)
    if world_size == 1:
        named = [a for a in DATA_AXES if a in spec]
        return LocalMesh(device_type, named[0] if named else "dp", spec)
    if rank is None:
        rank = dist.get_rank() if live else 0
    return RankMesh(spec, rank, device_type)

