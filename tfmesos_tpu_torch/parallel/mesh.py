"""The mesh: the successor of the ps/worker ClusterSpec (port of
``tfmesos_tpu/parallel/mesh.py``).

The JAX package turns the job counts into mesh axis sizes: ``dp`` (data
parallel, the worker set), ``fsdp`` (parameter sharding, what ps jobs
become), ``pp`` (pipeline stages, ``parallel/pipeline.py``), ``ep``
(experts of an MoE model), ``sp`` (the sequence: ring or Ulysses
attention) and ``tp`` (Megatron tensor parallelism), ``-1`` absorbing
every device left.  The port lays the ranks out over the axes, one rank
a device, in the JAX package's order with ``tp`` innermost (rank =
row-major index over ``dp, fsdp, pp, ep, sp, tp``), and
makes one process group for every set of axes and every coordinate of
the others, so a collective names the axes it runs over
(``parallel/collectives.py``).

Axes prefixed ``dcn.`` (``dcn.dp=2,dp=2,tp=2``) lay that part of an axis
ACROSS slices, as the JAX ``build_hybrid_mesh`` does: the ranks split
into as many equal contiguous blocks ("slices") as the dcn sizes
multiply to, the dcn axes lay out over the slices and the others within
each slice, and an axis named both ways has size dcn x ici with the dcn
index as its outer factor.  A rank's coordinates follow that layout, so
its place in the grid is the device's in JAX's hybrid mesh.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

__all__ = ["DATA_AXES", "AXIS_ORDER", "MeshSpec", "RankMesh", "LocalMesh",
           "check_axes", "split_dcn_axes", "resolve_axes", "resolve_dcn",
           "build_mesh"]

DATA_AXES = ("dp", "fsdp")
#: The axes, outermost first (the JAX ``AXIS_ORDER``).
AXIS_ORDER = ("dp", "fsdp", "pp", "ep", "sp", "tp")

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


def split_dcn_axes(axes: Dict[str, int]):
    """Split a flat axis dict into ``(ici_axes, dcn_axes)``: keys
    prefixed ``dcn.`` name the across-slice dims (the prefix lets one
    dict ride the whole plumbing: flag, config, env, ``ctx.mesh``)."""
    ici = {a: s for a, s in axes.items() if not a.startswith("dcn.")}
    dcn = {a[len("dcn."):]: s for a, s in axes.items()
           if a.startswith("dcn.")}
    return ici, dcn


def check_axes(axes: Dict[str, int]) -> Dict[str, int]:
    """Return ``axes`` if the port can build them, else raise
    ``ValueError``: an axis outside :data:`AXIS_ORDER` whose size is not
    1 (-1 included: it would absorb devices), with or without the
    ``dcn.`` prefix, and a ``dcn.`` axis without an explicit size."""
    ici, dcn = split_dcn_axes(axes)
    if any(s == -1 for s in dcn.values()):
        raise ValueError("dcn axes need explicit sizes (no -1 wildcard): "
                         "the slice count is what they must match")
    for name, size in list(ici.items()) + list(dcn.items()):
        if name not in AXIS_ORDER and size != 1:
            raise ValueError(f"unknown mesh axis {name} (the axes: "
                             f"{', '.join(AXIS_ORDER)})")
    return axes


def resolve_dcn(axes: Optional[Dict[str, int]]) -> Dict[str, int]:
    """The across-slice sizes ``axes`` names, over the axes the port
    builds (an empty dict: one slice)."""
    _, dcn = split_dcn_axes(check_axes(dict(axes or {})))
    return {a: dcn[a] for a in AXIS_ORDER if dcn.get(a, 1) > 1}


def resolve_axes(axes: Optional[Dict[str, int]], n: int) -> Dict[str, int]:
    """The axis sizes ``axes`` asks for over ``n`` ranks, in
    :data:`AXIS_ORDER` (axes of size 1 that were named are kept; axes
    the port does not build are dropped after :func:`check_axes`): all
    ``dp`` when ``axes`` is empty; at most one -1, which takes what the
    others leave; the sizes must multiply to ``n``.  With ``dcn.`` axes
    the slice count (their product) must divide ``n``, the other axes
    lay out over one slice's ranks (a -1 takes what they leave there),
    and an axis's size is its dcn size times its slice size."""
    ici, _ = split_dcn_axes(check_axes(dict(axes or {})))
    dcn = resolve_dcn(axes)
    slices = math.prod(dcn.values()) if dcn else 1
    if n % slices:
        raise ValueError(f"{n} ranks not divisible into {slices} slices")
    per = n // slices
    spec = dict(ici or ({} if dcn else {"dp": -1}))
    spec = {a: s for a, s in spec.items() if a in AXIS_ORDER}
    wild = [a for a, s in spec.items() if s == -1]
    if len(wild) > 1:
        raise ValueError(f"at most one axis may be -1, got {wild}")
    if wild:
        fixed = math.prod(s for s in spec.values() if s != -1)
        if per % fixed:
            raise ValueError(f"{per} ranks not divisible by fixed axes "
                             f"{spec}")
        spec[wild[0]] = per // fixed
    if MeshSpec(spec).size != per:
        if dcn:
            raise ValueError(f"ici axes {spec} want {MeshSpec(spec).size} "
                             f"ranks per slice, have {per}")
        raise ValueError(f"mesh {spec} wants {MeshSpec(spec).size} ranks, "
                         f"have {n}")
    for a, d in dcn.items():
        spec[a] = d * spec.get(a, 1)
    return {a: spec[a] for a in AXIS_ORDER if a in spec}


class RankMesh:
    """The ranks laid out over named axes, each rank one device: the part
    of ``DeviceMesh``'s surface the port uses (``size``, ``shape``,
    ``mesh_dim_names``, ``get_group``, ``device_type``), plus the axis
    vocabulary of the JAX ``Mesh``: :meth:`axis_size`, this rank's
    :meth:`coord` on an axis, and :meth:`group` for any set of axes
    (None when that set has one rank, so a collective over it is
    skipped).  ``mesh_dim_names`` are the axes above size 1 (the data
    axis that was named, else ``dp``, when there are none).  ``dcn``
    gives each axis's across-slice factor (:func:`resolve_dcn`): ranks
    then lay out as JAX's hybrid mesh lays devices out."""

    def __init__(self, axes: Dict[str, int], rank: int, device_type: str,
                 make_groups: bool = True,
                 dcn: Optional[Dict[str, int]] = None):
        self.axes = dict(axes)
        self.dcn = {a: s for a, s in (dcn or {}).items() if s > 1}
        for a, s in self.dcn.items():
            if self.axes.get(a, 1) % s:
                raise ValueError(f"dcn.{a}={s} does not divide axis {a} "
                                 f"({self.axes.get(a, 1)})")
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
        """``rank``'s coordinates: row-major over :data:`AXIS_ORDER`, or
        with ``dcn``, its slice (``rank`` // ranks a slice) row-major
        over the dcn sizes and its place in the slice row-major over the
        rest, each axis's dcn index the outer factor."""
        if not self.dcn:
            return _row_major(rank, self.axes)
        ici = {a: self.axes.get(a, 1) // self.dcn.get(a, 1)
               for a in AXIS_ORDER}
        per = math.prod(ici.values())
        outer = _row_major(rank // per, self.dcn)
        inner = _row_major(rank % per, ici)
        return {a: outer[a] * ici[a] + inner[a] for a in AXIS_ORDER}

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
        inner = ", ".join([f"dcn.{a}={s}" for a, s in self.dcn.items()]
                          + [f"{a}={s}" for a, s in self.axes.items()])
        return f"{type(self).__name__}(({inner}), {self.device_type!r})"


def _row_major(index: int, sizes: Dict[str, int]) -> Dict[str, int]:
    out = {}
    for a in reversed(AXIS_ORDER):
        s = sizes.get(a, 1)
        out[a] = index % s
        index //= s
    return out


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
    and 0.  ``dcn.`` axes lay the ranks out as JAX's hybrid mesh does."""
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
    return RankMesh(spec, rank, device_type, dcn=resolve_dcn(axes))

