"""The data mesh: the successor of the ps/worker ClusterSpec (port of
``tfmesos_tpu/parallel/mesh.py``, its data axes).

The JAX package turns the job counts into mesh axis sizes: ``dp`` (data
parallel, the worker set) and ``fsdp`` (parameter sharding, what ps
jobs become), ``-1`` absorbing every device left.  The port builds a
1-D ``torch.distributed.device_mesh.DeviceMesh`` over one of them, one
rank a device.  Its ``fsdp`` keeps the parameters replicated and
all-reduces the gradients: the same arithmetic as the JAX fsdp step,
without its memory saving (parameter sharding comes with ROADMAP A.9
(b)).  Every other axis above 1, and every ``dcn.`` axis, is refused by
name.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = ["DATA_AXES", "MeshSpec", "LocalMesh", "check_axes",
           "resolve_axes", "build_mesh"]

DATA_AXES = ("dp", "fsdp")
# The ROADMAP item that brings each model axis.
LATER_AXES = {"tp": "A.9 (b)", "sp": "A.10", "pp": "A.10", "ep": "A.10"}


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
    axis, any axis but dp and fsdp whose size is not 1 (-1 included: it
    would absorb devices), and dp and fsdp both other than 1."""
    for name, size in axes.items():
        if name.startswith("dcn."):
            raise ValueError(f"not ported yet: mesh axis {name} "
                             f"(ROADMAP A.9 (b))")
        if name not in DATA_AXES and size != 1:
            raise ValueError(f"not ported yet: mesh axis {name} (ROADMAP "
                             f"{LATER_AXES.get(name, 'A.9 (b)')})")
    if all(axes.get(a, 1) != 1 for a in DATA_AXES):
        raise ValueError("not ported yet: a mesh over both dp and fsdp "
                         "(ROADMAP A.9 (b))")
    return axes


def resolve_axes(axes: Optional[Dict[str, int]], n: int) -> Tuple[str, int]:
    """``(axis name, size)`` of the data mesh ``axes`` asks for over
    ``n`` ranks: all ``dp`` when ``axes`` is empty; a -1 (after
    :func:`check_axes`, only dp's or fsdp's) takes all ``n``; the sizes
    must multiply to ``n``.  The axis is the data axis not of size 1,
    else the first data axis named, else ``dp``."""
    spec = dict(check_axes(dict(axes or {})) or {"dp": -1})
    spec = {a: n if s == -1 else s for a, s in spec.items()}
    ms = MeshSpec(spec)
    if ms.size != n:
        raise ValueError(f"mesh {spec} wants {ms.size} ranks, have {n}")
    named = [a for a in DATA_AXES if a in spec]
    big = [a for a in named if spec[a] != 1]
    return (big or named or ["dp"])[0], n


class LocalMesh:
    """The size-1 data mesh of a run with one rank: the part of
    ``DeviceMesh``'s surface the port uses, with no process group."""

    ndim = 1

    def __init__(self, device_type: str, axis: str = "dp"):
        self.device_type = device_type
        self.mesh_dim_names = (axis,)

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return 1

    @property
    def shape(self) -> Tuple[int]:
        return (1,)

    def get_group(self, mesh_dim=None):
        raise RuntimeError("a size-1 mesh has no process group")

    def __repr__(self) -> str:
        return (f"LocalMesh(({self.mesh_dim_names[0]}=1), "
                f"{self.device_type!r})")


def build_mesh(axes: Optional[Dict[str, int]] = None,
               world_size: Optional[int] = None, device_type: str = "cpu"):
    """The data mesh over every rank: a 1-D ``DeviceMesh`` named by its
    axis when there are several ranks (the process group must exist:
    ``runtime.initialize``), a :class:`LocalMesh` at one rank.
    ``world_size`` defaults to the process group's, else 1."""
    if world_size is None:
        import torch.distributed as dist

        world_size = (dist.get_world_size()
                      if dist.is_available() and dist.is_initialized()
                      else 1)
    name, size = resolve_axes(axes, world_size)
    if size == 1:
        return LocalMesh(device_type, name)
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, list(range(size)), mesh_dim_names=(name,))
