"""Parameter and batch sharding over the mesh (port of
``tfmesos_tpu/parallel/sharding.py``).

A spec is the port's own: a tuple with one entry a tensor dim, each
``None`` (the dim is whole on every rank), an axis name, or a tuple of
axis names (the dim is cut over all of them, row-major) — the JAX
``PartitionSpec``'s content, without JAX.  Where the JAX package places
a global array and lets GSPMD slice it, a rank here holds its own block
of each leaf as a plain tensor: :func:`place_tree` cuts it from the full
leaf every rank holds (params from a shared seed, a checkpoint), and
:func:`gather_tree` is its inverse.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tfmesos_tpu_torch.ops.quant import QTensor
from tfmesos_tpu_torch.parallel import collectives
from tfmesos_tpu_torch.parallel.mesh import DATA_AXES

__all__ = ["Spec", "data_axes", "filter_spec", "spec_axes", "fsdp_spec",
           "batch_spec", "block", "cut", "uncut", "place_tree", "gather_tree",
           "make_global_batch", "apply_rules"]

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def data_axes(mesh) -> Optional[Tuple[str, ...]]:
    """The mesh axes batch-like dims shard over: dp and fsdp where above
    size 1, else None."""
    if mesh is None:
        return None
    return tuple(a for a in DATA_AXES if mesh.axis_size(a) > 1) or None


def _dim_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def filter_spec(spec: Spec, mesh) -> Spec:
    """``spec`` with every axis of size 1 on ``mesh`` dropped (the JAX
    ``_filter_spec``)."""
    def keep(entry):
        kept = tuple(a for a in _dim_axes(entry)
                     if mesh is not None and mesh.axis_size(a) > 1)
        if not kept:
            return None
        return kept[0] if len(kept) == 1 and isinstance(entry, str) \
            else kept
    return tuple(keep(e) for e in spec)


def spec_axes(spec: Spec, mesh) -> Tuple[str, ...]:
    """The mesh axes above size 1 that ``spec`` cuts over."""
    return tuple(a for e in spec for a in _dim_axes(e)
                 if mesh is not None and mesh.axis_size(a) > 1)


def fsdp_spec(shape: Sequence[int], mesh, axis: str = "fsdp",
              min_size: int = 1024) -> Spec:
    """FSDP rule for one tensor: cut the largest dim that ``axis``
    divides; tensors under ``min_size`` elements stay whole."""
    none = (None,) * len(shape)
    n = 1 if mesh is None else mesh.axis_size(axis)
    if n == 1 or int(np.prod(shape or [1])) < min_size:
        return none
    for d in sorted(range(len(shape)), key=lambda d: shape[d],
                    reverse=True):
        if shape[d] % n == 0:
            return tuple(axis if i == d else None
                         for i in range(len(shape)))
    return none


def batch_spec(mesh, extra_dims: int = 0) -> Spec:
    """The leading (batch) dim over the data axes, the rest whole."""
    return (data_axes(mesh),) + (None,) * extra_dims


def block(n: int, parts: int) -> int:
    """The block a dim of ``n`` cuts into over ``parts`` ranks: ceil,
    the last blocks shorter when ``parts`` does not divide ``n`` (as
    GSPMD pads an uneven shard)."""
    return -(-n // parts)


def cut(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec`` (a
    view): rank i of a dim's axes holds ``[i * b, (i + 1) * b)`` with
    ``b`` :func:`block`."""
    for d, entry in enumerate(spec):
        axes = _dim_axes(entry)
        n = 1 if mesh is None else mesh.axis_size(axes)
        if n == 1:
            continue
        b = block(x.shape[d], n)
        start = min(mesh.coord(axes) * b, x.shape[d])
        x = x.narrow(d, start, min(b, x.shape[d] - start))
    return x


def uncut(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's block (the inverse of
    :func:`cut`; collectives over the spec's axes: the block sizes,
    then the blocks padded to the largest)."""
    for d, entry in enumerate(spec):
        axes = _dim_axes(entry)
        if mesh is None or mesh.axis_size(axes) == 1:
            continue
        sizes = collectives.all_gather(
            torch.tensor([x.shape[d]], device=x.device), mesh, axes)
        sizes = [int(v) for v in sizes.tolist()]
        pad = max(sizes) - x.shape[d]
        if pad:
            shape = list(x.shape)
            shape[d] = pad
            x = torch.cat([x, x.new_zeros(shape)], dim=d)
        parts = collectives.all_gather(x, mesh, axes, dim=d).split(
            max(sizes), dim=d)
        x = torch.cat([p.narrow(d, 0, n) for p, n in zip(parts, sizes)],
                      dim=d)
    return x


def _map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree; an int8 leaf's scales
    ([..., K, 1]) take their values' spec but on the dims they keep."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        scale_spec = tuple(None if n == 1 else e
                           for e, n in zip(specs, tree.scales.shape))
        return QTensor(fn(tree.values, specs), fn(tree.scales, scale_spec))
    return fn(tree, specs)


def place_tree(mesh, tree: Any, spec_tree: Any) -> Any:
    """Every leaf of the full ``tree`` cut to this rank's block per
    ``spec_tree`` (a dict of the same keys whose leaves are specs), each
    block a tensor of its own (a view would keep the full leaf alive)."""
    def place(x, s):
        c = cut(x, s, mesh)
        return c if c.shape == x.shape else c.clone(
            memory_format=torch.contiguous_format)
    return _map(place, tree, spec_tree)


def gather_tree(mesh, tree: Any, spec_tree: Any) -> Any:
    """Every leaf of this rank's ``tree`` gathered to its full tensor
    (collectives: every rank calls it, in the same order)."""
    return _map(lambda x, s: uncut(x.detach(), s, mesh), tree, spec_tree)


def make_global_batch(mesh, batch: Dict[str, Any],
                      batch_dim: int = 0) -> Dict[str, torch.Tensor]:
    """This rank's share of a GLOBAL batch every rank holds: each leaf's
    ``batch_dim`` cut over the data axes, the ranks of one data shard
    (tp peers) holding the same block.  The JAX
    ``make_global_batch`` assembles the global array from the
    processes' shares; here the step takes the share itself."""
    spec_of = lambda v: ((None,) * batch_dim + (data_axes(mesh),)
                         if v.ndim > batch_dim else ())
    return {k: cut(torch.as_tensor(v), spec_of(torch.as_tensor(v)),
                   mesh).contiguous()
            for k, v in batch.items()}


def apply_rules(path_specs: Dict[str, Spec], params: Any, mesh=None,
                default: Optional[Spec] = None) -> Any:
    """A spec tree for ``params`` from dotted-path substring rules
    (``"layers.wq"``): the first rule whose pattern is in a leaf's path
    wins, else ``default`` (else whole on every rank)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}.{k}" if path else k)
                    for k, v in node.items()}
        ndim = (node.values if isinstance(node, QTensor) else node).dim()
        for pattern, spec in path_specs.items():
            if pattern in path:
                return filter_spec(spec, mesh)
        return default if default is not None else (None,) * ndim
    return walk(params, "")
