"""Parameter and batch sharding over the mesh (port of
``tfmesos_tpu/parallel/sharding.py``).

A spec is the port's own: a tuple with one entry a tensor dim, each
``None`` (the dim is whole on every rank), an axis name, or a tuple of
axis names (the dim is cut over all of them, row-major) — the JAX
``PartitionSpec``'s content, without JAX.  Where the JAX package places
a global array and lets GSPMD slice it, a rank here holds its own block
of each leaf as a plain tensor: :func:`place_tree` cuts it from the full
leaf every rank holds (params from a shared seed, a checkpoint), and
:func:`gather_tree` is its inverse.  An :class:`Interleaved` entry cuts
a pipeline's layer stack round-robin, as the JAX circular and
interleaved 1F1B schedules place their chunks.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tfmesos_tpu_torch.ops.quant import QTensor
from tfmesos_tpu_torch.parallel import collectives
from tfmesos_tpu_torch.parallel.mesh import DATA_AXES

__all__ = ["Spec", "Interleaved", "data_axes", "token_axes", "filter_spec",
           "spec_axes",
           "fsdp_spec",
           "batch_spec", "block", "cut", "uncut", "place_tree", "gather_tree",
           "make_global_batch", "apply_rules"]

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


class Interleaved(tuple):
    """The spec entry of a layer-stack dim cut over the pipeline axis
    ``axis`` (S ranks) in ``chunks`` virtual stages a rank: the dim is
    S·chunks equal chunks and rank d holds chunks d, d + S, …, in that
    order (its lap order: the JAX schedules' permutation
    ``[c] -> [(c % S)·v + c // S]``, ``parallel/pipeline.py:581``).
    As a tuple it is ``(axis,)``, so the axis helpers read it as a cut
    over ``axis``."""

    def __new__(cls, axis: str, chunks: int):
        entry = super().__new__(cls, (axis,))
        entry.chunks = int(chunks)
        return entry

    def __reduce__(self):
        return (Interleaved, (self[0], self.chunks))


def data_axes(mesh) -> Optional[Tuple[str, ...]]:
    """The mesh axes batch-like dims shard over: dp and fsdp where above
    size 1, else None."""
    if mesh is None:
        return None
    return tuple(a for a in DATA_AXES if mesh.axis_size(a) > 1) or None


def token_axes(mesh) -> Optional[Tuple[str, ...]]:
    """The axes whose ranks hold distinct tokens: the data axes and
    ``sp`` where above size 1, else None.  A loss is averaged over them
    (each rank's share is an equal number of tokens) and so are the
    gradients; ``ep`` and ``tp`` ranks hold the same tokens."""
    if mesh is None:
        return None
    return tuple(a for a in DATA_AXES + ("sp",)
                 if mesh.axis_size(a) > 1) or None


def _dim_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def filter_spec(spec: Spec, mesh) -> Spec:
    """``spec`` with every axis of size 1 on ``mesh`` dropped (the JAX
    ``_filter_spec``)."""
    def keep(entry):
        if isinstance(entry, Interleaved):
            return entry if mesh is not None and mesh.axis_size(
                entry[0]) > 1 else None
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
    """The leading (batch) dim over the data axes, the sequence dim (the
    first extra one) over ``sp`` where above size 1, the rest whole
    (the JAX ``batch_spec``)."""
    dims = [data_axes(mesh)]
    if extra_dims >= 1 and mesh is not None and mesh.axis_size("sp") > 1:
        dims.append("sp")
        extra_dims -= 1
    return tuple(dims) + (None,) * extra_dims


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
        if isinstance(entry, Interleaved):
            per = x.shape[d] // (n * entry.chunks)
            x = x.unflatten(d, (entry.chunks, n, per)).select(
                d + 1, mesh.coord(axes)).flatten(d, d + 1)
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
        if isinstance(entry, Interleaved):
            n = mesh.axis_size(axes)
            x = collectives.all_gather(x.contiguous(), mesh, axes, dim=d)
            x = x.unflatten(d, (n, entry.chunks, -1)).transpose(
                d, d + 1).flatten(d, d + 2)
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


def seq_window(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """This sp rank's window of a next-token batch leaf ([B, T+1] along
    ``dim``): T cut over ``sp`` into T/sp positions, each window with
    the one label after it (positions ``[i T/sp, (i+1) T/sp]``), so the
    rank's inputs are its sequence shard and its labels the shard's
    next tokens.  ``x`` itself without sp."""
    n = 1 if mesh is None else mesh.axis_size("sp")
    if n == 1:
        return x
    t = x.shape[dim] - 1
    if t % n:
        raise ValueError(f"sequence length {t} does not divide over "
                         f"sp={n}")
    return x.narrow(dim, mesh.coord("sp") * (t // n), t // n + 1)


def make_global_batch(mesh, batch: Dict[str, Any],
                      batch_dim: int = 0) -> Dict[str, torch.Tensor]:
    """This rank's share of a GLOBAL batch every rank holds: each leaf's
    ``batch_dim`` cut over the data axes, the ranks of one data shard
    (tp and ep peers) holding the same block, and with ``sp`` the next
    dim (a next-token batch's [.., T+1]) cut into this rank's
    :func:`seq_window`.  The JAX ``make_global_batch`` assembles the
    global array from the processes' shares; here the step takes the
    share itself."""
    spec_of = lambda v: ((None,) * batch_dim + (data_axes(mesh),)
                         if v.ndim > batch_dim else ())

    def share(v):
        v = cut(v, spec_of(v), mesh)
        if v.ndim > batch_dim + 1:
            v = seq_window(v, mesh, batch_dim + 1)
        return v.contiguous()

    return {k: share(torch.as_tensor(v)) for k, v in batch.items()}


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
