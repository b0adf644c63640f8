"""Collective helpers over the mesh (port of
``tfmesos_tpu/parallel/collectives.py``).

The JAX package names its collectives by mesh axis and leaves the rest
to XLA; here each helper takes the :class:`~.mesh.RankMesh` and the axes
it runs over, and calls ``torch.distributed`` on that axes' process
group (nothing at all when the axes hold one rank, so one code path
serves every mesh).  Gloo, which runs the CPU tests and every multi-rank
run on one card, has no reduce-scatter: :func:`reduce_scatter` is an
all-reduce and a slice there, the same sum.

The autograd pair are Megatron's *f* and *g*:
:class:`BroadcastReplicatedGrad` (identity forward, all-reduce backward,
where a tp-replicated activation fans out into per-shard columns) and
:class:`PsumReplicatedGrad` (all-reduce forward, identity backward,
after a row-parallel product).  Each gradient is then what one process
computes: plain all-reduce differentiated as a sum would transpose to a
second all-reduce and count each cotangent tp times (the note at the
JAX ``_block_manual_tp``).  :class:`GatherShards` is fsdp's: all-gather
forward, reduce-scatter backward, so a rank keeps only its shard of a
parameter and of its gradient.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "all_reduce_mean", "grad_sync", "all_gather",
           "reduce_scatter", "axis_index", "barrier",
           "BroadcastReplicatedGrad", "PsumReplicatedGrad", "GatherShards",
           "broadcast_replicated_grad", "psum_replicated_grad",
           "gather_shards"]


def all_reduce_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` summed over ``axes`` (a fresh tensor; ``x`` itself when the
    axes hold one rank)."""
    group = None if mesh is None else mesh.group(axes)
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_mean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    n = 1 if mesh is None else mesh.axis_size(axes)
    out = all_reduce_sum(x, mesh, axes)
    return out / n if n > 1 else out


def grad_sync(grads: Sequence[torch.Tensor], mesh, axes
              ) -> List[torch.Tensor]:
    """Each gradient averaged over ``axes`` (the JAX ``grad_sync``), in
    one collective a dtype: the leaves go into one flat buffer, since
    gloo stages a CUDA tensor through host memory and a call a leaf
    would cost more than the data."""
    grads = list(grads)
    n = 1 if mesh is None else mesh.axis_size(axes)
    if n == 1:
        return grads
    group = mesh.group(axes)
    out: List[torch.Tensor] = [None] * len(grads)
    by_dtype = {}
    for i, t in enumerate(grads):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(n)
        for i, piece in zip(idx, flat.split([grads[i].numel()
                                             for i in idx])):
            out[i] = piece.view_as(grads[i])
    return out


def all_gather(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` over ``axes``, concatenated along ``dim`` in
    coordinate order (tiled, as ``lax.all_gather(tiled=True)``)."""
    n = 1 if mesh is None else mesh.axis_size(axes)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group(axes))
    return torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int = 0
                   ) -> torch.Tensor:
    """``x`` summed over ``axes``, this rank's block of ``dim`` kept."""
    n = 1 if mesh is None else mesh.axis_size(axes)
    if n == 1:
        return x
    full = all_reduce_sum(x, mesh, axes)
    return full.chunk(n, dim=dim)[mesh.coord(axes)].contiguous()


def axis_index(mesh, axes) -> int:
    return 0 if mesh is None else mesh.coord(axes)


def barrier(mesh, axes=None) -> None:
    """Wait for every rank over ``axes`` (all by default)."""
    group = None if mesh is None else mesh.group(axes)
    if group is not None:
        dist.barrier(group=group)


class BroadcastReplicatedGrad(torch.autograd.Function):
    """Megatron's *f*: identity forward, all-reduce (sum) backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.mesh, ctx.axes), None, None


class PsumReplicatedGrad(torch.autograd.Function):
    """Megatron's *g*: all-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_sum(x.contiguous(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class GatherShards(torch.autograd.Function):
    """fsdp's gather: the full parameter from every rank's block along
    ``dim`` forward, the gradient summed over the ranks and cut to this
    rank's block backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g.contiguous(), ctx.mesh, ctx.axes, ctx.dim),
                None, None, None)


def broadcast_replicated_grad(x: torch.Tensor, mesh, axes="tp"):
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return BroadcastReplicatedGrad.apply(x, mesh, axes)


def psum_replicated_grad(x: torch.Tensor, mesh, axes="tp"):
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return PsumReplicatedGrad.apply(x, mesh, axes)


def gather_shards(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return GatherShards.apply(x, mesh, axes, dim)
