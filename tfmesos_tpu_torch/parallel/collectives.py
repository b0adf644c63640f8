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

The sequence and expert axes add the ring hop and the all-to-all (the
JAX ``ppermute_shift`` and ``lax.all_to_all(tiled=True)``):
:func:`ppermute_shift` sends to index +1 on the axes' group and
receives from index -1 (one ``batch_isend_irecv``), :func:`all_to_all`
splits one dim into a block per rank and concatenates the blocks it
receives along another, in rank order.  Each has an autograd Function
whose backward is the transpose: the shift back, the inverse
all-to-all.  Both are point-to-point sends and receives in one
``batch_isend_irecv`` on every backend (not every gloo build has
``alltoall``); on gloo a CUDA tensor is staged through host memory for
the transfer (the compute stays on the card, and gloo stages its other
collectives through host memory as well).
:func:`all_reduce_sum_grad` is the all-reduce whose backward is the
all-reduce again (the transpose of a sum every rank takes): router
statistics summed over the ranks that hold distinct tokens.
:class:`CollectiveTimer` times this process's collectives on the host
(``transformer_train --time-collectives``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

__all__ = ["CollectiveTimer", "all_reduce_sum", "all_reduce_mean",
           "grad_sync", "all_gather",
           "reduce_scatter", "axis_index", "barrier",
           "BroadcastReplicatedGrad", "PsumReplicatedGrad", "GatherShards",
           "broadcast_replicated_grad", "psum_replicated_grad",
           "gather_shards", "ppermute_shift", "all_to_all",
           "all_reduce_sum_grad", "PpermuteShift", "AllToAll",
           "AllReduceSumGrad", "mean_replicated_grad"]


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


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` goes through host memory for a point-to-point or
    all-to-all transfer: a CUDA tensor on a gloo group."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _shift(x: torch.Tensor, mesh, axes, shift: int) -> torch.Tensor:
    """``x`` sent to index +``shift`` of the axes' group, the block of
    index -``shift`` received (one ``batch_isend_irecv``)."""
    n = mesh.axis_size(axes)
    group = mesh.group(axes)
    ranks = dist.get_process_group_ranks(group)
    me = mesh.coord(axes)
    staged = _staged(x, group)
    src = x.detach().contiguous()
    if staged:
        src = src.cpu()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, ranks[(me + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out.to(x.device) if staged else out


class PpermuteShift(torch.autograd.Function):
    """The ring hop: to index +shift forward, the gradient back to
    index -shift."""

    @staticmethod
    def forward(ctx, x, mesh, axes, shift):
        ctx.mesh, ctx.axes, ctx.shift = mesh, axes, shift
        return _shift(x, mesh, axes, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, ctx.axes, -ctx.shift), None, None, None


def ppermute_shift(x: torch.Tensor, mesh, axes="sp", shift: int = 1
                   ) -> torch.Tensor:
    """Rotate ``x`` around the ring of ``axes`` (the JAX
    ``ppermute_shift``): rank i's value lands on rank i + ``shift``."""
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return PpermuteShift.apply(x, mesh, axes, shift)


def _all_to_all(x: torch.Tensor, mesh, axes, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    """One send to and one receive from each peer, in one
    ``batch_isend_irecv`` (the ring hop's point-to-point ops: not every
    gloo build has alltoall, and NCCL's is grouped send/recv itself)."""
    n = mesh.axis_size(axes)
    group = mesh.group(axes)
    staged = _staged(x, group)
    src = x.detach().cpu() if staged else x.detach()
    ins = [c.contiguous() for c in src.chunk(n, dim=split_dim)]
    outs = [torch.empty_like(c) for c in ins]
    ranks = dist.get_process_group_ranks(group)
    me = mesh.coord(axes)
    outs[me] = ins[me]
    ops = [op for p in range(n) if p != me for op in (
        dist.P2POp(dist.isend, ins[p], ranks[p], group),
        dist.P2POp(dist.irecv, outs[p], ranks[p], group))]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = torch.cat(outs, dim=concat_dim)
    return out.to(x.device) if staged else out


class AllToAll(torch.autograd.Function):
    """The tiled all-to-all; its backward is the inverse one (split the
    concatenated dim, concatenate the split one)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, split_dim, concat_dim):
        ctx.args = (mesh, axes, split_dim, concat_dim)
        return _all_to_all(x, mesh, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_dim, concat_dim = ctx.args
        return (_all_to_all(g, mesh, axes, concat_dim, split_dim), None,
                None, None, None)


def all_to_all(x: torch.Tensor, mesh, axes, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, axes, split_dim, concat_dim, tiled=True)``:
    ``x``'s ``split_dim`` cut into one block per rank of ``axes``, block
    p sent to rank p, the blocks received concatenated along
    ``concat_dim`` in rank order (``split_dim`` shrinks by the axes'
    size, ``concat_dim`` grows by it)."""
    n = 1 if mesh is None else mesh.axis_size(axes)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} ({x.shape[split_dim]})"
                         f" does not divide over {n} ranks")
    return AllToAll.apply(x, mesh, axes, split_dim, concat_dim)


class AllReduceSumGrad(torch.autograd.Function):
    """All-reduce (sum) forward and backward: the transpose of a sum
    that every rank of the axes computes and uses."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce_sum(x.contiguous(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.mesh, ctx.axes), None, None


def all_reduce_sum_grad(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return AllReduceSumGrad.apply(x, mesh, axes)


class MeanReplicatedGrad(torch.autograd.Function):
    """A value averaged over the axes forward, identity backward: each
    rank's term of a mean that every rank then uses (the gradient of
    the sum of the ranks' means reaches each term once)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_mean(x.contiguous(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def mean_replicated_grad(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    if mesh is None or mesh.axis_size(axes) == 1:
        return x
    return MeanReplicatedGrad.apply(x, mesh, axes)


class CollectiveTimer:
    """While entered, the host seconds this process spends in the
    mesh's collectives (``seconds``): every ``torch.distributed``
    all-reduce and all-gather and every point-to-point exchange of this
    module (the ring hop, the all-to-all), each timed from a device
    sync before it to its return (gloo stages a CUDA tensor through host
    memory, so the call blocks until the transfer is done).  A
    diagnostic: the syncs it adds slow the step it measures."""

    _PATCHED = (("dist", "all_reduce"), ("dist", "all_gather"),
                ("module", "_shift"), ("module", "_all_to_all"))

    def __init__(self, device=None):
        self.device = device
        self.seconds = 0.0
        self._saved = []

    def _wrap(self, fn):
        import time

        def call(*a, **k):
            if self.device is not None and torch.device(
                    self.device).type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.seconds += time.perf_counter() - t0
        return call

    def __enter__(self):
        import sys

        owners = {"dist": dist, "module": sys.modules[__name__]}
        for owner, name in self._PATCHED:
            obj = owners[owner]
            fn = getattr(obj, name)
            self._saved.append((obj, name, fn))
            setattr(obj, name, self._wrap(fn))
        return self

    def __exit__(self, *exc):
        for obj, name, fn in reversed(self._saved):
            setattr(obj, name, fn)
        self._saved.clear()
