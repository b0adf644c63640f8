"""Pipeline parallelism over the ``pp`` mesh axis (port of
``tfmesos_tpu/parallel/pipeline.py``: ``stack_stage_params`` ``:50``,
``_schedule_1f1b`` ``:62``, ``pipeline_train_1f1b`` ``:142``,
``pipeline_apply`` ``:498``).

Layers are grouped into stage chunks whose parameters are stacked along
a leading dim; each pp rank holds its own chunks (one, or
``virtual_stages`` of them: rank d holds global chunks d, d + S, … in
that order, ``sharding.Interleaved``), and microbatches flow around the
ring with one hop a tick (``collectives._shift``), every rank running
every tick.  Where the JAX functions take the global stacked params
and cut them in a ``shard_map``, these take the rank's chunks (the
leading dim is the rank's lap index) and its shares of the batch, as
everything in the port does; a stage body runs tp / ep / sp collectives
of its own over the mesh's groups, all of whose ranks sit in one stage
and run the same ticks.

Schedules:

* ``"gpipe"`` — fill and drain: m + S − 1 ticks.
* ``"circular"`` — v interleaved virtual stages a rank, every
  microbatch lapping the ring v times: m·v + S − 1 ticks of 1/v the
  work.
* 1F1B — :func:`pipeline_train_1f1b`, forward and backward interleaved
  in one loop on :func:`_schedule_1f1b`'s timetable (a fused train
  step: autograd of a forward-only schedule replays
  all-forwards-then-all-backwards).

:func:`pipeline_apply` is one ``torch.autograd.Function``: its forward
keeps each tick's stage graph, and its backward walks the timetable in
reverse, each tick's cotangent hop the transpose of that tick's hop, in
lockstep on every rank — a per-tick autograd graph would leave a hop
whose value never reaches the loss (a bubble tick, the value the last
stage sends round the ring) without a backward on one rank while its
peer waits in the matching receive.  A bubble tick computes nothing
(JAX computes a masked stage there) but keeps its hop.  At pp = 2 the
next and the previous rank are one peer: each tick's forward and
backward exchanges are two ordered ``batch_isend_irecv`` calls, never
one.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tfmesos_tpu_torch.convert import flatten, unflatten
from tfmesos_tpu_torch.parallel import collectives
from tfmesos_tpu_torch.parallel.sharding import data_axes

__all__ = ["stack_stage_params", "pipeline_apply", "pipeline_train_1f1b"]


def stack_stage_params(stage_params: Sequence[Any]) -> Any:
    """Stack per-stage parameter trees (dicts of tensors) along a new
    leading dim."""
    first = stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in stage_params])
                for k in first}
    return torch.stack(list(stage_params))


def _leaves(tree) -> Tuple[List[torch.Tensor], Callable]:
    """A tree's tensors (a dict tree in ``convert.flatten``'s order, or
    one tensor; None has none) and the function that rebuilds a tree of
    that structure from a list like them."""
    if tree is None:
        return [], lambda xs: None
    if not isinstance(tree, dict):
        return [tree], lambda xs: xs[0]
    flat = flatten(tree)
    names = list(flat)
    return list(flat.values()), lambda xs: unflatten(dict(zip(names, xs)))


def _schedule_1f1b(n_stages: int, m: int, v: int = 1):
    """Greedy 1F1B timetable (a copy of the JAX ``_schedule_1f1b``;
    pure Python).

    Returns ``(kind, mb, lap)`` int arrays of shape [T, S]: at tick t
    rank s performs kind 0=idle / 1=forward / 2=backward on microbatch
    mb of its LOCAL chunk ``lap`` (global virtual chunk = lap*S + s).
    Rank d keeps at most ``(S - d) + (v - 1)*S`` microbatch-chunks in
    flight, prefers the ready backward with the lowest microbatch
    (deepest chunk on ties) and fills with the ready forward with the
    lowest microbatch (earliest chunk on ties).  The last virtual chunk
    runs no forward tick of its own: its backward recomputes it."""
    import numpy as np

    n_virt = n_stages * v
    last = n_virt - 1
    next_f = [0] * n_virt
    next_b = [0] * n_virt
    f_done = [[-1] * m for _ in range(n_virt)]
    b_done = [[-1] * m for _ in range(n_virt)]
    kinds, mbs, laps = [], [], []
    t = 0
    while any(nb < m for nb in next_b):
        while next_f[last] < m and (
                last == 0 or 0 <= f_done[last - 1][next_f[last]] < t):
            f_done[last][next_f[last]] = (
                t if last == 0 else f_done[last - 1][next_f[last]] + 1)
            next_f[last] += 1
        krow = [0] * n_stages
        mrow = [0] * n_stages
        lrow = [0] * n_stages
        for d in range(n_stages):
            chunks = [lap * n_stages + d for lap in range(v)]
            ready_b, ready_f = [], []
            for c in chunks:
                i, j = next_b[c], next_f[c]
                if i < m and (
                        (c == last and 0 <= f_done[c][i] <= t)
                        or (c < last and 0 <= b_done[c + 1][i] < t)):
                    ready_b.append(c)
                if (c < last and j < m
                        and (c == 0 or 0 <= f_done[c - 1][j] < t)
                        and j - next_b[c] < n_stages):
                    ready_f.append(c)
            inflight = sum(next_f[c] - next_b[c] for c in chunks)
            depth = (n_stages - d) + (v - 1) * n_stages
            if ready_b and (inflight >= depth or not ready_f):
                c = min(ready_b, key=lambda c_: (next_b[c_], -c_))
                krow[d], mrow[d], lrow[d] = 2, next_b[c], c // n_stages
                b_done[c][next_b[c]] = t
                next_b[c] += 1
            elif ready_f and inflight < depth:
                c = min(ready_f, key=lambda c_: (next_f[c_], c_))
                krow[d], mrow[d], lrow[d] = 1, next_f[c], c // n_stages
                f_done[c][next_f[c]] = t
                next_f[c] += 1
        kinds.append(krow)
        mbs.append(mrow)
        laps.append(lrow)
        t += 1
        if t > 4 * v * (m + n_virt) + 8:  # safety: must terminate
            raise AssertionError("1f1b schedule did not converge")
    return (np.asarray(kinds, np.int32), np.asarray(mbs, np.int32),
            np.asarray(laps, np.int32))


def _apply_slot(t: int, stage: int, n_stages: int, m: int, v: int):
    """(active, lap, mb) of ``stage`` at tick ``t`` of the gpipe /
    circular timetable (the JAX tick's arithmetic)."""
    u = t - stage
    if u < 0:
        return False, 0, 0
    r = u % n_stages
    w = u - r
    lap = (w % (n_stages * v)) // n_stages
    mb = (w // (n_stages * v)) * n_stages + r
    return mb < m, lap, mb


def _split(stage_fn, with_aux: bool, chunk, h):
    """``stage_fn``'s (h, aux): aux {} for a stage without one."""
    out = stage_fn(chunk, h)
    return out if with_aux else (out, {})


def _hop(x: torch.Tensor, mesh, axis: str, shift: int) -> torch.Tensor:
    return collectives._shift(x, mesh, axis, shift)


class _Apply:
    """One rank's gpipe / circular pass: the forward over the timetable
    (each active tick's stage graph kept when grads are wanted) and the
    backward over it in reverse."""

    def __init__(self, stage_fn, rebuild, mesh, axis, m, v, aux_keys,
                 seq_axis):
        self.stage_fn, self.rebuild = stage_fn, rebuild
        self.mesh, self.axis, self.m, self.v = mesh, axis, m, v
        self.aux_keys = aux_keys
        self.seq_axis = seq_axis
        self.n = mesh.axis_size(axis)
        self.stage = mesh.coord(axis)
        self.ticks = m * v + self.n - 1
        self.entries: Dict[int, tuple] = {}

    def _chunk(self, leaves, lap):
        return self.rebuild([p[lap] for p in leaves])

    def forward(self, x, leaves, keep: bool):
        n, s, m, v = self.n, self.stage, self.m, self.v
        micro = x.reshape(m, x.shape[0] // m, *x.shape[1:])
        mb_shape = micro.shape[1:]
        self.mb_shape, self.x_shape = mb_shape, x.shape
        outputs = torch.zeros_like(micro)
        aux_acc = {k: torch.zeros((), dtype=torch.float32, device=x.device)
                   for k in self.aux_keys}
        if keep:
            leaves = [p.detach().requires_grad_(p.requires_grad)
                      for p in leaves]
            self.leaves = leaves
        received = None
        for t in range(self.ticks):
            active, lap, mb = _apply_slot(t, s, n, m, v)
            if active:
                inject = s == 0 and lap == 0
                h = micro[mb] if inject else received
                if keep:
                    h = h.detach().requires_grad_(True)
                with torch.enable_grad() if keep else torch.no_grad():
                    out, aux = _split(self.stage_fn, bool(self.aux_keys),
                                      self._chunk(leaves, lap), h)
                for k in self.aux_keys:
                    aux_acc[k] = aux_acc[k] + aux[k].detach().float()
                if keep:
                    self.entries[t] = (lap, mb, inject, h, out,
                                       [aux[k] for k in self.aux_keys])
                send = out.detach()
                if s == n - 1 and lap == v - 1:
                    outputs[mb] = send
            else:
                send = torch.zeros(mb_shape, dtype=x.dtype, device=x.device)
            if t < self.ticks - 1:
                received = _hop(send, self.mesh, self.axis, 1)
        # The results live on the last stage: every stage gets them.
        if s != n - 1:
            outputs.zero_()
        out = collectives.all_reduce_sum(outputs, self.mesh, self.axis)
        auxes = []
        for k in self.aux_keys:
            a = collectives.all_reduce_sum(aux_acc[k], self.mesh,
                                           self.axis) / (m * n * v)
            red = tuple(data_axes(self.mesh) or ()) + (
                (self.seq_axis,) if self.seq_axis else ())
            auxes.append(collectives.all_reduce_mean(a, self.mesh, red)
                         if red else a)
        return out.reshape(self.x_shape), auxes

    def backward(self, g_out, g_aux):
        n, s, m, v = self.n, self.stage, self.m, self.v
        g_micro = (None if g_out is None else
                   g_out.reshape(m, g_out.shape[0] // m, *g_out.shape[1:]))
        leaves = self.leaves
        dleaves: List[Optional[torch.Tensor]] = [None] * len(leaves)
        dmicro = None
        aux_seed = [None if g is None else g / (m * n * v) for g in g_aux]
        g_next = None
        for t in reversed(range(self.ticks)):
            if t < self.ticks - 1:
                send = g_next if g_next is not None else torch.zeros(
                    self.mb_shape, dtype=self.dtype, device=self.device)
                g_sent = _hop(send, self.mesh, self.axis, -1)
            else:
                g_sent = None
            g_next = None
            entry = self.entries.pop(t, None)
            if entry is None:
                continue
            lap, mb, inject, h, out, auxes = entry
            g = g_sent
            if s == n - 1 and lap == v - 1 and g_micro is not None:
                g = g_micro[mb] if g is None else g + g_micro[mb]
            outs, seeds = [], []
            if g is not None:
                outs.append(out)
                seeds.append(g.to(out.dtype))
            for a, seed in zip(auxes, aux_seed):
                if seed is not None and a.requires_grad:
                    outs.append(a)
                    seeds.append(seed.to(a.dtype))
            if not outs:
                continue
            wrt = [h] + [p for p in leaves if p.requires_grad]
            grads = torch.autograd.grad(outs, wrt, seeds, allow_unused=True)
            dh, it = grads[0], iter(grads[1:])
            for i, p in enumerate(leaves):
                if p.requires_grad:
                    d = next(it)
                    if d is not None:
                        dleaves[i] = d if dleaves[i] is None else \
                            dleaves[i] + d
            if dh is None:
                continue
            if inject:
                if dmicro is None:
                    dmicro = torch.zeros((m,) + tuple(self.mb_shape),
                                         dtype=dh.dtype, device=dh.device)
                dmicro[mb] = dh
            else:
                g_next = dh
        self.entries.clear()
        # dx lives on stage 0: every stage gets it (each took the same
        # input, so each has the same gradient of it).
        if dmicro is None:
            dmicro = torch.zeros((m,) + tuple(self.mb_shape),
                                 dtype=self.dtype, device=self.device)
        if s != 0:
            dmicro.zero_()
        dx = collectives.all_reduce_sum(dmicro, self.mesh, self.axis)
        return dx.reshape(self.x_shape), dleaves


class _PipelineFn(torch.autograd.Function):
    """The whole gpipe / circular pass as one autograd node."""

    @staticmethod
    def forward(ctx, run, x, *leaves):
        run.dtype, run.device = x.dtype, x.device
        out, auxes = run.forward(x, list(leaves), keep=True)
        ctx.run = run
        return (out, *auxes)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out, *g_aux):
        dx, dleaves = ctx.run.backward(g_out, list(g_aux))
        ctx.run = None
        return (None, dx, *dleaves)


def _dp_size(mesh) -> int:
    return mesh.axis_size(data_axes(mesh) or ())


def _aux_keys(with_aux) -> Tuple[str, ...]:
    if with_aux is True:
        raise ValueError("with_aux=True infers the aux structure in JAX; "
                         "pass the structure (a dict of the aux keys)")
    return tuple(sorted(with_aux)) if with_aux else ()


def pipeline_apply(stage_fn: Callable[[Any, Any], Any], stacked_params: Any,
                   x: torch.Tensor, mesh, axis: str = "pp",
                   num_microbatches: Optional[int] = None,
                   schedule: str = "gpipe", virtual_stages: int = 1,
                   with_aux: Any = False, seq_axis: Optional[str] = None):
    """Run ``x`` through the stage pipeline; returns the final
    activations (the JAX ``pipeline_apply``).

    ``stage_fn(chunk_params, h) -> h`` applies ONE stage chunk (same
    activation shape in and out) and may run tp / ep / sp collectives
    over the mesh.  ``stacked_params`` (a dict tree of tensors or a
    tensor) lead with this rank's chunks in lap order: one for gpipe,
    ``virtual_stages`` for circular (rank d's lap l is global chunk
    l·S + d); on a mesh without ``axis`` every chunk, in global order.
    ``x`` is this rank's share [B_loc, ...] (the same on every pp rank),
    split into ``num_microbatches`` (default S) along dim 0.  The output
    is the last stage's, on every pp rank.

    ``with_aux``: the aux structure (a dict of keys; JAX infers it from
    ``True`` by abstract evaluation, which has no counterpart here) —
    ``stage_fn`` then returns ``(h, aux)`` with ``aux`` a dict of scalars,
    and the call returns ``(out, aux_mean)``, each scalar averaged over
    every chunk execution (chunks × microbatches) and the data shards,
    and over ``seq_axis`` (the sequence dim cut over that axis: stage
    bodies see local shards).  Differentiable: the backward runs the
    timetable in reverse (the module doc)."""
    n_stages = mesh.axis_size(axis) if mesh is not None else 1
    if schedule not in ("gpipe", "circular"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if virtual_stages > 1 and schedule != "circular":
        raise ValueError("virtual_stages > 1 requires schedule='circular'")
    aux_keys = _aux_keys(with_aux)
    leaves, rebuild = _leaves(stacked_params)
    v = virtual_stages if schedule == "circular" else 1
    if n_stages == 1:
        h, auxes = x, []
        for i in range(leaves[0].shape[0]):
            h, aux = _split(stage_fn, bool(aux_keys),
                            rebuild([p[i] for p in leaves]), h)
            auxes.append(aux)
        if not aux_keys:
            return h
        return h, {k: torch.stack([a[k] for a in auxes]).mean(0)
                   for k in aux_keys}
    m = num_microbatches or n_stages
    dp = _dp_size(mesh)
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0] * dp} not divisible into {m} "
                         f"microbatches x {dp} data shards")
    if schedule == "circular":
        if v < 1:
            raise ValueError("virtual_stages must be >= 1")
        if m % n_stages:
            raise ValueError(f"circular schedule needs microbatches ({m}) "
                             f"divisible by pp ({n_stages})")
    if leaves[0].shape[0] != v:
        raise ValueError(f"{schedule} runs {v} chunk(s) a stage: this "
                         f"rank's stacked params have {leaves[0].shape[0]}")
    run = _Apply(stage_fn, rebuild, mesh, axis, m, v, aux_keys, seq_axis)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in leaves)):
        out, *auxes = _PipelineFn.apply(run, x, *leaves)
    else:
        run.dtype, run.device = x.dtype, x.device
        with torch.no_grad():
            out, auxes = run.forward(x, leaves, keep=False)
    if not aux_keys:
        return out
    return out, dict(zip(aux_keys, auxes))


def _check_1f1b(mesh, axis, x, targets, m, v, n_chunks):
    """The JAX ``pipeline_train_1f1b``'s validation, its messages."""
    if mesh is None or axis not in mesh.axes:
        shape = {} if mesh is None else dict(mesh.axes)
        raise ValueError(f"pipeline_train_1f1b: mesh {shape} has "
                         f"no {axis!r} axis (a size-1 axis is fine)")
    n_stages = mesh.axis_size(axis)
    dp = _dp_size(mesh)
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0] * dp} not divisible into {m} "
                         f"microbatches x {dp} data shards")
    if targets.shape[0] != x.shape[0]:
        raise ValueError(f"targets batch {targets.shape[0] * dp} != x "
                         f"batch {x.shape[0] * dp}")
    if v < 1:
        raise ValueError("virtual_stages must be >= 1")
    if v > 1 and n_stages < 2:
        raise ValueError("interleaved virtual stages need a real pp axis "
                         "(n_stages >= 2); v chunks on one device is just "
                         "a deeper stage")
    if n_chunks != v:
        raise ValueError(f"1f1b runs {v} chunk(s) per stage: stacked "
                         f"params have {n_chunks * n_stages} chunks for "
                         f"{n_stages} stages x virtual_stages={v}")


def pipeline_train_1f1b(stage_fn: Callable[[Any, Any], Any],
                        loss_fn: Callable[..., Any], stacked_params: Any,
                        x: torch.Tensor, targets: torch.Tensor, mesh,
                        axis: str = "pp",
                        num_microbatches: Optional[int] = None,
                        tail_params: Any = None, stage_aux: bool = False,
                        virtual_stages: int = 1):
    """One fused forward+backward pipeline pass on the 1F1B timetable
    (the JAX ``pipeline_train_1f1b``).

    ``stage_fn(chunk_params, h) -> h`` as in :func:`pipeline_apply`
    (``stacked_params`` this rank's chunks in lap order, ``x`` and
    ``targets`` its shares, the same on every pp rank);
    ``loss_fn(h_out, target_mb) -> scalar`` a per-microbatch mean, or
    with ``tail_params`` (weights used inside the loss, a final norm and
    head, this rank's blocks of them) ``loss_fn(tail, h_out,
    target_mb)``.  Returns ``(loss, grads, dx)`` — or ``(loss, grads,
    tail_grads, dx)`` — with float32 grads in ``stacked_params``' and
    ``tail_params``' structure, ``dx`` the gradient of ``x``: the loss
    summed over pp (every stage's aux terms, the last stage's loss),
    the tail's grads the last stage's and ``dx`` stage 0's, each on
    every pp rank, then the loss and the grads averaged over the data
    axes and ``dx`` divided by their size (the global batch's).

    A forward tick runs its chunk and stashes the chunk's INPUT; a
    backward tick recomputes the chunk from it and takes its vjp (the
    last chunk seeds from the loss with 1/m), so a rank holds at most S
    microbatch inputs a local chunk.  ``stage_aux=True``: ``stage_fn``
    returns ``(h, aux)`` with ``aux`` a scalar joining the objective at
    the chunk's backward tick, seeded with the same 1/m as the loss.
    ``virtual_stages`` v > 1 runs the interleaved timetable.  The tick's
    forward and backward hops are two ordered exchanges.  JAX's
    ``param_partition``, ``tail_partition`` and ``seq_axis`` cut the
    global arrays in its ``shard_map``; here they arrive cut (a sequence
    cut over sp is the stage body's and the loss's to handle)."""
    n_stages = 1 if mesh is None else mesh.axis_size(axis)
    m = num_microbatches or max(n_stages, 1)
    v = int(virtual_stages)
    leaves, rebuild = _leaves(stacked_params)
    _check_1f1b(mesh, axis, x, targets, m, v, leaves[0].shape[0])
    tail_leaves, tail_rebuild = _leaves(tail_params)
    kinds, mbs, laps = _schedule_1f1b(n_stages, m, v)
    stage = mesh.coord(axis)
    slots = n_stages
    b_loc = x.shape[0]
    micro = x.reshape(m, b_loc // m, *x.shape[1:])
    tmicro = targets.reshape(m, b_loc // m, *targets.shape[1:])
    mb_shape = micro.shape[1:]
    dev, dt = x.device, x.dtype
    h_buf: Dict[int, torch.Tensor] = {}
    g_buf: Dict[int, torch.Tensor] = {}
    dparams = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
    dtail = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in tail_leaves]
    dx = torch.zeros((m,) + tuple(mb_shape), dtype=torch.float32,
                     device=dev)
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    seed = 1.0 / m
    zeros = lambda: torch.zeros(mb_shape, dtype=dt, device=dev)  # noqa

    def chunk(lap, ps):
        return rebuild([p[lap] for p in ps])

    def apply_stage(p, h):
        out = stage_fn(p, h)
        if stage_aux:
            return out[0], out[1].float()
        return out, None

    recv_f = recv_g = None
    for t in range(kinds.shape[0]):
        # File what arrived over the ring: the neighbours' ops last tick,
        # read from the same table (the JAX tick's bookkeeping).
        if n_stages > 1 and t > 0:
            prev_s, next_s = (stage - 1) % slots, (stage + 1) % slots
            up_lap = int(laps[t - 1, prev_s]) + (1 if stage == 0 else 0)
            if kinds[t - 1, prev_s] == 1 and (stage > 0 or up_lap < v):
                h_buf[min(up_lap, v - 1) * slots
                      + int(mbs[t - 1, prev_s]) % slots] = recv_f
            dn_lap = int(laps[t - 1, next_s]) - (
                1 if stage == slots - 1 else 0)
            if kinds[t - 1, next_s] == 2 and (stage < slots - 1
                                              or dn_lap >= 0):
                g_buf[max(dn_lap, 0) * slots
                      + int(mbs[t - 1, next_s]) % slots] = recv_g
        kind, mb, lap = int(kinds[t, stage]), int(mbs[t, stage]), \
            int(laps[t, stage])
        slot = lap * slots + mb % slots
        first = stage == 0 and lap == 0
        send_f = send_g = None
        if kind == 1:
            h_in = micro[mb] if first else h_buf[slot]
            with torch.no_grad():
                send_f = apply_stage(chunk(lap, leaves), h_in)[0]
            h_buf[slot] = h_in
        elif kind == 2:
            h_stash = micro[mb] if first else h_buf.pop(slot)
            ps = [p.detach().requires_grad_(True) for p in leaves]
            h = h_stash.detach().requires_grad_(True)
            with torch.enable_grad():
                out, aux = apply_stage(chunk(lap, ps), h)
                if stage == slots - 1 and lap == v - 1:
                    tl = [p.detach().requires_grad_(True)
                          for p in tail_leaves]
                    tgt = tmicro[mb]
                    lval = (loss_fn(out, tgt) if tail_params is None else
                            loss_fn(tail_rebuild(tl), out, tgt)).float()
                    if aux is not None:
                        lval = lval + aux
                    grads = torch.autograd.grad(
                        lval, [h] + ps + tl,
                        torch.full_like(lval, seed), allow_unused=True)
                    dtl = grads[1 + len(ps):]
                else:
                    g_in = g_buf.pop(slot)
                    outs, seeds = [out], [g_in.to(out.dtype)]
                    if aux is not None and aux.requires_grad:
                        outs.append(aux)
                        seeds.append(torch.full_like(aux, seed))
                    lval = aux if aux is not None else None
                    grads = torch.autograd.grad(outs, [h] + ps, seeds,
                                                allow_unused=True)
                    dtl = ()
            if lval is not None:
                loss_acc = loss_acc + lval.detach().float()
            dh = grads[0]
            for acc, g in zip(dparams, grads[1:1 + len(ps)]):
                if g is not None:
                    acc[lap] += g[lap].float()
            for acc, g in zip(dtail, dtl):
                if g is not None:
                    acc += g.float()
            if dh is None:
                dh = torch.zeros_like(h_stash)
            if first:
                dx[mb] = dh.float()
            send_g = dh.to(dt)
        if n_stages > 1:
            recv_f = _hop(send_f if send_f is not None else zeros(), mesh,
                          axis, 1)
            recv_g = _hop(send_g if send_g is not None else zeros(), mesh,
                          axis, -1)
    if n_stages > 1:
        loss = collectives.all_reduce_sum(loss_acc, mesh, axis)
        if stage != slots - 1:
            for g in dtail:
                g.zero_()
        dtail = [collectives.all_reduce_sum(g, mesh, axis) for g in dtail]
        if stage != 0:
            dx.zero_()
        dx = collectives.all_reduce_sum(dx, mesh, axis)
    else:
        loss = loss_acc
    loss = loss / m
    d_axes = data_axes(mesh)
    if d_axes:
        dp = _dp_size(mesh)
        loss = collectives.all_reduce_mean(loss, mesh, d_axes)
        dparams = collectives.grad_sync(dparams, mesh, d_axes)
        dtail = collectives.grad_sync(dtail, mesh, d_axes)
        dx = dx / dp
    dx = dx.reshape(b_loc, *x.shape[1:])
    grads = rebuild(dparams)
    if tail_params is None:
        return loss, grads, dx
    return loss, grads, tail_rebuild(dtail), dx
