"""Train and eval steps and the step loop (port of
``tfmesos_tpu/train/trainer.py``: one device, or a dp/fsdp x tp mesh of
ranks).

``make_train_step`` keeps the JAX call shape,
``step(params, opt_state, batch) -> (params, opt_state, metrics)``, and
its semantics: the gradient of ``loss_fn``, averaged over ``grad_accum``
equal microbatches, one optimizer update, then ``postprocess``;
``steps_per_call`` such steps in one call.  PyTorch updates in place,
so the params and state that come back are the objects passed in.  With
a data ``mesh`` of several ranks, each rank passes its own equal share
of the global batch and the gradients are averaged over the mesh before
the update, which is the JAX step's arithmetic on the global batch.
With ``param_specs`` the params are each rank's blocks (tp and fsdp,
``parallel.sharding.place_tree``), and so are the gradients and the
AdamW state; the global-norm clip sums its squares over the shards.
``grads_fn`` belongs to the pipeline-parallel slice (ROADMAP A.10) and
is not an argument here.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

from tfmesos_tpu_torch.convert import flatten, unflatten
from tfmesos_tpu_torch.parallel import collectives
from tfmesos_tpu_torch.parallel.sharding import data_axes, spec_axes
from tfmesos_tpu_torch.train.optim import AdamW, OptState
from tfmesos_tpu_torch.utils.logging import get_logger

log = get_logger("tfmesos_tpu_torch.trainer")


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def mesh_mean(tensors: List[torch.Tensor], mesh, axes=None
              ) -> List[torch.Tensor]:
    """Each tensor averaged over ``mesh``'s ranks on ``axes`` (its data
    axes by default: ``all_reduce(SUM) / size``), as fresh tensors, in
    one collective per dtype however many leaves there are
    (``collectives.grad_sync``)."""
    return collectives.grad_sync(tensors, mesh, axes or data_axes(mesh)
                                 or ())


def _flat_specs(param_specs, names: List[str]) -> List[Any]:
    """The spec of each flattened leaf name (``layers/wq``)."""
    out = []
    for name in names:
        node = param_specs
        for part in name.split("/"):
            node = node[part]
        out.append(node)
    return out


def sharded_grad_mean(grads: List[torch.Tensor], specs: List[Any],
                      mesh) -> List[torch.Tensor]:
    """The global batch's gradient of each leaf block: a leaf cut over
    fsdp came out of its reduce-scatter summed over fsdp already, so it
    is averaged over dp and divided by fsdp; every other leaf (whole, or
    cut over tp only) is averaged over the data axes."""
    fsdp = mesh.axis_size("fsdp")
    sharded = [i for i, s in enumerate(specs)
               if fsdp > 1 and "fsdp" in spec_axes(s, mesh)]
    rest = [i for i in range(len(grads)) if i not in set(sharded)]
    out: List[Any] = list(grads)
    for idx, axes, div in ((sharded, ("dp",), fsdp),
                           (rest, data_axes(mesh) or (), 1)):
        if not idx:
            continue
        for i, g in zip(idx, mesh_mean([grads[i] for i in idx], mesh,
                                       axes)):
            out[i] = g / div if div > 1 else g
    return out


def sharded_sumsq(specs: List[Any], mesh):
    """``sumsq(grads)``: the global sum of squares of leaf blocks cut per
    ``specs`` — each leaf's local sum, summed over the axes it is cut
    over (one collective per set of axes), each whole leaf counted
    once."""
    def sumsq(grads):
        by_axes: Dict[tuple, Any] = {}
        for g, s in zip(grads, specs):
            axes = tuple(sorted(set(spec_axes(s, mesh))))
            by_axes[axes] = by_axes.get(axes, 0.0) + torch.sum(
                g.float() ** 2)
        return sum(collectives.all_reduce_sum(v, mesh, axes) if axes else v
                   for axes, v in by_axes.items())
    return sumsq


def make_train_step(loss_fn: Callable, optimizer: AdamW,
                    postprocess: Optional[Callable] = None,
                    steps_per_call: int = 1, grad_accum: int = 1,
                    scan_unroll: int = 1, mesh=None,
                    param_specs=None) -> Callable:
    """Build the train step.

    ``loss_fn(params, batch) -> (loss, metrics)``; ``optimizer`` an
    :class:`~tfmesos_tpu_torch.train.optim.AdamW` (or
    :class:`~tfmesos_tpu_torch.train.optim.SGD`) whose ``init(params)``
    made ``opt_state``.  ``mesh`` a data mesh
    (``parallel.mesh.build_mesh``): above size 1, every rank calls the
    step with its own equal share of the global batch, each gradient
    leaf is averaged over the mesh (:func:`mesh_mean`) before clipping
    and the update, and the loss and metrics are the ranks' means (the
    loss is then the global batch's); every rank ends with bitwise the
    same params.  ``grad_accum > 1`` splits each batch (every
    leaf along dim 0, which must divide evenly) into that many
    microbatches and averages their float32 gradients before the single
    update — the full-batch step for a per-example-mean loss, at
    1/grad_accum the activation memory; the returned metrics are then
    microbatch means.  ``param_specs`` (with a ``mesh``; the model's
    ``partition_specs``): the params are this rank's blocks, the loss
    function runs over them on the mesh, and each gradient block is the
    global batch's (:func:`sharded_grad_mean`); the AdamW state is then
    the rank's blocks too, and its global-norm clip is the one a single
    process clips by (:func:`sharded_sumsq`).
    ``postprocess(params)`` runs on the updated params
    (in place, under ``no_grad``).  ``metrics["loss"]`` is the loss
    (a device tensor: reading it syncs).

    ``steps_per_call > 1`` runs that many optimizer steps in one call,
    over batch leaves with a leading ``[steps_per_call, ...]`` dim (each
    step's batch ``leaf[i]``), and returns the last step's metrics: the
    same arithmetic as that many calls.  ``scan_unroll`` must divide
    ``steps_per_call``, as for the JAX step, whose scan it unrolls; the
    steps here are a Python loop, so it changes no arithmetic and no
    launch."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got "
                         f"{steps_per_call}")
    if scan_unroll < 1 or steps_per_call % scan_unroll:
        raise ValueError(f"scan_unroll ({scan_unroll}) must divide "
                         f"steps_per_call ({steps_per_call})")

    def grads_and_metrics(params, batch):
        flat = flatten(params)
        names, leaves = list(flat), list(flat.values())
        if grad_accum == 1:
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves)
            return unflatten(dict(zip(names, grads))), loss.detach(), {
                k: v.detach() for k, v in metrics.items()}
        micro = {k: v.chunk(grad_accum, dim=0) for k, v in batch.items()}
        if any(len(c) != grad_accum or c[0].shape[0] * grad_accum
               != batch[k].shape[0] for k, c in micro.items()):
            raise ValueError(f"batch does not split into {grad_accum} "
                             f"equal microbatches")
        gsum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        lsum: Any = 0.0
        msum: Dict[str, Any] = {}
        for i in range(grad_accum):
            loss, metrics = loss_fn(params, {k: c[i]
                                             for k, c in micro.items()})
            for acc, g in zip(gsum, torch.autograd.grad(loss, leaves)):
                acc += g
            lsum = lsum + loss.detach()
            for k, v in metrics.items():
                msum[k] = msum.get(k, 0.0) + v.detach()
        grads = [(g / grad_accum).to(p.dtype) for g, p in zip(gsum, leaves)]
        return (unflatten(dict(zip(names, grads))), lsum / grad_accum,
                {k: v / grad_accum for k, v in msum.items()})

    reduce = mesh is not None and mesh.size() > 1
    sharded = reduce and param_specs is not None
    specs: Optional[List[Any]] = None
    sumsq = None

    def one_step(params, opt_state: OptState, batch):
        nonlocal specs, sumsq
        grads, loss, metrics = grads_and_metrics(params, batch)
        kw = {}
        if reduce:
            flat = flatten(grads)
            names, keys = list(flat), list(metrics)
            gs = list(flat.values())
            scalars = [loss] + [metrics[k] for k in keys]
            if sharded:
                if specs is None:
                    specs = _flat_specs(param_specs, names)
                    sumsq = sharded_sumsq(specs, mesh)
                if getattr(optimizer, "max_norm", 0) > 0:
                    kw["sumsq"] = sumsq
                mean = sharded_grad_mean(gs, specs, mesh) + mesh_mean(
                    scalars, mesh)
            else:
                mean = mesh_mean(gs + scalars, mesh)
            grads = unflatten(dict(zip(names, mean)))
            loss = mean[len(names)]
            metrics = dict(zip(keys, mean[len(names) + 1:]))
        opt_state = optimizer.update(grads, opt_state, **kw)
        if postprocess is not None:
            with torch.no_grad():
                postprocess(params)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    if steps_per_call == 1:
        return one_step

    def step(params, opt_state: OptState, batch):
        if any(v.shape[0] != steps_per_call for v in batch.values()):
            raise ValueError(f"batch leaves must lead with steps_per_call "
                             f"({steps_per_call})")
        for i in range(steps_per_call):
            params, opt_state, metrics = one_step(
                params, opt_state, {k: v[i] for k, v in batch.items()})
        return params, opt_state, metrics

    return step


def make_eval_step(loss_fn: Callable, mesh=None) -> Callable:
    """Forward-only step: ``loss_fn(params, batch) -> (loss, metrics)``
    becomes ``eval_step(params, batch) -> metrics`` (loss included),
    run under ``no_grad``.  With a ``mesh`` every rank passes its share
    of the batch and the metrics are averaged over the data axes (a
    loss function already on the mesh returns the global values, which
    the mean keeps)."""

    def step(params, batch):
        with torch.no_grad():
            loss, metrics = loss_fn(params, batch)
        out = dict(metrics)
        out["loss"] = loss
        if mesh is not None and data_axes(mesh):
            keys = list(out)
            out = dict(zip(keys, mesh_mean([out[k] for k in keys], mesh)))
        return out

    return step


def evaluate(eval_step: Callable, params, batches: Iterator,
             num_batches: int) -> Dict[str, float]:
    """Run ``num_batches`` eval steps and return the metric means.  The
    metrics stay on the device until the end, so the steps queue without
    a host sync between them."""
    acc: Dict[str, list] = {}
    for _ in range(num_batches):
        for k, v in eval_step(params, next(batches)).items():
            acc.setdefault(k, []).append(v)
    return {k: float(torch.stack(vs).sum()) / num_batches
            for k, vs in acc.items()}


def _sync(params) -> None:
    """Wait for the card that holds ``params`` (no-op on the CPU)."""
    leaf = next(iter(flatten(params).values()), None)
    if leaf is not None and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


@dataclass
class TrainLoop:
    """Step loop with timing (the JAX ``TrainLoop`` on one device).

    ``metrics_path`` appends one JSON line a logged step
    (``{"step": N, "wall_s": ..., **metrics}``).  ``checkpoint`` (a
    :class:`~tfmesos_tpu_torch.train.checkpoint.CheckpointManager`)
    coordinates restarts: :meth:`resume` restores the latest saved
    state (step included) before a run, and :meth:`run` saves every
    ``save_every`` global steps, ``save_async=True`` overlapping the
    write with the next steps.  The ``restores`` / ``resumed_step``
    counters say how a supervised job recovered (they ride the result
    dict too).  The reference's bounded profiler window
    (``utils/profiling.py``) is not ported (ROADMAP A.11): this loop
    writes no trace."""

    step_fn: Callable
    state: TrainState
    log_every: int = 50
    name: str = "train"
    metrics_path: Optional[str] = None
    checkpoint: Optional[Any] = None
    save_every: int = 0
    save_async: bool = False
    restores: int = 0
    resumed_step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        """The checkpointable form of ``state``, which is also the
        restore template (a restore copies into its tensors)."""
        return {"params": self.state.params,
                "opt_state": self.state.opt_state,
                "step": self.state.step}

    def resume(self) -> int:
        """Restore the latest checkpoint (if any) into ``state`` and
        return the step to resume from (0 on a cold start).  The caller
        realigns its batch iterator to that step — see
        ``supervisor.supervise_training``."""
        if self.checkpoint is None:
            return 0
        restored = self.checkpoint.restore(self.state_dict())
        if restored is None:
            return 0
        self.state = TrainState(restored["params"], restored["opt_state"],
                                int(restored["step"]))
        self.restores += 1
        self.resumed_step = self.state.step
        log.info("%s resuming from checkpoint step %d", self.name,
                 self.state.step)
        return self.state.step

    def run(self, batches: Iterator[Dict[str, Any]], num_steps: int,
            on_metrics: Optional[Callable[[int, Dict], None]] = None
            ) -> Dict[str, Any]:
        params, opt_state = self.state.params, self.state.opt_state
        t_start = time.perf_counter()
        metrics: Dict[str, Any] = {}
        sink = open(self.metrics_path, "a") if self.metrics_path else None
        try:
            for i in range(num_steps):
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, next(batches))
                gstep = self.state.step + i + 1
                if (self.checkpoint is not None and self.save_every
                        and gstep % self.save_every == 0):
                    self.checkpoint.save(
                        gstep, {"params": params, "opt_state": opt_state,
                                "step": gstep},
                        wait=not self.save_async)
                if (i + 1) % self.log_every == 0 or i + 1 == num_steps:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    if sink:
                        sink.write(json.dumps(
                            {"step": gstep,
                             "wall_s": round(time.perf_counter() - t_start,
                                             3),
                             **metrics}) + "\n")
                        sink.flush()
                    if on_metrics:
                        on_metrics(i + 1, metrics)
                    else:
                        log.info("%s step %d: %s", self.name, i + 1,
                                 {k: round(v, 4) for k, v in metrics.items()})
            _sync(params)
            if self.checkpoint is not None and self.save_async:
                self.checkpoint.wait_until_finished()
        finally:
            if sink:
                sink.close()
        elapsed = time.perf_counter() - t_start
        start_step = self.state.step
        self.state = TrainState(params, opt_state, start_step + num_steps)
        # One card a rank: every rank's card, as jax.device_count().
        n_dev = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 1)
        return {
            "elapsed_s": elapsed,
            "steps_per_sec": num_steps / elapsed,
            "steps_per_sec_per_chip": num_steps / elapsed / n_dev,
            "start_step": start_step,
            "final_step": self.state.step,
            "restores": self.restores,
            "resumed_step": self.resumed_step,
            "final_metrics": metrics,
        }
