"""Single-device train and eval steps (port of
``tfmesos_tpu/train/trainer.py:32-194, 273-305`` with ``mesh=None``).

``make_train_step`` keeps the JAX call shape,
``step(params, opt_state, batch) -> (params, opt_state, metrics)``, and
its semantics: the gradient of ``loss_fn``, averaged over ``grad_accum``
equal microbatches, one optimizer update, then ``postprocess``.
PyTorch updates in place, so the params and state that come back are
the objects passed in.  The mesh, ``param_specs``, ``steps_per_call``,
``scan_unroll`` and ``grads_fn`` belong to the multi-device slices and
are not arguments here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from tfmesos_tpu_torch.convert import flatten, unflatten
from tfmesos_tpu_torch.train.optim import AdamW, OptState


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def make_train_step(loss_fn: Callable, optimizer: AdamW,
                    postprocess: Optional[Callable] = None,
                    grad_accum: int = 1) -> Callable:
    """Build the train step.

    ``loss_fn(params, batch) -> (loss, metrics)``; ``optimizer`` an
    :class:`~tfmesos_tpu_torch.train.optim.AdamW` whose ``init(params)``
    made ``opt_state``.  ``grad_accum > 1`` splits each batch (every
    leaf along dim 0, which must divide evenly) into that many
    microbatches and averages their float32 gradients before the single
    update — the full-batch step for a per-example-mean loss, at
    1/grad_accum the activation memory; the returned metrics are then
    microbatch means.  ``postprocess(params)`` runs on the updated params
    (in place, under ``no_grad``).  ``metrics["loss"]`` is the loss
    (a device tensor: reading it syncs)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

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

    def step(params, opt_state: OptState, batch):
        grads, loss, metrics = grads_and_metrics(params, batch)
        opt_state = optimizer.update(grads, opt_state)
        if postprocess is not None:
            with torch.no_grad():
                postprocess(params)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def make_eval_step(loss_fn: Callable) -> Callable:
    """Forward-only step: ``loss_fn(params, batch) -> (loss, metrics)``
    becomes ``eval_step(params, batch) -> metrics`` (loss included),
    run under ``no_grad``."""

    def step(params, batch):
        with torch.no_grad():
            loss, metrics = loss_fn(params, batch)
        out = dict(metrics)
        out["loss"] = loss
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
