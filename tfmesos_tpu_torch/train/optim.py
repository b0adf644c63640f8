"""The optimizer of the flagship trainer (counterparts of the optax calls
of ``examples/transformer_train.py:124-139``).

``adamw(lr, weight_decay)`` is ``optax.adamw`` — optionally chained
after ``optax.clip_by_global_norm`` — as a ``torch.optim.AdamW`` over
the params dict's leaves.  The shape is optax's: the returned
:class:`AdamW` holds the hyperparameters, ``init(params)`` builds the
state (the torch optimizer, which keeps the moments, and optax's step
``count``), and ``update(grads, state)`` applies one step to the params
IN PLACE.  A learning-rate schedule is evaluated at ``count`` before
the step, as optax's ``scale_by_learning_rate`` does: 0 on the first
update, so a warmup from 0 moves nothing on step one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Union

import torch

from tfmesos_tpu_torch.convert import flatten

Schedule = Callable[[int], float]

# optax.adamw's defaults, which the example keeps.
B1, B2, EPS = 0.9, 0.999, 1e-8


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """optax's formula: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps`` (constant ``init_value`` if that is <= 0), then a
    cosine from ``peak_value`` to ``end_value`` over the remaining
    ``decay_steps - warmup_steps``, flat after."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed "
                         f"warmup_steps ({warmup_steps})")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = float(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(float(count - warmup_steps), cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine ** exponent + alpha)

    return schedule


def clip_by_global_norm(max_norm: float
                        ) -> Callable[[Sequence[torch.Tensor]], torch.Tensor]:
    """optax's clip: with g_norm the global L2 norm of all gradients,
    each g becomes ``(g / g_norm) * max_norm`` when g_norm >= max_norm
    and stays as it is otherwise.  The returned function clips a list of
    gradients IN PLACE, on the device (no host sync), and returns
    g_norm."""

    def clip(grads: Sequence[torch.Tensor]) -> torch.Tensor:
        g_norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        keep = g_norm < max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, (g / g_norm.to(g.dtype)) * max_norm))
        return g_norm

    return clip


@dataclass
class OptState:
    """State of :class:`AdamW`: the torch optimizer (it owns the first
    and second moments of every leaf) and optax's update ``count``."""

    torch_opt: torch.optim.AdamW
    leaves: List[torch.Tensor]
    count: int = 0


@dataclass(frozen=True)
class AdamW:
    """``optax.adamw(lr, weight_decay=weight_decay)`` (b1 0.9, b2 0.999,
    eps 1e-8), after ``optax.clip_by_global_norm(max_norm)`` when
    ``max_norm`` > 0.  ``lr`` is a float or a schedule of optax's
    ``count``."""

    lr: Union[float, Schedule]
    weight_decay: float = 0.01
    max_norm: float = 0.0

    def _lr(self, count: int) -> float:
        return float(self.lr(count) if callable(self.lr) else self.lr)

    def init(self, params: Dict) -> OptState:
        """A fresh state over ``params``' leaves (which must be leaf
        tensors; they get ``requires_grad``).  Every hyperparameter is
        passed explicitly, so none rests on torch's defaults."""
        leaves = list(flatten(params).values())
        for p in leaves:
            p.requires_grad_(True)
        opt = torch.optim.AdamW(
            leaves, lr=self._lr(0), betas=(B1, B2), eps=EPS,
            weight_decay=self.weight_decay, amsgrad=False, maximize=False,
            foreach=None, capturable=False, differentiable=False,
            fused=None)
        return OptState(opt, leaves)

    def update(self, grads: Dict, state: OptState) -> OptState:
        """One step: clip (when asked), then AdamW at lr(count) — the
        decay term scaled by the same lr, as in optax's chain — applied
        to the params in place; ``count`` advances by one."""
        gs = list(flatten(grads).values())
        if len(gs) != len(state.leaves):
            raise ValueError(f"{len(gs)} gradients for "
                             f"{len(state.leaves)} params")
        if self.max_norm > 0:
            clip_by_global_norm(self.max_norm)(gs)
        for p, g in zip(state.leaves, gs):
            p.grad = g.to(p.dtype)
        lr = self._lr(state.count)
        for group in state.torch_opt.param_groups:
            group["lr"] = lr
        state.torch_opt.step()
        state.torch_opt.zero_grad(set_to_none=True)
        state.count += 1
        return state


def adamw(lr: Union[float, Schedule], weight_decay: float = 0.01,
          max_norm: float = 0.0) -> AdamW:
    """The example's optimizer: ``optax.adamw(lr, weight_decay=0.01)``
    with optax's defaults b1 0.9, b2 0.999, eps 1e-8, chained after
    ``clip_by_global_norm(max_norm)`` when ``max_norm`` > 0."""
    return AdamW(lr=lr, weight_decay=weight_decay, max_norm=max_norm)
