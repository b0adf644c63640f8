"""Ring attention: sequence parallelism over the ``sp`` mesh axis (port
of ``tfmesos_tpu/parallel/ring_attention.py``: ``ring_attention_local``
``:43``, ``_merge`` ``:107``, ``_step_cfg`` ``:125``, the flash ring's
forward ``:140`` and backward ``:169``, ``ring_attention`` ``:210``).

Sequences are cut along time over ``sp``: each rank holds
``[B, T/sp, H, D]`` of q, k and v, and the K/V shards rotate around the
ring (``parallel.collectives.ppermute_shift``, one hop a step) while
each rank attends its query block to every shard it holds.  At ring
step s a rank holds the shard of rank ``(i - s) mod sp``.  Causal
structure across shards is the standard decomposition: step 0 is the
rank's own shard (a causal call); a later step holds a shard that is
either wholly visible (its owner comes before) or wholly in the future.

:class:`RingFlash` is the kernel path: each step runs the port's
``flash_forward`` (the ``flash_fwd.cu`` kernel on the card) — causal at
step 0, ``causal=False`` after it, or, with a sliding window, causal at
``q_offset = s · T/sp`` so the kernel's window bound skips far shards'
blocks — and merges the partial outputs by their logsumexps.  Its
backward re-rotates K/V and runs ``flash_bwd_dq`` / ``flash_bwd_dkv``
at every step with the GLOBAL merged lse, the merged output and float32
gradients (p = exp(s·scale − lse) is then already normalized over the
whole ring, so per-shard contributions just sum); the dk/dv
accumulators ride the ring with their shards and take one final hop
home.  Here the owner of a shard is a Python int, so a step whose shard
is wholly in the future (or wholly outside the window) launches no
kernel at all: its contribution is zero, as the JAX ring's masks make
it.  :func:`ring_attention_local` is the einsum ring with online
softmax, the plain version on any device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tfmesos_tpu_torch.ops.attention import (flash_attention,
                                             flash_backward, flash_forward)
from tfmesos_tpu_torch.parallel.collectives import ppermute_shift

__all__ = ["ring_attention_local", "ring_attention", "RingFlash"]


def ring_attention_local(q, k, v, mesh, axis: str = "sp",
                         causal: bool = True,
                         scale: Optional[float] = None,
                         window: Optional[int] = None) -> torch.Tensor:
    """The einsum ring (plain PyTorch; differentiable through autograd
    and the hops' Functions).  Local q/k/v ``[B, T/sp, H, D]`` with
    matching heads; the owner index gives every held key its global
    position, so causal and window masks are exact across shards."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    sp = mesh.axis_size(axis)
    idx = mesh.coord(axis)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    qf = q.float() * scale
    o = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tq, 1), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, tq, 1), dtype=torch.float32, device=q.device)
    qpos = idx * tq + torch.arange(tq, device=q.device)[:, None]
    for step in range(sp):
        src = (idx - step) % sp
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
        if causal:
            kpos = src * tk + torch.arange(tk, device=q.device)[None, :]
            bad = kpos > qpos
            if window is not None:
                bad = bad | (kpos < qpos - (window - 1))
            s = s.masked_fill(bad, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        # A fully masked block leaves m_new at -inf: a finite proxy
        # keeps exp(-inf - proxy) at 0 instead of nan.
        m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                             m_new)
        p = torch.exp(s - m_safe)
        corr = torch.exp(m - m_safe)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + torch.einsum("bhqk,bkhd->bhqd", p, v.float())
        m = m_new
        if step != sp - 1:
            k = ppermute_shift(k, mesh, axis, 1)
            v = ppermute_shift(v, mesh, axis, 1)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l).transpose(1, 2).to(q.dtype)


def _merge(o_acc, lse_acc, o_i, lse_i):
    """Merge two normalized partial attentions by their logsumexps.
    o: [B, T, H, D] float32; lse: [B, H, T, 1].  exp(-inf - finite) = 0
    handles fully masked partials."""
    lse_new = torch.logaddexp(lse_acc, lse_i)
    w_a = torch.exp(lse_acc - lse_new).transpose(1, 2)       # [B, T, H, 1]
    w_i = torch.exp(lse_i - lse_new).transpose(1, 2)
    return o_acc * w_a + o_i * w_i, lse_new


def _step_cfg(causal: bool, window: Optional[int], step: int, t: int):
    """(causal, q_offset) of ring step ``step`` (the JAX ``_step_cfg``):
    with a window every step is causal at q_offset ``step · t`` (the
    global-position arithmetic; the kernel skips k-blocks outside the
    window); without one, steps past the first run the full kernel."""
    if window is None:
        return (causal if step == 0 else False), 0
    return True, step * t


def _visible(causal: bool, window: Optional[int], step: int, sp: int,
             idx: int, t: int) -> bool:
    """Whether ring step ``step``'s shard holds any key this rank's
    queries see: under causal masking a later owner's shard is wholly in
    the future; under a window a shard ``step`` shards back is wholly
    outside it when its last key trails the first query by ``window``
    or more."""
    if step == 0 or not causal:
        return True
    if (idx - step) % sp >= idx:
        return False
    return window is None or (step - 1) * t + 1 < window


class RingFlash(torch.autograd.Function):
    """The flash ring over the sp group (the JAX ``_ring_flash``
    custom VJP); q/k/v local ``[B, T/sp, H, D]`` with matching heads."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale, window):
        sp, idx = mesh.axis_size(axis), mesh.coord(axis)
        t = q.shape[1]
        c0, off0 = _step_cfg(causal, window, 0, t)
        o, lse = flash_forward(q, k, v, causal=c0, scale=scale,
                               window=window, q_offset=off0)
        o = o.float()
        kr, vr = k, v
        for step in range(1, sp):
            kr = ppermute_shift(kr, mesh, axis, 1)
            vr = ppermute_shift(vr, mesh, axis, 1)
            if not _visible(causal, window, step, sp, idx, t):
                continue
            cs, off = _step_cfg(causal, window, step, t)
            o_i, lse_i = flash_forward(q, kr, vr, causal=cs, scale=scale,
                                       window=window, q_offset=off)
            o, lse = _merge(o, lse, o_i.float(), lse_i)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (mesh, axis, causal, scale, window)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, causal, scale, window = ctx.cfg
        sp, idx = mesh.axis_size(axis), mesh.coord(axis)
        t = q.shape[1]
        g = g.contiguous()
        c0, off0 = _step_cfg(causal, window, 0, t)
        dq, dk, dv = flash_backward(q, k, v, out, lse, g, causal=c0,
                                    scale=scale, window=window,
                                    q_offset=off0, out_dtype=torch.float32)
        kr, vr = k, v
        for step in range(1, sp):
            kr = ppermute_shift(kr, mesh, axis, 1)
            vr = ppermute_shift(vr, mesh, axis, 1)
            dk = ppermute_shift(dk, mesh, axis, 1)
            dv = ppermute_shift(dv, mesh, axis, 1)
            if not _visible(causal, window, step, sp, idx, t):
                continue
            cs, off = _step_cfg(causal, window, step, t)
            dqc, dkc, dvc = flash_backward(q, kr, vr, out, lse, g,
                                           causal=cs, scale=scale,
                                           window=window, q_offset=off,
                                           out_dtype=torch.float32)
            dq = dq + dqc
            dk = dk + dkc
            dv = dv + dvc
        # One final hop completes the ring: contributions land home.
        dk = ppermute_shift(dk, mesh, axis, 1)
        dv = ppermute_shift(dv, mesh, axis, 1)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = True,
                   scale: Optional[float] = None,
                   window: Optional[int] = None) -> torch.Tensor:
    """Sequence-parallel attention through :class:`RingFlash`: q/k/v
    this rank's ``[B, T/sp, H, D]`` shards of the sequence (matching
    heads: a GQA caller broadcasts K/V up first, as
    ``ops.attention.attend`` does).  Without a (non-trivial) ``axis`` it
    is one ``flash_attention`` call.  ``window`` (causal only) is exact
    across shards."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if mesh is None or mesh.axis_size(axis) == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               window=window)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return RingFlash.apply(q, k, v, mesh, axis, bool(causal), float(scale),
                           None if window is None else int(window))
