"""Elementwise/normalization building blocks and the LM head's cross
entropy (port of ``tfmesos_tpu/ops/layers.py:20-151``).

Plain PyTorch: on the card these are small memory-bound passes beside
the matmuls, and the cross entropy's matmuls are plain large products
(the JAX package leaves all of them to XLA).  The cast points are the
JAX package's, exactly — float32 statistics, the compute dtype
preserved on the output — so a float32 run matches the reference to
rounding and a bf16 run rounds where it does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Statistics in float32, cast back to ``x.dtype``, THEN scaled by
    ``weight`` (already in the compute dtype)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x·Wg) ⊙ (x·Wu) · Wd."""
    g = F.silu(x @ w_gate)
    return (g * (x @ w_up)) @ w_down


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over the last (head_dim) axis,
    half-split (not interleaved).

    ``x``: [..., T, H, D]; ``positions``: [..., T] integer.  Frequencies
    and angles are float32; the result is cast to ``x.dtype``."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    # A fill, not a host-to-device copy: a CUDA graph can capture it.
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=x.device), exps)
    angles = positions[..., None].to(torch.float32) * freqs   # [..., T, half]
    cos = torch.cos(angles)[..., None, :]                     # over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       z_loss: float = 0.0) -> torch.Tensor:
    """Mean softmax cross entropy in float32; optional z-loss
    regularizer (``z_loss`` · mean(logsumexp²))."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = torch.mean(logz - picked)
    if z_loss:
        loss = loss + z_loss * torch.mean(logz ** 2)
    return loss


def _ce_chunk(n: int, target: int) -> int:
    """Largest divisor of ``n`` at or under ``target``; ``n`` itself when
    that divisor is tiny (a prime token count has none near the target,
    and a loop of tiny matmuls would be pathologically slow)."""
    target = min(n, max(1, target))
    c = target
    while n % c:
        c -= 1
    return c if c * 8 >= target else n


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated AND returned in float32 (the JAX
    ``preferred_element_type=float32``).  bf16 operands on the card keep
    the tensor cores (cuBLAS with a float32 output); elsewhere the
    operands go up to float32 first, which is exact for bf16 values."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _FusedLinearCE(torch.autograd.Function):
    """Chunked head + cross entropy (the JAX ``custom_vjp``): the forward
    keeps one [chunk, V] block of float32 logits alive at a time and
    saves the per-token logsumexp; the backward recomputes each chunk's
    logits from it, so the full [N, V] logits never exist."""

    @staticmethod
    def forward(ctx, x, w, labels, z_loss, chunk):
        d = x.shape[-1]
        xf, lf = x.reshape(-1, d), labels.reshape(-1).long()
        n = xf.shape[0]
        c = _ce_chunk(n, chunk)
        wc = w.to(x.dtype)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        logzs = torch.empty(n, dtype=torch.float32, device=x.device)
        for i in range(0, n, c):
            logits = (xf[i:i + c] @ wc).float()              # [c, V]
            logz = torch.logsumexp(logits, dim=-1)
            picked = logits.gather(1, lf[i:i + c, None])[:, 0]
            s = torch.sum(logz - picked)
            if z_loss:
                s = s + z_loss * torch.sum(logz ** 2)
            total = total + s
            logzs[i:i + c] = logz
        ctx.save_for_backward(x, w, labels, logzs)
        ctx.z_loss, ctx.chunk = z_loss, c
        return total / n

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w, labels, logzs = ctx.saved_tensors
        z_loss, c = ctx.z_loss, ctx.chunk
        d = x.shape[-1]
        xf, lf = x.reshape(-1, d), labels.reshape(-1).long()
        n = xf.shape[0]
        wc = w.to(x.dtype)
        scale = g / n
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dx = torch.empty_like(xf)
        for i in range(0, n, c):
            xc, lc, logz = xf[i:i + c], lf[i:i + c], logzs[i:i + c]
            logits = (xc @ wc).float()
            p = torch.exp(logits - logz[:, None])            # softmax
            if z_loss:
                p = p * (1.0 + (2.0 * z_loss) * logz)[:, None]
            dlogits = ((p - F.one_hot(lc, logits.shape[-1]).float())
                       * scale).to(x.dtype)
            dx[i:i + c] = dlogits @ wc.T
            dw += _mm_f32(xc.T, dlogits)                     # [d, V] fp32
        return dx.reshape(x.shape), dw.to(w.dtype), None, None, None


def fused_linear_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                               labels: torch.Tensor, z_loss: float = 0.0,
                               chunk: int = 2048) -> torch.Tensor:
    """Mean softmax cross entropy of ``logits = x @ w`` without
    materializing the full logits: tokens are flattened and processed in
    chunks of ``chunk`` (largest divisor of the token count at or under
    it), fwd and bwd, and the backward recomputes each chunk's logits
    from the saved per-token logsumexp.  ``x``: [..., d] in the compute
    dtype; ``w``: [d, V] master weight, cast to x's dtype at use, its
    gradient accumulated in float32 and returned at w's dtype;
    ``labels``: [...] int.  Numerics match :func:`cross_entropy_loss`
    (both reduce in float32)."""
    return _FusedLinearCE.apply(x, w, labels, float(z_loss), int(chunk))


# -- over a mesh ----------------------------------------------------------


class _DataMean(torch.autograd.Function):
    """The loss of the global batch: this rank's loss averaged over the
    data axes forward, identity backward (the gradient stays the rank's
    own share's; the train step averages the gradients over the same
    axes, which is the global batch's gradient)."""

    @staticmethod
    def forward(ctx, loss, mesh, axes):
        from tfmesos_tpu_torch.parallel.collectives import all_reduce_mean

        return all_reduce_mean(loss, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def data_mean(loss: torch.Tensor, mesh) -> torch.Tensor:
    """``loss`` (this rank's share's mean) as the global batch's mean on
    every rank (:class:`_DataMean`); itself without a data axis."""
    from tfmesos_tpu_torch.parallel.sharding import data_axes

    axes = data_axes(mesh)
    if axes is None:
        return loss
    return _DataMean.apply(loss, mesh, axes)


def data_parallel_fused_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                                      labels: torch.Tensor, mesh,
                                      z_loss: float = 0.0,
                                      chunk: int = 2048) -> torch.Tensor:
    """:func:`fused_linear_cross_entropy` on a data mesh (the JAX
    ``data_parallel_fused_cross_entropy``): each rank runs the chunked
    form over its own tokens only, so no chunk cuts across ranks, and
    the loss is averaged over the data axes (:func:`data_mean`).  ``w``
    whole (an fsdp head is gathered by the caller).  Same math as the
    dense form; only the grouping of the sums differs."""
    return data_mean(fused_linear_cross_entropy(x, w, labels, z_loss, chunk),
                     mesh)


class _VocabParallelCE(torch.autograd.Function):
    """Chunked head + cross entropy over this rank's vocab columns (the
    JAX ``vocab_parallel_cross_entropy`` on one rank's shard, Megatron's
    pattern): each chunk's [c, V/tp] logits give a per-token local
    logsumexp and the picked logit where the label is in this rank's
    range; ONE all-gather of the local logsumexps and ONE all-reduce of
    the picked logits over tp make the global statistics.  The backward
    recomputes each chunk's local logits, and dx (a partial sum over
    the vocab) is all-reduced over tp once at the end."""

    @staticmethod
    def forward(ctx, x, w, labels, mesh, z_loss, chunk, lo):
        from tfmesos_tpu_torch.parallel.collectives import (all_gather,
                                                            all_reduce_sum)

        d = x.shape[-1]
        xf, lf = x.reshape(-1, d), labels.reshape(-1).long()
        n = xf.shape[0]
        c = _ce_chunk(n, chunk)
        vl = w.shape[-1]
        wc = w.to(x.dtype)
        lse = torch.empty(n, dtype=torch.float32, device=x.device)
        picked = torch.zeros(n, dtype=torch.float32, device=x.device)
        local = lf - lo
        mine = (local >= 0) & (local < vl)
        idx = local.clamp(0, vl - 1)
        for i in range(0, n, c):
            logits = (xf[i:i + c] @ wc).float()              # [c, V/tp]
            lse[i:i + c] = torch.logsumexp(logits, dim=-1)
            p = logits.gather(1, idx[i:i + c, None])[:, 0]
            picked[i:i + c] = torch.where(mine[i:i + c], p, 0.0)
        tp = mesh.axis_size("tp")
        logz = torch.logsumexp(
            all_gather(lse[None], mesh, "tp", dim=0).reshape(tp, n), dim=0)
        picked = all_reduce_sum(picked, mesh, "tp")
        total = torch.sum(logz - picked)
        if z_loss:
            total = total + z_loss * torch.sum(logz ** 2)
        ctx.save_for_backward(x, w, labels, logz)
        ctx.mesh, ctx.z_loss, ctx.chunk, ctx.lo = mesh, z_loss, c, lo
        return total / n

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        from tfmesos_tpu_torch.parallel.collectives import all_reduce_sum

        x, w, labels, logzs = ctx.saved_tensors
        mesh, z_loss, c = ctx.mesh, ctx.z_loss, ctx.chunk
        d = x.shape[-1]
        xf, lf = x.reshape(-1, d), labels.reshape(-1).long()
        n = xf.shape[0]
        vl = w.shape[-1]
        local = lf - ctx.lo
        mine = (local >= 0) & (local < vl)
        idx = local.clamp(0, vl - 1)
        wc = w.to(x.dtype)
        scale = g / n
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dx = torch.empty_like(xf)
        for i in range(0, n, c):
            xc, logz = xf[i:i + c], logzs[i:i + c]
            logits = (xc @ wc).float()
            p = torch.exp(logits - logz[:, None])            # local softmax
            if z_loss:
                p = p * (1.0 + (2.0 * z_loss) * logz)[:, None]
            onehot = F.one_hot(idx[i:i + c], vl).float() \
                * mine[i:i + c, None]
            dlogits = ((p - onehot) * scale).to(x.dtype)
            dx[i:i + c] = dlogits @ wc.T
            dw += _mm_f32(xc.T, dlogits)
        dx = all_reduce_sum(dx, mesh, "tp")
        return (dx.reshape(x.shape), dw.to(w.dtype), None, None, None,
                None, None)


def vocab_parallel_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                                 labels: torch.Tensor, mesh,
                                 z_loss: float = 0.0, chunk: int = 2048,
                                 vocab: Optional[int] = None
                                 ) -> torch.Tensor:
    """:func:`fused_linear_cross_entropy` for a vocab-cut head (the JAX
    ``vocab_parallel_cross_entropy``): ``w`` this rank's [d, V/tp]
    columns, ``x`` [..., d] and ``labels`` [...] this rank's share of
    the batch, whole over tp.  No rank holds more than a [chunk, V/tp]
    block of logits, forward or backward; the loss is the global
    batch's mean (:func:`data_mean` over the data axes), the same math
    as the unfused path, z-loss included.  ``vocab`` (the whole vocab)
    places an uneven cut's blocks (``parallel.sharding.block``); by
    default the vocab divides over tp."""
    if mesh is None or mesh.axis_size("tp") == 1:
        return data_mean(fused_linear_cross_entropy(x, w, labels, z_loss,
                                                    chunk), mesh)
    from tfmesos_tpu_torch.parallel.sharding import block

    tp = mesh.axis_size("tp")
    b = w.shape[-1] if vocab is None else block(vocab, tp)
    return data_mean(_VocabParallelCE.apply(
        x, w, labels, mesh, float(z_loss), int(chunk),
        mesh.coord("tp") * b), mesh)
