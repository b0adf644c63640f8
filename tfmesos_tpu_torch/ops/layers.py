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
