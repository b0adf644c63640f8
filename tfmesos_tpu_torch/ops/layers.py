"""Elementwise/normalization building blocks (port of
``tfmesos_tpu/ops/layers.py:20-45``).

Plain PyTorch: on the card these are small memory-bound passes beside
the matmuls.  The cast points are the JAX package's, exactly — float32
statistics, the compute dtype preserved on the output — so a float32
run matches the reference to rounding and a bf16 run rounds where it
does.
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
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    angles = positions[..., None].to(torch.float32) * freqs   # [..., T, half]
    cos = torch.cos(angles)[..., None, :]                     # over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
