"""Int8 quantization: per-row absmax scaling (port of
``tfmesos_tpu/ops/quant.py:21-147``).

``x ≈ values * scales[row]`` with int8 values clipped to ±127 and one
float32 scale per row (absmax / 127, all-zero rows pinned to 1).  The
``quant_int8.cu`` kernel replaces ``_quant_kernel``; :func:`quantize_int8`
is its wrapper: a CUDA tensor launches the kernel (or raises), a CPU
tensor runs the plain version :func:`quantize_int8_reference`.

Rounding is to nearest, ties to even (``torch.round``, ``rintf`` in the
kernel), so the round-to-nearest kernel is bit-identical to
:func:`quantize_int8_reference`, which is bit-identical to the JAX
package's ground truth of the same name.
Stochastic rounding adds a uniform dither in [-0.5, 0.5) before the
round, drawn from a Philox4x32-10 counter-based generator keyed by
(``seed``, row, col): the kernel and the plain version compute the same
bits, so they agree exactly; neither reproduces the TPU's hardware PRNG
or JAX's threefry, so stochastic rounding is held to JAX statistically.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from tfmesos_tpu_torch.kernels import build

#: Kernel launch count of :func:`quantize_int8` (one per launch of
#: ``quant_int8.cu``; the plain CPU path never counts).
LAUNCHES = {"quant_int8": 0}

_QUANT_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_ulonglong, ctypes.c_void_p]

# Philox4x32-10 constants (Salmon et al., "Parallel random numbers: as
# easy as 1, 2, 3", SC'11) — the same in quant_int8.cu.
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _absmax_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-row absmax / 127 over the last dim (keepdim), zero rows pinned
    to scale 1.0 — the one scale rule of every path."""
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    # A tensor divisor: PyTorch's CUDA division by a python scalar
    # multiplies by its reciprocal, one ulp off the true quotient.
    return torch.where(absmax == 0, torch.ones_like(absmax),
                       absmax / torch.full_like(absmax, 127.0))


def quantize_int8_reference(x: torch.Tensor, stochastic: bool = False,
                            seed: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax quantization of any rank (the ground truth and the
    plain version of ``quant_int8.cu``): values = clip(round(x / scale
    [+ dither]), ±127) with a true division, rows = all leading dims;
    (int8 values, float32 scales with the last dim 1).  ``stochastic``
    adds the kernel's Philox dither, keyed by (``seed``, row, col)."""
    xf = x.float()
    scale = _absmax_scale(xf)
    scaled = xf / scale
    if stochastic:
        cols = xf.shape[-1]
        scaled = scaled + _dither(seed, xf.numel() // max(1, cols), cols,
                                  xf.device).reshape(xf.shape)
    values = torch.clamp(torch.round(scaled), -127, 127)
    return values.to(torch.int8), scale


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor
                    ) -> torch.Tensor:
    return values.float() * scales


def int8_round_trip(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` [..., D] as an int8 slot holds it, back in ``dtype``: each
    D-element row quantized by :func:`quantize_int8` (the kernel on the
    card), then values x scale in ``dtype``.  An int8 value times a scale
    rounded to ``dtype`` is exact in float32, so the slot rounds once.
    The deferred self chunk over an int8 pool is this: it matches a
    committed slot up to where the scale multiplies (the decode kernels
    fold a slot's scale after the dot, in float32)."""
    vals, scale = quantize_int8(x.reshape(-1, x.shape[-1]))
    return (vals.to(dtype) * scale.to(dtype)).reshape(x.shape)


class QTensor(NamedTuple):
    """A tensor stored as int8 ``values`` with float32 ``scales`` (``w ≈
    values * scales``).  Weights carry scales over the last dim's rows
    (the original shape with the last dim 1); KV caches carry them
    lane-major, one per position on the trailing dim (see
    ``models/transformer.init_cache``)."""

    values: torch.Tensor
    scales: torch.Tensor

    def dequantize(self, dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
        return self.values.to(dtype) * self.scales.to(dtype)


def quantize_tensor(w: torch.Tensor, stochastic: bool = False,
                    seed: int = 0) -> QTensor:
    """Quantize an N-D weight to a :class:`QTensor` (per-row absmax over
    the last dim, rows = all leading dims flattened)."""
    shape = tuple(w.shape)
    values, scales = quantize_int8(w.reshape(-1, shape[-1]),
                                   stochastic=stochastic, seed=seed)
    return QTensor(values.reshape(shape), scales.reshape(shape[:-1] + (1,)))


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of ``a * b`` for a constant ``a`` and an
    int64 tensor ``b`` of uint32 values, in int64 arithmetic that never
    overflows (``a`` split into 16-bit halves)."""
    t1 = b * (a & 0xFFFF)                       # < 2^48
    t2 = b * (a >> 16)                          # < 2^48
    mid = t1 + ((t2 & 0xFFFF) << 16)            # low 48 bits of a * b
    return ((t2 >> 16) + (mid >> 32)) & _U32, mid & _U32


def _philox_bits(seed: int, rows: int, cols: int,
                 device) -> torch.Tensor:
    """First output word of Philox4x32-10 at counter (col, row, 0, 0)
    under key (seed low, seed high): [rows, cols] int64 of uint32
    values."""
    c0 = torch.arange(cols, dtype=torch.int64, device=device).expand(
        rows, cols)
    c1 = torch.arange(rows, dtype=torch.int64, device=device)[:, None] \
        .expand(rows, cols)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = seed & _U32, (seed >> 32) & _U32
    for i in range(10):
        if i:
            k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def _dither(seed: int, rows: int, cols: int, device) -> torch.Tensor:
    """Uniform dither in [-0.5, 0.5): the top 24 random bits over 2^24,
    minus one half (exact in float32, as the kernel computes it)."""
    bits = _philox_bits(int(seed), rows, cols, device)
    return (bits >> 8).to(torch.float32) / float(1 << 24) - 0.5


def quantize_int8(x: torch.Tensor, stochastic: bool = False, seed: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``[rows, cols]`` (float32 or bfloat16) to (int8 values,
    float32 per-row scales [rows, 1]): the ``quant_int8.cu`` kernel on a
    CUDA tensor, :func:`quantize_int8_reference` on a CPU tensor."""
    if x.dim() != 2:
        raise ValueError(f"expected 2D input, got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_int8_reference(x, stochastic=stochastic, seed=seed)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_int8: the CUDA kernel takes float32 or "
                        f"bfloat16 input, got {x.dtype}")
    if not 0 <= int(seed) < 2 ** 64:
        raise ValueError(f"quantize_int8: seed must be in [0, 2^64), got "
                         f"{seed}")
    rows, cols = x.shape
    x = x.contiguous()
    values = torch.empty((rows, cols), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows == 0:
        return values, scales
    fn = build.kernel("quant_int8", "tfm_quant_int8", _QUANT_ARGS)
    with torch.cuda.device(x.device):
        LAUNCHES["quant_int8"] += 1
        err = fn(x.data_ptr(), values.data_ptr(), scales.data_ptr(), rows,
                 cols, int(x.dtype == torch.bfloat16), int(stochastic),
                 int(seed), torch.cuda.current_stream(x.device).cuda_stream)
    build.check("quant_int8", err, "quantize_int8")
    return values, scales
