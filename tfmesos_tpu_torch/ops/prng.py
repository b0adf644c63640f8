"""The subset of ``jax.random`` the reference's sampling uses, on torch
tensors (threefry2x32 keys: ``PRNGKey``, ``fold_in``, ``split``,
``bits``, ``uniform``, ``gumbel``, ``categorical``).

A key is a [2] int64 tensor holding the two uint32 words of a JAX
``PRNGKey`` (``[..., 2]`` for a batch of keys), on the device of its
use.  Every function is built from torch integer ops on int64 with
``& 0xFFFFFFFF`` after each add and shift: no host sync and no Python
branch on a value, so a CUDA graph can hold it.  A leading batch of keys
acts as the reference's ``jax.vmap`` over keys (the batcher folds one key
a row).

The counter layout is jax 0.9.0's default, ``jax_threefry_partitionable
= True`` (``jax/_src/prng.py``): ``split(key, n)`` hashes the counters
(hi 0, lo i) for i < n and keeps both output words as the new key;
``bits(key, shape)`` hashes (hi, lo) = the 64-bit flat index of each
element and returns the xor of the two output words.  The older
non-partitionable layout is not modelled.

The integer functions are bit-exact to jax 0.9.0.  ``gumbel`` takes two
float32 logarithms of the uniform draw, and the logarithm of XLA's CPU
backend is not torch's: the two agree to a few float32 ulps, not to the
bit, so a ``categorical`` draw may fork from JAX's where the two largest
``logits + gumbel`` lie within a few ulps of each other.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


def PRNGKey(seed: int, device: Union[str, torch.device] = "cpu"
            ) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit ``seed``: [2] int64
    ``[0, seed & 0xFFFFFFFF]`` (jax's default config has no 64-bit seeds:
    the high word of an int32 seed is 0, a negative one included)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"PRNGKey: seed must fit int32, got {seed}")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)``: int64 tensors holding uint32 values,
    broadcast together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _hash(key: torch.Tensor, lo: torch.Tensor, ndim: int):
    """Hash counters (hi 0, lo) under every key of ``key`` [..., 2]; ``lo``
    has ``ndim`` dims, which trail the keys' batch dims."""
    k1 = key[..., 0].reshape(key.shape[:-1] + (1,) * ndim)
    k2 = key[..., 1].reshape(key.shape[:-1] + (1,) * ndim)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``key`` [..., 2] and ``data`` (an int or
    an integer tensor broadcasting against the keys' batch dims) ->
    [..., 2]."""
    data = torch.as_tensor(data, device=key.device).long() & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: [..., 2] -> [..., num, 2]."""
    lo = torch.arange(int(num), dtype=torch.int64, device=key.device)
    y1, y2 = _hash(key, lo, 1)
    return torch.stack([y1, y2], dim=-1)


def bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 values in int64):
    [..., 2] keys -> [..., *shape]."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 2 ** 32:
        raise ValueError(f"bits: {n} elements need 64-bit counters")
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    y1, y2 = _hash(key, lo, len(shape))
    return y1 ^ y2


def _f32(x: float, device) -> torch.Tensor:
    """A float32 0-d tensor on ``device``."""
    return torch.full((), float(np.float32(x)), dtype=torch.float32,
                      device=device)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    exponent 0 give [1, 2); minus 1, scaled, shifted and floored at
    ``minval``.  XLA contracts the scale and shift into one fused
    multiply-add, rounded once: here the product is exact in float64 and
    the sum rounds to float64, then to float32 (for the gumbel's
    [tiny, 1) both steps are exact)."""
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    mant = (bits(key, shape) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    out = (floats.double() * float(span) + float(lo)).float()
    return torch.maximum(out, _f32(lo, key.device))


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in float32 (its default "low" mode):
    ``-log(-log(u))`` for u uniform on [tiny, 1)."""
    u = uniform(key, shape, minval=_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1
                ) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)`` (sampling with
    replacement): the argmax of ``logits + gumbel`` along ``axis``, the
    first index on ties.  ``logits`` float32; with keys [K..., 2] the
    draw is batched over the leading K... dims of ``logits`` (the
    reference's ``vmap``), each key's gumbel of the remaining shape."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical: float32 logits, got {logits.dtype}")
    batch = key.dim() - 1
    if tuple(logits.shape[:batch]) != tuple(key.shape[:-1]):
        raise ValueError(f"categorical: keys {tuple(key.shape)} do not "
                         f"batch logits {tuple(logits.shape)}")
    g = gumbel(key, logits.shape[batch:])
    return torch.argmax(g + logits, dim=axis)
