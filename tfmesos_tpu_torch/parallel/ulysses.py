"""Ulysses sequence parallelism: all-to-all over the ``sp`` axis (port
of ``tfmesos_tpu/parallel/ulysses.py``: ``ulysses_attention_local``
``:40``, ``ulysses_attention`` ``:94``).

Activations arrive sequence-cut ``[B, T/sp, H, D]``; one all-to-all
(``parallel.collectives.all_to_all``) moves the cut from the sequence
to the heads, so each rank runs EXACT attention over the whole sequence
for its ``H/sp`` heads — one ``flash_attention`` call, the
``flash_fwd.cu`` kernel and its backward pair on the card — and a
second all-to-all moves the cut back.  Grouped-query K/V ride at their
own width when sp divides the kv heads (a hop for q, one for the
stacked K/V: local q head j of rank s maps to local kv head j // g, the
global grouping); otherwise K/V are broadcast up to the q heads and
q, k and v travel stacked in one hop.  Needs ``n_heads % sp == 0``
(the ring has no head constraint).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tfmesos_tpu_torch.ops.attention import flash_attention
from tfmesos_tpu_torch.parallel.collectives import all_to_all

__all__ = ["ulysses_attention_local", "ulysses_attention"]


def ulysses_attention_local(q, k, v, mesh, axis: str = "sp",
                            causal: bool = True,
                            scale: Optional[float] = None,
                            window: Optional[int] = None) -> torch.Tensor:
    """One rank's body: local ``[B, T/sp, H, D]`` in, the same out (K/V
    may carry fewer heads)."""
    sp = mesh.axis_size(axis)
    h, hk = q.shape[2], k.shape[2]
    if h % sp:
        raise ValueError(f"ulysses needs heads ({h}) divisible by the sp "
                         f"axis ({sp}); use ring attention instead")
    if hk != h and hk % sp == 0:
        qh = all_to_all(q, mesh, axis, 2, 1)
        kv = all_to_all(torch.stack((k, v)), mesh, axis, 3, 2)
        o = flash_attention(qh, kv[0], kv[1], causal=causal, scale=scale,
                            window=window)
        return all_to_all(o, mesh, axis, 1, 2)
    if hk != h:
        k = k.repeat_interleave(h // hk, dim=2)
        v = v.repeat_interleave(h // hk, dim=2)
    qkv = all_to_all(torch.stack((q, k, v)), mesh, axis, 3, 2)
    o = flash_attention(qkv[0], qkv[1], qkv[2], causal=causal, scale=scale,
                        window=window)
    return all_to_all(o, mesh, axis, 1, 2)


def ulysses_attention(q, k, v, mesh, axis: str = "sp", causal: bool = True,
                      scale: Optional[float] = None,
                      window: Optional[int] = None) -> torch.Tensor:
    """Sequence-parallel attention by all-to-all: q/k/v this rank's
    sequence shards; one ``flash_attention`` call without a
    (non-trivial) ``axis``."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               window=window)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return ulysses_attention_local(q, k, v, mesh, axis, causal, scale,
                                   window)
