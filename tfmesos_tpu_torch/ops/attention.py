"""Attention ops: plain PyTorch references and the wrappers of the
hand-written Hopper kernels on the serving and training paths (port of
``tfmesos_tpu/ops/attention.py``: prefill and its gradient
``:69-531``, decode ``:534-593, 831-1152``).

Every wrapper follows one rule: a CPU tensor runs the plain PyTorch
version of the kernel (same function, same signature); a CUDA tensor
launches the kernel or raises — there is no fallback from the card to
the plain version.  Layouts are the JAX package's: ``[batch, seq,
heads, head_dim]`` at the public functions, stacked paged pools
``[L, P, KV, page, D]``.

Kernels (``tfmesos_tpu_torch/csrc``):

* ``flash_fwd.cu`` replaces ``_flash_kernel`` (blocked online-softmax
  forward: causal/full, sliding window, q_offset, GQA, per-row lse);
* ``flash_bwd.cu`` replaces ``_flash_bwd_dq_kernel`` and
  ``_flash_bwd_dkv_kernel`` (the gradient from the stored lse; dk/dv
  summed over each GQA group), the backward of :func:`flash_attention`'s
  autograd Function;
* ``flash_decode_paged.cu`` replaces ``_flash_decode_paged_kernel``
  (decode through a per-row page table, ragged positions, t-row chunks,
  deferred ``self_kv`` with intra-chunk causality, int8 pools);
* ``flash_decode.cu`` replaces ``_flash_decode_kernel`` (decode over a
  linear stacked cache, ragged positions, chunks of any length, int8
  caches).

The two decode kernels split each row's live blocks over S CTAs whose
partials a second kernel merges (``flash_decode_merge``,
``flash_decode_paged_merge``), and share their consumer warps' math and
JAX's rounding rules (``csrc/decode_common.cuh``, ``decode_split.cuh``).

int8 caches are :class:`~tfmesos_tpu_torch.ops.quant.QTensor` s with
lane-major per-position scales; the kernels fold the scales into the
score and probability rows, the plain versions dequantize in q's dtype.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from tfmesos_tpu_torch.kernels import build
from tfmesos_tpu_torch.ops.quant import QTensor, int8_round_trip

NEG_INF = float("-inf")

#: Kernel launch counts: each wrapper adds one where it launches its
#: kernel and nowhere else (the plain CPU path never counts).  A run
#: that zeroes these before serving or training and reads them after
#: proves that the path went through the kernels.
LAUNCHES = {"flash_fwd": 0, "flash_decode_paged": 0,
            "flash_decode_paged_merge": 0, "flash_decode": 0,
            "flash_decode_merge": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
#: head_dim the flash_fwd kernel takes, per dtype (bf16 runs on the
#: tensor cores in 16-wide k-steps; float32 on the FMA units).
_FLASH_HEAD_DIMS = {torch.bfloat16: (16, 32, 64, 128),
                    torch.float32: (8, 16, 32, 64, 128)}
#: Shared memory one Hopper CTA may use (232,448 bytes).
_MAX_SMEM = 232448
#: The decode kernels (flash_decode, flash_decode_paged): keys per block
#: (a split's unit), query rows per CTA (the kernel's
#: tfm_flash_decode_row_tile), consumer warps per CTA (each owns a
#: contiguous slice of every block's keys), the most splits, and the
#: head_dims they take.
_DECODE_BLOCK = 64
_DECODE_ROW_TILE = 4
_DECODE_WARPS = 4
_DECODE_MAX_SPLITS = 64
_DECODE_HEAD_DIMS = (8, 16, 32, 64, 128)

_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_FLASH_FWD_ARGS = [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i,
                   _ll, _ll, _ll, _ll, _ll, _ll, _i, _i, _i, _f, _i, _i, _p]
# Decode entries: operand, output and partials pointers, then the int
# sizes, scale, is_bf16, kv_int8, stream.
_PAGED_ARGS = [_p] * 13 + [_i] * 11 + [_f, _i, _i, _p]
_DECODE_ARGS = [_p] * 10 + [_i] * 8 + [_f, _i, _i, _p]
# Backward entries: operand and output pointers, then B, Tq, Tk, H, KV,
# D, the strides of q, do and k/v (3 each), causal, window, q_offset,
# scale, is_bf16, out_f32, block_rows, stream.
_BWD_TAIL = [_i] * 6 + [_ll] * 9 + [_i] * 3 + [_f, _i, _i, _i, _p]
_BWD_DQ_ARGS = [_p] * 7 + _BWD_TAIL
_BWD_DKV_ARGS = [_p] * 8 + _BWD_TAIL


def _check_gqa_heads(q, k, v):
    """One clear failure for bad GQA shapes (q heads must be a multiple
    of the kv heads, which K and V must agree on)."""
    if q.shape[2] % k.shape[2] or k.shape[2] != v.shape[2]:
        raise ValueError(
            f"q heads ({q.shape[2]}) must be a multiple of kv heads "
            f"({k.shape[2]}/{v.shape[2]}, which must agree)")


def _check_window(causal: bool, window: Optional[int]) -> None:
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")


def _causal_mask(tq: int, tk: int, q_offset: int, window: Optional[int],
                 device) -> torch.Tensor:
    """[tq, tk] True where query i (global position i + q_offset) must
    NOT see key j."""
    qpos = torch.arange(tq, device=device)[:, None] + q_offset
    kpos = torch.arange(tk, device=device)[None, :]
    bad = kpos > qpos
    if window is not None:
        bad = bad | (kpos < qpos - (window - 1))
    return bad


def mha_reference(q, k, v, causal: bool = False,
                  scale: Optional[float] = None,
                  window: Optional[int] = None) -> torch.Tensor:
    """Plain scaled-dot-product attention (``mha_reference`` of the JAX
    package): scores in the input dtype cast to float32, softmax in
    float32, probabilities cast to ``v.dtype``.  GQA K/V are broadcast
    up to the q heads here; ``window`` (causal only) lets query i see
    keys [i - window + 1, i]."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _check_window(causal, window)
    _check_gqa_heads(q, k, v)
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        bad = _causal_mask(scores.shape[-2], scores.shape[-1], 0, window,
                           q.device)
        scores = scores.masked_fill(bad, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention_reference(q, k, v, causal: bool = False,
                              scale: Optional[float] = None,
                              window: Optional[int] = None,
                              q_offset: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``_flash_kernel``: ``(o, lse)`` with ``o``
    [B, Tq, H, D] in q's dtype and the per-row logsumexp of the scaled
    scores ``lse`` [B, H, Tq, 1] float32.  Scores, softmax and the
    probability-value product are float32 (the kernel's accumulation).
    Query i sits at global position i + ``q_offset``; a row that sees no
    key gives zeros and lse -inf, as the kernel does."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _check_window(causal, window)
    _check_gqa_heads(q, k, v)
    g = q.shape[2] // k.shape[2]
    qf = q.float().transpose(1, 2)                           # [B, H, Tq, D]
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    s = (qf @ kf.transpose(-1, -2)) * scale                  # [B, H, Tq, Tk]
    if causal:
        s = s.masked_fill(_causal_mask(s.shape[-2], s.shape[-1], q_offset,
                                       window, q.device), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)  # empty rows
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    lse = m + torch.log(l)                     # -inf where l == 0
    p = e / torch.where(l == 0, torch.ones_like(l), l)
    o = (p @ vf).transpose(1, 2).to(q.dtype)
    return o, lse


def _flash_forward_impl(q, k, v, causal: bool, scale: float,
                        window: Optional[int], q_offset: int):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         window=window, q_offset=q_offset)
    return _flash_forward_cuda(q, k, v, causal, scale, window, q_offset)


class _FlashAttention(torch.autograd.Function):
    """Differentiable blocked attention (counterpart of the JAX
    ``custom_vjp`` ``_flash``): the forward is the ``flash_fwd`` kernel
    (its plain version on CPU tensors) and saves (q, k, v, o, lse); the
    backward is :func:`flash_backward` — Δ in one PyTorch pass, then
    the two ``flash_bwd`` kernels (their plain versions on CPU tensors).
    ``lse`` is an output without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, q_offset):
        o, lse = _flash_forward_impl(q, k, v, causal, scale, window,
                                     q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (causal, scale, window, q_offset)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, window, q_offset = ctx.cfg
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, causal=causal,
                                    scale=scale, window=window,
                                    q_offset=q_offset)
        return dq, dk, dv, None, None, None, None


def flash_forward(q, k, v, causal: bool = False,
                  scale: Optional[float] = None,
                  window: Optional[int] = None, q_offset: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of blocked attention (counterpart of
    ``_flash_forward``): the ``flash_fwd.cu`` kernel on CUDA tensors,
    :func:`flash_attention_reference` on CPU tensors.  Any sequence
    length runs — the kernel masks the ragged edge itself.  When autograd
    records (grad enabled and q, k or v requires grad) the call goes
    through :class:`_FlashAttention`, so ``o`` carries the gradient of
    the backward kernels."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _check_window(causal, window)
    _check_gqa_heads(q, k, v)
    args = (q, k, v, bool(causal), float(scale), window, int(q_offset))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(*args)
    return _flash_forward_impl(*args)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Blocked attention output [B, Tq, H, D] (the model's entry point;
    see :func:`flash_forward` for the kernel-or-plain rule and the
    gradient).  GQA: ``k`` and ``v`` may carry H // g heads; q head h
    reads kv head h // g."""
    return flash_forward(q, k, v, causal=causal, scale=scale, window=window,
                         q_offset=q_offset)[0]


# -- backward ----------------------------------------------------------------


def _bwd_delta(o, do) -> torch.Tensor:
    """Δ = rowsum(do ⊙ o) in float32, [B, H, Tq, 1]: one elementwise and
    reduce pass, as the JAX package leaves it to XLA."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]


def _bwd_probs(q, k, v, do, lse, delta, causal: bool, scale: float,
               window: Optional[int], q_offset: int):
    """Shared body of the plain backward: ``(p, ds, qf, kf, dof)`` with
    p = exp(s·scale − lse) [B, H, Tq, Tk] float32 (masked by a select —
    a row that sees no key has lse −inf, where exp(s − lse) is +inf),
    ds = p ⊙ (do·vᵀ − Δ) rounded through the operand dtype, and the
    operands as float32 [B, H, T, D] with K/V broadcast to the q
    heads."""
    g = q.shape[2] // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    dof = do.float().transpose(1, 2)
    lse = lse.reshape(*lse.shape[:3], 1)
    delta = delta.reshape(*delta.shape[:3], 1)
    p = torch.exp((qf @ kf.transpose(-1, -2)) * scale - lse)
    if causal:
        p = p.masked_fill(_causal_mask(p.shape[-2], p.shape[-1], q_offset,
                                       window, q.device), 0.0)
    dp = dof @ vf.transpose(-1, -2)
    ds = (p * (dp - delta)).to(q.dtype).float()
    return p, ds, qf, kf, dof


def _flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool,
                            scale: float, window: Optional[int] = None,
                            q_offset: int = 0, out_dtype=None):
    """Plain version of ``_flash_bwd_dq_kernel``: dq = scale·ds·k
    [B, Tq, H, D] in ``out_dtype`` (default q's dtype)."""
    _, ds, _, kf, _ = _bwd_probs(q, k, v, do, lse, delta, causal, scale,
                                 window, q_offset)
    return (scale * (ds @ kf)).transpose(1, 2).to(out_dtype or q.dtype)


def _flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool,
                             scale: float, window: Optional[int] = None,
                             q_offset: int = 0, out_dtype=None):
    """Plain version of ``_flash_bwd_dkv_kernel``: (dk, dv)
    [B, Tk, KV, D] in ``out_dtype`` (default k's dtype), dk = scale·dsᵀ·q
    and dv = pᵀ·do with p rounded to do's dtype, each summed over the q
    heads of its GQA group."""
    p, ds, qf, _, dof = _bwd_probs(q, k, v, do, lse, delta, causal, scale,
                                   window, q_offset)
    b, tk, kvh, d = k.shape
    g = q.shape[2] // kvh
    dk = scale * (ds.transpose(-1, -2) @ qf)                 # [B, H, Tk, D]
    dv = p.to(do.dtype).float().transpose(-1, -2) @ dof

    def group(x):
        return x.reshape(b, kvh, g, tk, d).sum(2).transpose(1, 2).to(
            out_dtype or k.dtype)

    return group(dk), group(dv)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool = False,
                                  scale: Optional[float] = None,
                                  window: Optional[int] = None,
                                  q_offset: int = 0, out_dtype=None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain version of ``_mha_bwd_pallas``: ``(dq, dk, dv)`` of
    blocked attention from the forward's ``o`` and ``lse`` and the
    output gradient ``do``, written with the explicit formulas (Δ =
    rowsum(do⊙o), p from the stored lse, dp = do·vᵀ, ds = p⊙(dp − Δ)
    cast to the operand dtype, dq = scale·ds·k, dk = scale·dsᵀ·q,
    dv = pᵀ·do with p cast to do's dtype; dk/dv summed over the GQA
    group) — not through autograd.  Products are float32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _check_window(causal, window)
    _check_gqa_heads(q, k, v)
    delta = _bwd_delta(o, do)
    args = (q, k, v, do, lse, delta, bool(causal), float(scale), window,
            int(q_offset), out_dtype)
    return (_flash_bwd_dq_reference(*args),) + _flash_bwd_dkv_reference(
        *args)


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float,
                 window: Optional[int] = None, q_offset: int = 0,
                 out_dtype=None) -> torch.Tensor:
    """dq from the stored ``lse`` and Δ (``delta``, [B, H, Tq(, 1)]
    float32): the ``flash_bwd.cu`` dq kernel on CUDA tensors,
    :func:`_flash_bwd_dq_reference` on CPU tensors."""
    if q.device.type == "cpu":
        return _flash_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                       scale, window, q_offset, out_dtype)
    return _flash_bwd_cuda("flash_bwd_dq", q, k, v, do, lse, delta, causal,
                           scale, window, q_offset, out_dtype)[0]


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float,
                  window: Optional[int] = None, q_offset: int = 0,
                  out_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each summed over its GQA group: the ``flash_bwd.cu``
    dk/dv kernel on CUDA tensors, :func:`_flash_bwd_dkv_reference` on
    CPU tensors."""
    if q.device.type == "cpu":
        return _flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                        scale, window, q_offset, out_dtype)
    return _flash_bwd_cuda("flash_bwd_dkv", q, k, v, do, lse, delta, causal,
                           scale, window, q_offset, out_dtype)


def flash_backward(q, k, v, o, lse, do, causal: bool = False,
                   scale: Optional[float] = None,
                   window: Optional[int] = None, q_offset: int = 0,
                   out_dtype=None) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """``(dq, dk, dv)`` of blocked attention (counterpart of
    ``_mha_bwd_pallas``): Δ = rowsum(do⊙o) in one PyTorch pass, then
    :func:`flash_bwd_dq` and :func:`flash_bwd_dkv` — the two kernels on
    CUDA tensors (validated and mapped once for both launches), their
    plain versions on CPU tensors.  ``out_dtype``
    (default: the operands' dtype; float32 is the other choice on the
    card) sets the gradients' dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _check_window(causal, window)
    _check_gqa_heads(q, k, v)
    delta = _bwd_delta(o, do)
    args = (q, k, v, do, lse, delta, bool(causal), float(scale), window,
            int(q_offset), out_dtype)
    if q.device.type == "cpu":
        return (flash_bwd_dq(*args),) + flash_bwd_dkv(*args)
    return _flash_bwd_cuda("flash_backward", *args)


def _check_cuda_operands(what: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: operands on {t.device} and {dev}")
    dt = tensors[0].dtype
    if dt not in _KERNEL_DTYPES:
        raise TypeError(f"{what}: the CUDA kernel takes bfloat16 or float32 "
                        f"operands, got {dt}")
    for t in tensors:
        if t.dtype != dt:
            raise TypeError(f"{what}: mixed operand dtypes {t.dtype} and "
                            f"{dt}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_SMS = {}


def _sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (memoized)."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _flash_fwd_block_rows(b: int, tq: int, h: int, sms: int) -> int:
    """Query rows per CTA of the wgmma forward kernel: 128 (two consumer
    warpgroups) when ceil(tq / 128) x h x b CTAs fill the ``sms``
    streaming multiprocessors, else 64 (one warpgroup: twice the CTAs,
    for the short serving prefills)."""
    return 128 if -(-tq // 128) * h * b >= sms else 64


def _flash_fwd_route(dtype, d: int, b: int, tq: int, h: int,
                     sms: int) -> Tuple[str, int]:
    """``(route, query rows per CTA)`` that ``flash_fwd.cu`` takes for
    these shapes: bf16 at head_dim 64 or 128 on wgmma, other bf16 head
    dims on mma.sync, float32 on the FMA units."""
    if dtype == torch.bfloat16 and d in (64, 128):
        return "wgmma", _flash_fwd_block_rows(b, tq, h, sms)
    return ("mma.sync" if dtype == torch.bfloat16 else "fma"), 64


def _flash_bwd_route(dtype, d: int, b: int, t: int, h: int,
                     sms: int) -> Tuple[str, int]:
    """``(route, rows per CTA)`` of a ``flash_bwd.cu`` kernel: the
    forward's rule on the kernel's own grid — for dq ``t`` = Tq and ``h``
    the q heads (q rows a CTA), for dk/dv ``t`` = Tk and ``h`` the kv
    heads (keys a CTA).  bf16 at head_dim 64 or 128 on wgmma (128 rows
    where ceil(t / 128) x h x b CTAs fill the ``sms``, else 64), other
    bf16 head dims on mma.sync, float32 on the FMA units (64 each)."""
    return _flash_fwd_route(dtype, d, b, t, h, sms)


def _tensor_map_strides(t: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """Element strides of dims 0-2 of a [B, T, heads, D] operand when a
    tensor map can read it in place, else None.  In place means: unit
    stride on head_dim, a 16-byte aligned base, and strides that are
    multiples of 16 bytes and nest without overlap (each at least the
    extent of the dims inside it).  A dim of size 1 takes the dense
    stride, whatever PyTorch recorded for it.  The flash_fwd wrapper
    copies an operand that fails."""
    shape, size = t.shape, t.element_size()
    if t.data_ptr() % 16:
        return None
    if t.is_contiguous():          # the usual case, without the walk below
        if (shape[3] * size) % 16:
            return None
        return (shape[1] * shape[2] * shape[3], shape[2] * shape[3],
                shape[3])
    stride = t.stride()
    if stride[3] != 1 and shape[3] > 1:
        return None
    out = [0, 0, 0]
    span = shape[3]
    for dim in (2, 1, 0):
        s = span if shape[dim] == 1 else stride[dim]
        if (s * size) % 16 or s < span:
            return None
        out[dim] = s
        span = s * shape[dim]
    return tuple(out)


def _dense(t: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous copy (a new allocation, so 16-byte aligned)."""
    return t.clone(memory_format=torch.contiguous_format)


def _mapped(t: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """``(t, strides)`` for a tensor map: ``t`` itself where
    :func:`_tensor_map_strides` takes it in place, else a dense copy."""
    s = _tensor_map_strides(t)
    if s is None:
        t = _dense(t)
        s = _tensor_map_strides(t)
    return t, s


def _mapped_kv(k: torch.Tensor, v: torch.Tensor):
    """``(k, v, strides)``: K and V share one set of tensor-map strides,
    so both are copied dense unless both take the rule in place with the
    same strides."""
    sk = _tensor_map_strides(k)
    if sk is None or _tensor_map_strides(v) != sk:
        k, v = _dense(k), _dense(v)
        sk = _tensor_map_strides(k)
    return k, v, sk


def _flash_forward_cuda(q, k, v, causal: bool, scale: float,
                        window: Optional[int], q_offset: int):
    _check_cuda_operands("flash_forward", q, k, v)
    b, tq, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    if d not in _FLASH_HEAD_DIMS[q.dtype]:
        raise ValueError(f"flash_forward: the CUDA kernel takes {q.dtype} "
                         f"head_dim in {_FLASH_HEAD_DIMS[q.dtype]}, got {d}")
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_forward: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if not scale > 0:
        raise ValueError(f"flash_forward: the CUDA kernel takes a positive "
                         f"scale, got {scale}")
    # One stride rule for every route, a tensor map's: operands that
    # fail it (or K and V with different strides) are copied dense.
    q, sq = _mapped(q)
    k, v, sk = _mapped_kv(k, v)
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    rows = _flash_fwd_route(q.dtype, d, b, tq, h, _sm_count(q.device))[1]
    fn = build.kernel("flash_fwd", "tfm_flash_fwd", _FLASH_FWD_ARGS)
    with torch.cuda.device(q.device):
        LAUNCHES["flash_fwd"] += 1
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, tq, tk, h, kvh, d, *sq, *sk, int(causal),
                 0 if window is None else int(window), q_offset, scale,
                 int(q.dtype == torch.bfloat16), rows, _stream(q.device))
    build.check("flash_fwd", err, "flash_forward")
    return o, lse[..., None]


def _flash_bwd_cuda(which: str, q, k, v, do, lse, delta, causal: bool,
                    scale: float, window: Optional[int], q_offset: int,
                    out_dtype) -> Tuple[torch.Tensor, ...]:
    """Launch one of the two ``flash_bwd.cu`` kernels (``which`` is its
    LAUNCHES key): ``(dq,)`` or ``(dk, dv)``; or, for ``which`` =
    "flash_backward", both on the same checked and mapped operands:
    ``(dq, dk, dv)``."""
    _check_cuda_operands(which, q, k, v, do)
    b, tq, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    if d not in _FLASH_HEAD_DIMS[q.dtype]:
        raise ValueError(f"{which}: the CUDA kernel takes {q.dtype} "
                         f"head_dim in {_FLASH_HEAD_DIMS[q.dtype]}, got {d}")
    if (do.shape != q.shape or v.shape != k.shape or k.shape[0] != b
            or k.shape[3] != d or tq == 0 or tk == 0):
        raise ValueError(f"{which}: q {tuple(q.shape)}, do "
                         f"{tuple(do.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not fit together")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.device != q.device:
            raise TypeError(f"{which}: {name} must be float32 on "
                            f"{q.device}, got {t.dtype} on {t.device}")
        if t.numel() != b * h * tq or tuple(t.shape[:3]) != (b, h, tq):
            raise ValueError(f"{which}: {name} {tuple(t.shape)}, want "
                             f"{(b, h, tq, 1)}")
    out = q.dtype if out_dtype is None else out_dtype
    if out not in (q.dtype, torch.float32):
        raise TypeError(f"{which}: gradients in {q.dtype} or float32, "
                        f"got {out}")
    names = (("flash_bwd_dq", "flash_bwd_dkv") if which == "flash_backward"
             else (which,))
    # Each kernel's rows a CTA, by the rule on its own grid (the route is
    # the same for both: it follows dtype and head_dim).
    grid = {"flash_bwd_dq": (tq, h), "flash_bwd_dkv": (tk, kvh)}
    sms = _sm_count(q.device)
    plans = {n: _flash_bwd_route(q.dtype, d, b, *grid[n], sms)
             for n in names}
    if plans[names[0]][0] == "wgmma":
        # A tensor map's stride rule: operands that fail it (autograd's
        # do may be strided), or K and V with different strides, are
        # copied dense.
        q, sq = _mapped(q)
        do, so = _mapped(do)
        k, v, sk = _mapped_kv(k, v)
    else:
        # The mma.sync and FMA kernels index contiguous operands.
        q, k, v, do = (t.contiguous() for t in (q, k, v, do))
        sq = so = (tq * h * d, h * d, d)
        sk = (tk * kvh * d, kvh * d, d)
    lse, delta = (t.reshape(b, h, tq).contiguous() for t in (lse, delta))
    common = (b, tq, tk, h, kvh, d, *sq, *so, *sk, int(causal),
              0 if window is None else int(window), q_offset, scale,
              int(q.dtype == torch.bfloat16), int(out == torch.float32))
    stream = _stream(q.device)
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    outs = []
    with torch.cuda.device(q.device):
        for name in names:
            if name == "flash_bwd_dq":
                grads = (torch.empty((b, tq, h, d), dtype=out,
                                     device=q.device),)
                fn = build.kernel("flash_bwd", "tfm_flash_bwd_dq",
                                  _BWD_DQ_ARGS)
            else:
                grads = tuple(torch.empty((b, tk, kvh, d), dtype=out,
                                          device=q.device)
                              for _ in range(2))
                fn = build.kernel("flash_bwd", "tfm_flash_bwd_dkv",
                                  _BWD_DKV_ARGS)
            LAUNCHES[name] += 1
            err = fn(*ptrs, *(t.data_ptr() for t in grads), *common,
                     plans[name][1], stream)
            build.check("flash_bwd", err, name)
            outs.extend(grads)
    return tuple(outs)


# -- decode ----------------------------------------------------------------


def _decode_reference(q, k_cache, v_cache, pos, scale: float):
    """Dense masked attention of a query chunk over a KV cache (the
    JAX ``_decode_reference``): a grouped einsum with the cache at kv
    width, q heads grouped kv-major as [kv, g].  ``q`` is [B, H, D] or
    [B, t, H, D] (token tt sees positions <= pos + tt); the cache is
    [B, KV, M, D]."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, t, h, d = q.shape
    kv, m = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    q5 = q.reshape(b, t, kv, g, d)
    s = torch.einsum("btkgd,bkmd->bkgtm", q5, k_cache).float() * scale
    posv = torch.as_tensor(pos, device=q.device).reshape(-1).expand(b)
    kpos = torch.arange(m, device=q.device)
    tt = torch.arange(t, device=q.device)
    bad = kpos[None, None, :] > posv[:, None, None] + tt[None, :, None]
    s = s.masked_fill(bad[:, None, None], NEG_INF)          # [b,kv,g,t,m]
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bkgtm,bkmd->btkgd", p, v_cache).reshape(b, t, h, d)
    return o[:, 0] if squeeze else o


def _dequant_lane_major(qt: QTensor, dtype: torch.dtype) -> torch.Tensor:
    """Dequantize a lane-major QTensor cache ([..., M, D] values, scales
    [..., 1, M]) in ``dtype``: the per-position scales move back over the
    position dim and multiply (the plain path; the kernels fold them)."""
    return qt.values.to(dtype) * qt.scales.transpose(-1, -2).to(dtype)


def _stacked_cache(k_cache, v_cache, layer):
    """Normalize a decode cache or pool to its stacked form: ``(kc, vc,
    k_scales, v_scales, layer index)`` with kc/vc
    [L, ..., M|page, D] and lane-major scales [L, ..., 1, M|page] (None
    unless the cache is an int8 :class:`QTensor`).  A 4-D cache lifts to
    L = 1 (``layer`` must then be None or 0)."""
    quantized = isinstance(k_cache, QTensor)
    if quantized != isinstance(v_cache, QTensor):
        raise TypeError("K and V caches must both be int8 QTensors or both "
                        "plain tensors")
    kc = k_cache.values if quantized else k_cache
    vc = v_cache.values if quantized else v_cache
    ks = k_cache.scales if quantized else None
    vs = v_cache.scales if quantized else None
    if kc.dim() == 4:
        if layer not in (None, 0):
            raise ValueError("layer index needs a stacked 5-D cache")
        kc, vc = kc[None], vc[None]
        if quantized:
            ks, vs = ks[None], vs[None]
        layer = 0
    return kc, vc, ks, vs, 0 if layer is None else int(layer)


def _layer_view(kc, vc, ks, vs, li: int, dtype: torch.dtype):
    """Layer ``li`` of a stacked cache as plain [..., M, D] K and V,
    int8 caches dequantized in ``dtype``."""
    if ks is None:
        return kc[li], vc[li]
    return (_dequant_lane_major(QTensor(kc[li], ks[li]), dtype),
            _dequant_lane_major(QTensor(vc[li], vs[li]), dtype))


def flash_decode_reference(q, k_cache, v_cache,
                           pos: Union[int, torch.Tensor],
                           scale: Optional[float] = None,
                           layer=None) -> torch.Tensor:
    """Plain version of ``flash_decode.cu`` (the JAX ``flash_decode``
    off the kernel): :func:`_decode_reference` over layer ``layer`` of
    the cache, an int8 cache dequantized in q's dtype first."""
    kc, vc, ks, vs, li = _stacked_cache(k_cache, v_cache, layer)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k_l, v_l = _layer_view(kc, vc, ks, vs, li, q.dtype)
    return _decode_reference(q, k_l, v_l, pos, scale)


def _decode_splits(b: int, kv: int, row_tiles: int, m: int,
                   sms: int) -> int:
    """Split count S of the ``flash_decode`` kernel: enough CTAs for
    about two waves over ``sms`` streaming multiprocessors
    (b x kv x row_tiles x S >= 2 x sms), never more splits than the
    cache's ``m`` slots hold 64-key blocks, and at most 64.  Static
    shapes only — never pos — so no step reads the positions back from
    the card."""
    want = -(-2 * sms // (b * kv * row_tiles))
    blocks = -(-m // _DECODE_BLOCK)
    return max(1, min(want, blocks, _DECODE_MAX_SPLITS))


def _split_share(nb: torch.Tensor, splits: int,
                 s) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocks ``[j0, j1)`` of a row's ``nb`` live ones (an integer
    tensor, elementwise) that split ``s`` of ``splits`` owns
    (``decode_split.cuh``'s split_share): shares of ceil(nb / splits), the
    last ones short or empty."""
    per = -(-nb // splits)
    j0 = torch.minimum(nb, s * per)
    return j0, torch.minimum(nb, j0 + per)


def _merge_partials(pm, pl, po, dim: int):
    """Merge softmax partials along ``dim`` as ``decode_split.cuh`` does:
    m* = max m_s, weights e^(m_s - m*) (0 for an empty, -inf partial),
    l = sum l_s w_s and o = sum o_s w_s; returns (m*, l, o) with ``dim``
    gone (pm, pl [..., S, ...], po with a trailing head_dim)."""
    mx = pm.amax(dim)
    w = torch.where(pm == NEG_INF, 0.0, torch.exp(pm - mx.unsqueeze(dim)))
    return mx, (pl * w).sum(dim), (po * w.unsqueeze(-1)).sum(dim)


def _softmax_step(mw, lw, ow, s, vb, vscale=None):
    """One online-softmax step of each warp's running (m, l, o) (the
    consumer warps of ``csrc/decode_common.cuh``): masked scores ``s``
    [..., RT, keys] against the V slice ``vb`` [..., keys, D] (l from the
    unscaled, unrounded p; p rounded to bf16 before a bf16 V, multiplied
    by the per-position ``vscale`` [..., keys] and unrounded before an
    int8 one)."""
    m_new = torch.maximum(mw, s.amax(-1))
    corr = torch.where(mw == NEG_INF, 0.0, torch.exp(mw - m_new))
    p = torch.where(s == NEG_INF, 0.0, torch.exp(s - m_new[..., None]))
    lw = lw * corr + p.sum(-1)
    if vscale is not None:
        p = p * vscale[..., None, :]
    elif vb.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
    return m_new, lw, ow * corr[..., None] + p @ vb.float()


def _split_core(q, kview, vview, kscale, vscale, pos, scale: float,
                splits: int, self_kv=None) -> torch.Tensor:
    """The decode kernels' partition, in float32 with JAX's rounding rules
    (the plain version behind :func:`_decode_split_reference` and
    :func:`_paged_split_reference`).  ``q`` [B, t, H, D]; each row's
    logical cache ``kview``/``vview`` [B, KV, M, D] (int8 with per-position
    ``kscale``/``vscale`` [B, KV, M], else None).

    As in the kernels, each (row, kv head, tile of ``_DECODE_ROW_TILE``
    query rows) computes its live 64-key blocks from its last visible
    position and splits them into ``splits`` contiguous shares; within a
    share each of ``_DECODE_WARPS`` warps owns a 16-key slice of every
    block and keeps its own running (m, l, o) (:func:`_softmax_step`;
    score ``dot * scale`` then ``* kscale``).  Without ``self_kv`` token
    tt sees positions <= pos + tt.  With ``self_kv`` ([B, t, KV, D] each,
    in q's dtype) every token sees positions <= pos - 1 and the last split
    also takes the chunk, 64 slots a block (each warp its 16-slot slice),
    token tt seeing slots <= tt.  The warps merge into the split's partial
    and the partials into the output (:func:`_merge_partials`)."""
    b, t, h, d = q.shape
    kvh, m = kview.shape[1], kview.shape[2]
    g = h // kvh
    dev, rt, blk = q.device, _DECODE_ROW_TILE, _DECODE_BLOCK
    rows = t * g
    tiles = -(-rows // rt)
    # Query rows t-major per kv head, padded to whole tiles:
    # [B, KV, tiles, RT, D]; a padding row sees nothing (limit -1).
    qr = q.float().reshape(b, t, kvh, g, d).permute(0, 2, 1, 3, 4)
    qr = torch.nn.functional.pad(qr.reshape(b, kvh, rows, d),
                                 (0, 0, 0, tiles * rt - rows))
    qr = qr.reshape(b, kvh, tiles, rt, d)
    posv = _row_positions(pos, b, dev).long()
    r = torch.arange(tiles * rt, device=dev)
    tok = (r // g).reshape(tiles, rt)              # each row's chunk token
    real = (r < rows).reshape(tiles, rt)
    tt_last = (torch.clamp((torch.arange(tiles, device=dev) + 1) * rt,
                           max=rows) - 1) // g     # each tile's last token
    if self_kv is None:
        lim = posv[:, None, None] + tok
        last = posv[:, None] + tt_last
    else:
        lim = (posv - 1)[:, None, None].expand(b, tiles, rt)
        last = (posv - 1)[:, None].expand(b, tiles)
    lim = torch.where(real, lim, -1)                       # [B, tiles, RT]
    nb = torch.where(last < 0, 0, torch.clamp(last // blk + 1,
                                              max=-(-m // blk)))
    j0, j1 = _split_share(nb[..., None], splits,
                          torch.arange(splits, device=dev))  # [B, tiles, S]
    # Key offsets of each warp's slice of a block: [W, 16].
    kw = blk // _DECODE_WARPS
    offs = (torch.arange(_DECODE_WARPS, device=dev)[:, None] * kw
            + torch.arange(kw, device=dev))
    bi = torch.arange(b, device=dev).reshape(b, 1, 1, 1, 1, 1)
    hi = torch.arange(kvh, device=dev).reshape(1, kvh, 1, 1, 1, 1)
    state = (b, kvh, tiles, splits, _DECODE_WARPS, rt)
    mw = torch.full(state, NEG_INF, device=dev)
    lw = torch.zeros(state, device=dev)
    ow = torch.zeros(state + (d,), device=dev)
    for step in range(int((j1 - j0).max())):
        j = j0 + step
        kpos = (j * blk)[..., None, None] + offs        # [B, tiles, S, W, 16]
        live = (j < j1)[..., None, None] & (kpos < m)
        idx = torch.where(live, kpos, 0)[:, None]        # [B, 1, ..., 16]
        kb = kview[bi, hi, idx].float()                  # [..., W, 16, D]
        s = torch.einsum("bkprd,bkpswnd->bkpswrn", qr, kb) * scale
        if kscale is not None:
            s = s * kscale[bi, hi, idx][..., None, :]
        seen = live[:, None, :, :, :, None, :] & (
            kpos[:, None, :, :, :, None, :]
            <= lim[:, None, :, None, None, :, None])
        s = s.masked_fill(~seen, NEG_INF)                # [..., W, RT, 16]
        mw, lw, ow = _softmax_step(
            mw, lw, ow, s, vview[bi, hi, idx],
            None if vscale is None else vscale[bi, hi, idx])
    if self_kv is not None:
        ksf, vsf = (c.permute(0, 2, 1, 3) for c in self_kv)  # [B, KV, t, D]
        self_lim = torch.where(real, tok, -1)                 # [tiles, RT]
        for s0 in range(0, int(tt_last.max()) + 1, blk):
            slot = s0 + offs                                  # [W, 16]
            idx = slot.clamp(max=t - 1)
            s = torch.einsum("bkprd,bkwnd->bkpwrn", qr,
                             ksf[:, :, idx].float()) * scale
            seen = (slot < t)[None, :, None, :] & (
                slot[None, :, None, :] <= self_lim[:, None, :, None])
            s = s.masked_fill(~seen, NEG_INF)    # [B, KV, tiles, W, RT, 16]
            last_split = _softmax_step(mw[:, :, :, -1], lw[:, :, :, -1],
                                       ow[:, :, :, -1], s,
                                       vsf[:, :, idx][:, :, None])
            for acc, new in zip((mw, lw, ow), last_split):
                acc[:, :, :, -1] = new
    # Warps into each split's partial, then the splits into the output.
    _, lsum, osum = _merge_partials(*_merge_partials(mw, lw, ow, 4), dim=3)
    o = torch.where(lsum[..., None] > 0, osum / torch.where(
        lsum > 0, lsum, 1.0)[..., None], 0.0)           # [B, KV, tiles, RT, D]
    o = o.reshape(b, kvh, tiles * rt, d)[:, :, :rows]
    return o.reshape(b, kvh, t, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, t, h, d).to(q.dtype)


def _decode_split_reference(q, k_cache, v_cache,
                            pos: Union[int, torch.Tensor],
                            scale: Optional[float], splits: int,
                            layer=None) -> torch.Tensor:
    """Plain version of ``flash_decode.cu``'s partition (:func:`_split_core`
    over layer ``layer`` of the linear cache).  Same arguments as
    :func:`flash_decode` plus ``splits``."""
    kc, vc, ks, vs, li = _stacked_cache(k_cache, v_cache, layer)
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    out = _split_core(q, kc[li], vc[li],
                      None if ks is None else ks[li, :, :, 0],
                      None if vs is None else vs[li, :, :, 0],
                      pos, scale, splits)
    return out[:, 0] if squeeze else out


def flash_decode(q, k_cache, v_cache, pos: Union[int, torch.Tensor],
                 scale: Optional[float] = None, layer=None) -> torch.Tensor:
    """Decode attention over a linear KV cache bounded at ``pos``
    (counterpart of the JAX ``flash_decode``): the ``flash_decode.cu``
    kernel on CUDA tensors, :func:`flash_decode_reference` on CPU
    tensors.

    ``q``: [B, H, D] or [B, t, H, D] (token tt sees positions <=
    pos + tt; the cache already holds the chunk); caches [B, KV, M, D] or
    the stacked [L, B, KV, M, D] with ``layer`` (read in place — no
    per-layer slice), plain tensors or int8 :class:`QTensor` s with
    lane-major scales [(L,) B, KV, 1, M]; ``pos``: int or [B] (ragged
    rows).  Returns q's shape."""
    kc, vc, ks, vs, li = _stacked_cache(k_cache, v_cache, layer)
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    if q.shape[2] % kc.shape[2] or kc.shape[2] != vc.shape[2]:
        raise ValueError(f"q heads ({q.shape[2]}) must be a multiple of "
                         f"cache kv heads ({kc.shape[2]}/{vc.shape[2]})")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        out = flash_decode_reference(q, k_cache, v_cache, pos, scale, layer)
    else:
        out = _flash_decode_cuda(q, kc, vc, ks, vs, pos, float(scale), li)
    return out[:, 0] if squeeze else out


def _check_kv(what: str, q, kc, vc, ks, vs) -> bool:
    """Validate a stacked cache or pool for a decode kernel against q;
    True when it is int8 (with float32 lane-major scales)."""
    _check_cuda_operands(what, q)
    if kc.shape != vc.shape or kc.shape[-1] != q.shape[-1]:
        raise ValueError(f"{what}: caches {tuple(kc.shape)} / "
                         f"{tuple(vc.shape)} do not match q "
                         f"{tuple(q.shape)}")
    tensors = (kc, vc) if ks is None else (kc, vc, ks, vs)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{what}: cache on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: caches must be contiguous (the "
                             f"kernel reads them in place)")
    if ks is None:
        if kc.dtype != q.dtype or vc.dtype != q.dtype:
            raise TypeError(f"{what}: cache dtype {kc.dtype} must be q's "
                            f"({q.dtype}) or an int8 QTensor")
        return False
    want = kc.shape[:-2] + (1, kc.shape[-2])
    if (kc.dtype != torch.int8 or vc.dtype != torch.int8
            or ks.dtype != torch.float32 or vs.dtype != torch.float32
            or ks.shape != want or vs.shape != want):
        raise TypeError(f"{what}: an int8 cache needs int8 values and "
                        f"float32 lane-major scales {tuple(want)}, got "
                        f"{kc.dtype}/{ks.dtype} {tuple(ks.shape)}")
    return True


def _row_positions(pos, b: int, device) -> torch.Tensor:
    return torch.as_tensor(pos, device=device).to(torch.int32).reshape(
        -1).expand(b).contiguous()


_PLANS = {}


def _decode_plan(q, kv: int, slots: int) -> int:
    """Split count of a decode kernel's launch for q [B, t, H, D] over
    ``kv`` kv heads and ``slots`` cache positions a row can hold (a linear
    cache's M; a paged table's NP x page) on q's device, by
    :func:`_decode_splits` (memoized by shapes: every layer of every step
    asks again)."""
    b, t, h, _ = q.shape
    key = (b, t, h, kv, slots, q.device)
    if key not in _PLANS:
        tiles = -(-t * (h // kv) // _DECODE_ROW_TILE)
        _PLANS[key] = _decode_splits(b, kv, tiles, slots,
                                     _sm_count(q.device))
    return _PLANS[key]


def _split_scratch(splits: int, rows: int, d: int, device):
    """Pointers to the partials of a split decode launch (m, l and the
    unnormalized o: float32 [S, rows], [S, rows], [S, rows, D] back to back
    in one allocation) and the allocation, which the caller keeps alive
    until the launch is enqueued; none when one CTA covers a row."""
    if splits == 1:
        return (None, None, None), None
    n = splits * rows
    scratch = torch.empty(n * (d + 2), dtype=torch.float32, device=device)
    base = scratch.data_ptr()
    return (base, base + 4 * n, base + 8 * n), scratch


def _flash_decode_cuda(q, kc, vc, ks, vs, pos, scale: float, layer: int):
    kv_int8 = _check_kv("flash_decode", q, kc, vc, ks, vs)
    b, t, h, d = q.shape
    n_layers, cb, kvh, m, _ = kc.shape
    if cb != b:
        raise ValueError(f"flash_decode: cache batch {cb} for {b} rows")
    if not 0 <= layer < n_layers:
        raise ValueError(f"flash_decode: layer {layer} out of range for "
                         f"{n_layers} layers")
    if d not in _DECODE_HEAD_DIMS:
        raise ValueError(f"flash_decode: the CUDA kernel takes head_dim in "
                         f"{_DECODE_HEAD_DIMS}, got {d}")
    splits = _decode_plan(q, kvh, m)
    posv = _row_positions(pos, b, q.device)
    q = q.contiguous()
    out = torch.empty_like(q)
    parts, _scratch = _split_scratch(splits, b * t * h, d, q.device)
    fn = build.kernel("flash_decode", "tfm_flash_decode", _DECODE_ARGS)
    with torch.cuda.device(q.device):
        LAUNCHES["flash_decode"] += 1
        if splits > 1:
            LAUNCHES["flash_decode_merge"] += 1
        err = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                 ks.data_ptr() if kv_int8 else None,
                 vs.data_ptr() if kv_int8 else None, posv.data_ptr(),
                 out.data_ptr(), *parts,
                 b, t, h, kvh, m, d, layer, splits, scale,
                 int(q.dtype == torch.bfloat16), int(kv_int8),
                 _stream(q.device))
    build.check("flash_decode", err, "flash_decode")
    return out


def _paged_decode_reference(q, k_pool, v_pool, page_table, pos,
                            scale: float, layer=None, self_kv=None):
    """Gather-the-pages ground truth (the JAX
    ``_paged_decode_reference``): materialize each row's logical cache
    from the pool ([P, KV, page, D], or the stacked [L, P, KV, page, D]
    with ``layer``; int8 QTensor pools dequantize in q's dtype) and run
    :func:`_decode_reference`.  ``self_kv`` (deferred-write decode): the
    uncommitted chunk's [B, t, KV, D] K/V is written into each row's
    view at positions [pos, pos + t - 1] (start clamped into the view,
    as a dynamic slice update clamps), where the pool slots are
    stale."""
    kc, vc, ks, vs, li = _stacked_cache(k_pool, v_pool, layer)
    kp, vp = _layer_view(kc, vc, ks, vs, li, q.dtype)        # [P,KV,ps,D]
    b = q.shape[0]
    kv, ps, d = kp.shape[1], kp.shape[2], kp.shape[3]
    table = torch.as_tensor(page_table, device=q.device).long()
    np_ = table.shape[1]

    def gather(pool):        # [B, NP, KV, ps, D] -> [B, KV, NP*ps, D]
        return pool[table].transpose(1, 2).reshape(b, kv, np_ * ps, d)

    k_view, v_view = gather(kp), gather(vp)
    if self_kv is not None:
        t = self_kv[0].shape[1]
        posv = torch.as_tensor(pos, device=q.device).reshape(-1).expand(b)
        start = posv.clamp(0, np_ * ps - t)
        rows = torch.arange(b, device=q.device)[:, None]
        cols = start[:, None] + torch.arange(t, device=q.device)[None]
        # Advanced indices around the head slice front the [b, t] dims:
        # the update is [b, t, KV, D], the chunk's own layout.
        k_view[rows, :, cols] = self_kv[0].to(k_view.dtype)
        v_view[rows, :, cols] = self_kv[1].to(v_view.dtype)
    return _decode_reference(q, k_view, v_view, pos, scale)


def _paged_split_reference(q, k_pool, v_pool, page_table,
                           pos: Union[int, torch.Tensor],
                           scale: Optional[float], splits: int, layer=None,
                           self_kv=None, round_self: bool = False
                           ) -> torch.Tensor:
    """Plain version of ``flash_decode_paged.cu``'s partition
    (:func:`_split_core` over each row's pages, gathered through the
    table with page ids clamped into the pool as the kernel clamps them).
    Same arguments as :func:`flash_decode_paged` plus ``splits``."""
    kc, vc, ks, vs, li = _stacked_cache(k_pool, v_pool, layer)
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b = q.shape[0]
    n_pages, kvh, ps = kc.shape[1], kc.shape[2], kc.shape[3]
    table = torch.as_tensor(page_table, device=q.device).long().clamp(
        0, n_pages - 1)
    np_ = table.shape[1]

    def view(pool):   # [P, KV, ps, ...] -> [B, KV, NP * ps, ...]
        x = pool[table].transpose(1, 2)
        return x.reshape(b, kvh, np_ * ps, *x.shape[4:])

    out = _split_core(
        q, view(kc[li]), view(vc[li]),
        None if ks is None else view(ks[li, :, :, 0]),
        None if vs is None else view(vs[li, :, :, 0]), pos, scale, splits,
        _self_operands(q, self_kv, round_self))
    return out[:, 0] if squeeze else out


def _self_operands(q, self_kv, round_self: bool):
    """The deferred chunk in q's dtype, rounded as an int8 slot holds it
    when ``round_self`` (the plain versions' part of what the kernel
    does in its consumer warps)."""
    if self_kv is None:
        if round_self:
            raise ValueError("round_self needs a self_kv chunk")
        return None
    chunk = tuple(c.to(q.dtype) for c in self_kv)
    if round_self:
        chunk = tuple(int8_round_trip(c, q.dtype) for c in chunk)
    return chunk


def flash_decode_paged(q, k_pool, v_pool, page_table,
                       pos: Union[int, torch.Tensor],
                       scale: Optional[float] = None, layer=None,
                       self_kv=None, round_self: bool = False
                       ) -> torch.Tensor:
    """Decode attention over a PAGED KV cache (counterpart of the JAX
    ``flash_decode_paged``): logical block j of row b lives at
    ``pool[page_table[b, j]]``.  The ``flash_decode_paged.cu`` kernel on
    CUDA tensors, :func:`_paged_decode_reference` on CPU tensors.

    ``q``: [B, H, D] or [B, t, H, D]; pools [P, KV, page, D] or the
    stacked [L, P, KV, page, D] with ``layer`` (read in place — no
    per-layer slice), plain tensors or int8 :class:`QTensor` s with
    lane-major scales [(L,) P, KV, 1, page]; ``page_table`` [B, NP] int;
    ``pos`` int or [B].  Without ``self_kv`` the pool already holds the
    chunk (token tt sees positions <= pos + tt); with ``self_kv`` =
    ([B, t, KV, D], [B, t, KV, D]) in q's dtype the pool holds positions
    < pos only and the chunk attends from the self operand, causally
    within itself.  As in JAX, the caller of an int8 pool
    quantize-dequantizes the chunk so it matches a committed slot; the
    port's own callers pass the raw chunk with ``round_self=True`` and the
    kernel rounds it (:func:`~tfmesos_tpu_torch.ops.quant.int8_round_trip`
    on the CPU).  Returns q's shape."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    kc, vc, ks, vs, li = _stacked_cache(k_pool, v_pool, layer)
    if q.shape[2] % kc.shape[2] or kc.shape[2] != vc.shape[2]:
        raise ValueError(f"q heads ({q.shape[2]}) must be a multiple of "
                         f"pool kv heads ({kc.shape[2]}/{vc.shape[2]})")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        out = _paged_decode_reference(
            q, k_pool, v_pool, page_table, pos, scale, layer=layer,
            self_kv=_self_operands(q, self_kv, round_self))
    else:
        out = _flash_decode_paged_cuda(q, kc, vc, ks, vs, page_table, pos,
                                       float(scale), li, self_kv,
                                       round_self)
    return out[:, 0] if squeeze else out


def _flash_decode_paged_cuda(q, kp, vp, ks, vs, page_table, pos,
                             scale: float, layer: int, self_kv,
                             round_self: bool = False):
    kv_int8 = _check_kv("flash_decode_paged", q, kp, vp, ks, vs)
    b, t, h, d = q.shape
    n_layers, n_pages, kvh, ps, _ = kp.shape
    if not 0 <= layer < n_layers:
        raise ValueError(f"flash_decode_paged: layer {layer} out of range "
                         f"for {n_layers} layers")
    if d not in _DECODE_HEAD_DIMS:
        raise ValueError(f"flash_decode_paged: the CUDA kernel takes "
                         f"head_dim in {_DECODE_HEAD_DIMS}, got {d}")
    table = torch.as_tensor(page_table, device=q.device).to(
        torch.int32).contiguous()
    if table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"flash_decode_paged: page table "
                         f"{tuple(table.shape)} for {b} rows")
    posv = _row_positions(pos, b, q.device)
    q = q.contiguous()
    kself = vself = None
    if self_kv is not None:
        kself, vself = (c.to(q.dtype).contiguous() for c in self_kv)
        if kself.shape != (b, t, kvh, d) or vself.shape != kself.shape:
            raise ValueError(f"flash_decode_paged: self_kv "
                             f"{tuple(kself.shape)} / {tuple(vself.shape)}, "
                             f"want {(b, t, kvh, d)}")
        _check_cuda_operands("flash_decode_paged", q, kself, vself)
    elif round_self:
        raise ValueError("round_self needs a self_kv chunk")
    splits = _decode_plan(q, kvh, table.shape[1] * ps)
    out = torch.empty_like(q)
    parts, _scratch = _split_scratch(splits, b * t * h, d, q.device)
    fn = build.kernel("flash_decode_paged", "tfm_flash_decode_paged",
                      _PAGED_ARGS)
    with torch.cuda.device(q.device):
        LAUNCHES["flash_decode_paged"] += 1
        if splits > 1:
            LAUNCHES["flash_decode_paged_merge"] += 1
        err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                 ks.data_ptr() if kv_int8 else None,
                 vs.data_ptr() if kv_int8 else None,
                 table.data_ptr(), posv.data_ptr(),
                 None if kself is None else kself.data_ptr(),
                 None if vself is None else vself.data_ptr(), out.data_ptr(),
                 *parts, b, t, h, kvh, d, n_pages, ps, table.shape[1], layer,
                 splits, int(round_self), scale,
                 int(q.dtype == torch.bfloat16), int(kv_int8),
                 _stream(q.device))
    build.check("flash_decode_paged", err, "flash_decode_paged")
    return out
