"""Flagship decoder-only transformer, single device (port of
``tfmesos_tpu/models/transformer.py``: config, params and int8 weights
``:42-262``, the trunk ``:581-743``, linear and paged caches and decode
``:746-1076, 1248-1560``, sampling and ``generate`` ``:1563-1774``,
the training loss ``:2103-2176``).

Same parameter dict as the JAX package — stacked per-layer leaves
``layers/<name>`` of shape [L, ...] — with the same shapes and init
scales, so weights carry across through ``convert.py``.  bf16 compute
over float32 master params, float32 normalization statistics and
softmax, and the JAX package's cast points exactly: every weight is
cast to the compute dtype at use.

Attention goes through ``ops/attention.py``: the prompt prefill and
``forward`` through ``flash_attention`` (the ``flash_fwd.cu`` kernel on
the card, and under autograd the ``flash_bwd.cu`` kernels for its
gradient), every paged decode step through ``flash_decode_paged`` (the
``flash_decode_paged.cu`` kernel) and every other linear-cache step
through ``flash_decode`` (the ``flash_decode.cu`` kernel) — on the card
every call launches its kernel, whatever the context length or chunk
size.

int8 serving (``quantize_params`` plus an int8 KV cache) goes through
``ops/quant.py``'s ``quant_int8.cu`` kernel (its round-to-nearest result
is bit-identical to the JAX package's ``quantize_int8_reference``):
every weight leaf in one launch, and each int8 cache commit — a linear
cache's K and V of one layer, or a paged pool's K and V of every layer
after a decode step — in one launch that quantizes the chunks straight
into their cache slots.  Weight scales fold into the activation at
each matmul (``_qmm``) and cache scales into the decode kernels.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tfmesos_tpu_torch import graphs
from tfmesos_tpu_torch.ops import prng
from tfmesos_tpu_torch.ops.attention import (_dequant_lane_major,
                                             flash_attention, flash_decode,
                                             flash_decode_paged)
from tfmesos_tpu_torch.ops.layers import (cross_entropy_loss,
                                          fused_linear_cross_entropy,
                                          rms_norm, rope)
from tfmesos_tpu_torch.ops.quant import (QTensor, _paged_slots,
                                         _put_positions, commit_int8,
                                         quantize_tensors)

Params = Dict[str, Any]


@dataclass(frozen=True)
class TransformerConfig:
    """Dense decoder-only transformer configuration (the JAX
    ``TransformerConfig``'s dense fields).  ``n_kv_heads < n_heads`` is
    grouped-query attention; ``window`` a sliding attention window
    (``forward``, and rolling linear caches in decode — paged caches
    refuse it, as in JAX).  Training:
    ``fused_ce`` (None = auto, which is the fused head + cross entropy
    on one device; False = materialize the logits), ``ce_chunk`` tokens
    per fused chunk, ``z_loss`` the LM-head z-loss weight."""

    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    d_ff: int = 2048
    n_kv_heads: Optional[int] = None
    max_seq_len: int = 2048
    window: Optional[int] = None
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16         # compute dtype
    param_dtype: torch.dtype = torch.float32    # master params
    remat: bool = False
    n_experts: int = 0
    fused_ce: Optional[bool] = None
    ce_chunk: int = 2048
    z_loss: float = 0.0

    def __post_init__(self):
        if self.window is not None and self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window} "
                             f"(use None for full causal attention)")
        if self.n_experts > 0:
            raise NotImplementedError(
                "MoE configs (n_experts > 0) are not ported yet")
        if self.remat:
            raise NotImplementedError(
                "remat (recomputing each block in the backward) is not "
                "ported yet")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        kv = self.n_heads if self.n_kv_heads is None else self.n_kv_heads
        if kv < 1 or self.n_heads % kv:
            raise ValueError(f"n_heads ({self.n_heads}) must be a positive "
                             f"multiple of n_kv_heads ({kv})")
        return kv


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: Union[str, torch.device] = "cpu") -> Params:
    """Random params with the JAX ``init_params`` layout, shapes and
    scales, drawn on the CPU from ``generator`` (so a seed gives the
    same weights on every device) and moved to ``device``."""
    d, f, l = cfg.d_model, cfg.d_ff, cfg.n_layers
    hd = cfg.n_heads * cfg.head_dim
    kvd = cfg.kv_heads * cfg.head_dim

    def norm(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * scale).to(cfg.param_dtype).to(device)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.param_dtype, device=device)

    layers = {
        "attn_norm": ones((l, d)),
        "wq": norm((l, d, hd), 1 / math.sqrt(d)),
        "wk": norm((l, d, kvd), 1 / math.sqrt(d)),
        "wv": norm((l, d, kvd), 1 / math.sqrt(d)),
        "wo": norm((l, hd, d), 1 / math.sqrt(hd) / math.sqrt(2 * l)),
        "mlp_norm": ones((l, d)),
        "w_gate": norm((l, d, f), 1 / math.sqrt(d)),
        "w_up": norm((l, d, f), 1 / math.sqrt(d)),
        "w_down": norm((l, f, d), 1 / math.sqrt(f) / math.sqrt(2 * l)),
    }
    return {
        "embed": norm((cfg.vocab_size, d), 1.0),
        "layers": layers,
        "norm_f": ones((d,)),
        "head": norm((d, cfg.vocab_size), 1 / math.sqrt(d)),
    }


#: Weight leaves quantize_params converts: the big matmul operands
#: (norms are tiny and precision-critical).  The JAX set also names the
#: MoE expert leaves, which come with the MoE configs.
_QUANT_KEYS = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up",
                         "w_down"})


def quantize_params(cfg: TransformerConfig, params: Params) -> Params:
    """Weight-only int8 quantization (per-row absmax, ``ops/quant.py``):
    the embedding table, the head and every per-layer projection become
    :class:`QTensor` s (all of them in one ``quant_int8.cu`` launch on
    the card); norms stay as they are.  The tree drops into ``forward``,
    ``decode_step``, ``generate`` and the batcher unchanged."""
    keys = [k for k in params["layers"] if k in _QUANT_KEYS]
    embed, *qlayers, head = quantize_tensors(
        [params["embed"], *(params["layers"][k] for k in keys),
         params["head"]])
    layers = dict(params["layers"], **dict(zip(keys, qlayers)))
    return {"embed": embed, "layers": layers, "norm_f": params["norm_f"],
            "head": head}


def layer_params(params: Params, li: int) -> Params:
    """Layer ``li``'s slice of the stacked ``layers`` leaves (views; a
    :class:`QTensor` slices its values and scales alike)."""
    return {k: (QTensor(v.values[li], v.scales[li])
                if isinstance(v, QTensor) else v[li])
            for k, v in params["layers"].items()}


def _qmm(x: torch.Tensor, w, dtype: torch.dtype):
    """``x @ W`` for a plain or int8 weight.  A plain weight is cast to
    the compute dtype at use; a :class:`QTensor`'s per-input-channel
    scales ([K, 1], K the contraction dim) commute across the product,
    so they fold into the activation — ``(x * s) @ values`` — and the
    weight is read as int8 widened to the compute dtype."""
    if isinstance(w, QTensor):
        s = w.scales.reshape(w.scales.shape[:-2] + (-1,)).to(dtype)
        return (x * s) @ w.values.to(dtype)
    return x @ w.to(dtype)


def _embed_lookup(table, tokens: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Embedding gather; casting the gathered rows equals gathering the
    cast table (the cast is elementwise).  An int8 table gathers values
    and scales, then dequantizes only the gathered rows."""
    if isinstance(table, QTensor):
        return table.values[tokens].to(dtype) * table.scales[tokens].to(dtype)
    return table[tokens].to(dtype)


def _qswiglu(h: torch.Tensor, w_gate, w_up, w_down, dtype: torch.dtype):
    """SwiGLU, silu(h·Wg) ⊙ (h·Wu) · Wd, over :func:`_qmm`, so int8
    weights take the activation-folded form at every product."""
    g = torch.nn.functional.silu(_qmm(h, w_gate, dtype))
    return _qmm(g * _qmm(h, w_up, dtype), w_down, dtype)


def _mlp(cfg: TransformerConfig, lp: Params, h: torch.Tensor):
    return _qswiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"], cfg.dtype)


def _qkv(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
         positions: torch.Tensor):
    """Attention-norm, the q/k/v projections and rope."""
    b, t, _ = x.shape
    h = rms_norm(x, lp["attn_norm"].to(cfg.dtype))
    q = _qmm(h, lp["wq"], cfg.dtype).reshape(b, t, cfg.n_heads,
                                             cfg.head_dim)
    k = _qmm(h, lp["wk"], cfg.dtype).reshape(b, t, cfg.kv_heads,
                                             cfg.head_dim)
    v = _qmm(h, lp["wv"], cfg.dtype).reshape(b, t, cfg.kv_heads,
                                             cfg.head_dim)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _finish_block(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
                  o: torch.Tensor) -> torch.Tensor:
    """Output projection, residual, MLP-norm, SwiGLU, residual."""
    b, t, _ = x.shape
    x = x + _qmm(o.reshape(b, t, -1), lp["wo"], cfg.dtype)
    h = rms_norm(x, lp["mlp_norm"].to(cfg.dtype))
    return x + _mlp(cfg, lp, h)


def _block(cfg: TransformerConfig, x: torch.Tensor, lp: Params,
           positions: torch.Tensor) -> torch.Tensor:
    """One transformer block over a full sequence (causal attention)."""
    q, k, v = _qkv(cfg, lp, x, positions)
    o = flash_attention(q, k, v, causal=True, window=cfg.window)
    return _finish_block(cfg, lp, x, o)


def forward_hidden(cfg: TransformerConfig, params: Params,
                   tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] -> final-norm hidden states [B, T, d]."""
    b, t = tokens.shape
    x = _embed_lookup(params["embed"], tokens, cfg.dtype)
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    for li in range(cfg.n_layers):
        x = _block(cfg, x, layer_params(params, li), positions)
    return rms_norm(x, params["norm_f"].to(cfg.dtype))


def forward(cfg: TransformerConfig, params: Params,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, V] in the compute dtype."""
    return _qmm(forward_hidden(cfg, params, tokens), params["head"],
                cfg.dtype)


def _fused_ce_mode(cfg: TransformerConfig,
                   params: Optional[Params] = None) -> Optional[str]:
    """Which head + cross-entropy path :func:`loss_fn` takes on one
    device: ``"dense"`` (the fused, chunked form) unless
    ``cfg.fused_ce`` is False or the head is an int8 :class:`QTensor`
    (a serving tree), then None (materialize the logits)."""
    if cfg.fused_ce is False or (params is not None
                                 and isinstance(params["head"], QTensor)):
        return None
    return "dense"


def loss_fn(cfg: TransformerConfig, params: Params,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token prediction: ``batch = {"tokens": [B, T+1]}`` ->
    ``(loss, {"perplexity"})``, loss the float32 mean cross entropy of
    positions 1..T given 0..T-1."""
    tokens = batch["tokens"]
    labels = tokens[:, 1:].long()
    if _fused_ce_mode(cfg, params) == "dense":
        x = forward_hidden(cfg, params, tokens[:, :-1])
        # The master-dtype head: the op computes in x's dtype and
        # accumulates dw in float32 at the param dtype.
        loss = fused_linear_cross_entropy(x, params["head"], labels,
                                          z_loss=cfg.z_loss,
                                          chunk=cfg.ce_chunk)
    else:
        loss = cross_entropy_loss(forward(cfg, params, tokens[:, :-1]),
                                  labels, z_loss=cfg.z_loss)
    return loss, {"perplexity": torch.exp(loss)}


def entry(device: Union[str, torch.device, None] = None
          ) -> Tuple[Callable, Tuple[Params, torch.Tensor]]:
    """``(fn, args)``: the flagship forward at tokens [4, 1024] (vocab
    8192, d512, 8 layers, 8 heads, d_ff 1408, bf16), weights seeded 0,
    tokens seeded 1 — the port's analog of ``__graft_entry__.entry``.
    Runs on the card unless ``device="cpu"``."""
    from tfmesos_tpu_torch.device import resolve_device
    from tfmesos_tpu_torch.models.presets import flagship_model

    dev = resolve_device(device)
    cfg, params = flagship_model(seed=0, max_len=1024, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (4, 1024),
                           generator=torch.Generator().manual_seed(1)).to(dev)

    def fn(params, tokens):
        return forward(cfg, params, tokens)

    return fn, (params, tokens)


# -- KV caches ----------------------------------------------------------------


def _kv_buffer(shape: Tuple[int, ...], dtype: Optional[torch.dtype],
               quantized: bool, cfg: TransformerConfig, device, what: str):
    """One K or V buffer of ``shape`` ([L, ..., M|page, head_dim]): the
    compute dtype (or ``dtype``), or an int8 :class:`QTensor` whose
    float32 scales are LANE-MAJOR ([L, ..., 1, M|page] — positions on the
    trailing dim, as the decode kernels read them)."""
    if not quantized:
        return torch.zeros(shape, dtype=dtype or cfg.dtype, device=device)
    if dtype is not None:
        raise ValueError(f"{what}: dtype and quantized=True conflict (an "
                         f"int8 cache's dtypes are fixed)")
    return QTensor(torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.ones(shape[:-2] + (1, shape[-2]),
                              dtype=torch.float32, device=device))


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None, quantized: bool = False,
               device: Union[str, torch.device] = "cpu"
               ) -> Dict[str, Any]:
    """A linear KV cache for :func:`generate`: stacked
    [L, B, KV, M, head_dim] K/V buffers (kv-head-major with positions and
    head_dim trailing, the ``flash_decode`` kernel's layout), written in
    place one chunk at a time at its layer index.  ``quantized=True``
    stores int8 :class:`QTensor` s with one float32 scale per (layer,
    row, head, position), held lane-major [L, B, KV, 1, M].

    With sliding-window attention (``cfg.window``) the buffer is a
    ROLLING cache of ``min(max_len, window)`` slots (slot = position mod
    slots): a position's slot is reclaimed exactly when it leaves the
    window, so memory and per-step cache reads stay O(window) however
    long generation runs."""
    if cfg.window is not None:
        max_len = min(max_len, cfg.window)
    shape = (cfg.n_layers, batch, cfg.kv_heads, max_len, cfg.head_dim)
    return {name: _kv_buffer(shape, dtype, quantized, cfg, device,
                             "init_cache") for name in ("k", "v")}


def init_paged_cache(cfg: TransformerConfig, n_pages: int,
                     page_size: int = 128,
                     dtype: Optional[torch.dtype] = None,
                     quantized: bool = False,
                     device: Union[str, torch.device] = "cpu"
                     ) -> Dict[str, Any]:
    """A PAGED KV cache: one pool of ``n_pages`` pages per layer shared
    by every sequence, stacked [L, P, KV, page, head_dim] (page and
    head_dim trailing, the kernel's layout); ``quantized=True`` stores
    int8 :class:`QTensor` pools with lane-major scales
    [L, P, KV, 1, page].  Pass ``{"k", "v", "pages"}`` (this dict plus a
    page table) to :func:`decode_step`."""
    if cfg.window is not None:
        raise ValueError("paged caches do not compose with sliding-window "
                         "configs (rolling caches address by slot)")
    if page_size % 8 or page_size > 1024:
        raise ValueError(f"page_size ({page_size}) must be a multiple of "
                         f"8 and <= 1024")
    shape = (cfg.n_layers, n_pages, cfg.kv_heads, page_size, cfg.head_dim)
    return {name: _kv_buffer(shape, dtype, quantized, cfg, device,
                             "init_paged_cache") for name in ("k", "v")}


class PageAllocator:
    """Host-side page bookkeeping for :func:`init_paged_cache` (numpy; a
    copy of the JAX package's): a free list over ``n_pages`` and
    per-row page lists.  ``ensure`` backs a row's positions as it grows,
    ``release`` frees them, ``table`` builds the page table."""

    def __init__(self, n_pages: int, page_size: int):
        self.page_size = int(page_size)
        self.free = list(range(n_pages - 1, -1, -1))
        self.rows: Dict[int, list] = {}
        # Optional allocation-pressure hook: called with the free list
        # empty, returns True after putting at least one page back on it
        # (the serving prefix cache reclaims zero-ref cached pages this
        # way, so retained pages never block an allocation).
        self.reclaim: Optional[Callable[[], bool]] = None

    def _take(self) -> int:
        if not self.free:
            while self.reclaim is not None and self.reclaim():
                if self.free:
                    break
            if not self.free:
                raise RuntimeError("page pool exhausted")
        return self.free.pop()

    def ensure(self, row: int, length: int) -> None:
        """Back positions [0, length) of ``row`` with pages."""
        need = -(-int(length) // self.page_size)
        pages = self.rows.setdefault(row, [])
        while len(pages) < need:
            pages.append(self._take())

    def release(self, row: int) -> None:
        self.free.extend(reversed(self.rows.pop(row, [])))

    def reserve_page(self) -> int:
        """Permanently take one page out of circulation and return its id
        (serving uses this as a write sink for inactive decode rows)."""
        return self._take()

    def free_count(self) -> int:
        return len(self.free)

    def allocated(self, row: int) -> int:
        """Pages currently backing ``row``."""
        return len(self.rows.get(row, []))

    def table(self, rows: Sequence[int], width: Optional[int] = None,
              fill: int = 0) -> torch.Tensor:
        """[len(rows), NP] int32 table.  NP defaults to the longest
        listed row's page count; unused entries hold ``fill``."""
        lists = [self.rows.get(r, []) for r in rows]
        if width is None:
            width = max(1, max((len(p) for p in lists), default=1))
        t = np.full((len(lists), width), fill, np.int32)
        for i, pages in enumerate(lists):
            t[i, :len(pages)] = pages
        return torch.from_numpy(t)


def _cache_logical_len(cache_leaf, pages=None) -> int:
    """Logical attended length of a stacked cache leaf: slots of a
    [L, B, KV, M, Dh] linear buffer, or table width x page for a
    [L, P, KV, page, Dh] pool (the position axis is 3 in both)."""
    buf = cache_leaf.values if isinstance(cache_leaf, QTensor) else \
        cache_leaf
    return (pages.shape[1] * buf.shape[3] if pages is not None
            else buf.shape[3])


def _cache_read(cache, li: int, dtype: torch.dtype) -> torch.Tensor:
    """Layer ``li`` of a linear cache as [B, KV, M, Dh]: an int8 cache
    dequantized in ``dtype``, a plain one at its own dtype."""
    if isinstance(cache, QTensor):
        return _dequant_lane_major(QTensor(cache.values[li],
                                           cache.scales[li]), dtype)
    return cache[li]


def _cache_write(cache: Dict[str, Any], k: torch.Tensor, v: torch.Tensor,
                 li: int, pos, start: torch.Tensor,
                 rolling: bool = False) -> None:
    """Insert layer ``li``'s K and V chunks ([B, t, KV, Dh]) into the
    stacked linear cache [L, B, KV, M, Dh] at positions pos..pos+t-1 of
    each row, IN PLACE (the start clamps so the chunk fits, as a dynamic
    slice update clamps).  An int8 cache takes both in one
    :func:`~tfmesos_tpu_torch.ops.quant.commit_int8` (one
    ``quant_int8.cu`` launch on the card), reading the rows' starts from
    the device tensor ``start`` [B]; a plain one takes two indexed
    writes at ``pos`` (the prefill's int 0, else [B] on the device).

    ``rolling`` (window configs, the JAX ``_cache_write(rolling=True)``):
    position p writes slot p mod M.  A one-token step is one write at
    the slot computed from the device tensor ``start``; a longer chunk
    needs a python-int ``pos`` (the prefill) and keeps its last M
    tokens, rotated into slot order and written from slot 0 (each
    position quantizes on its own, so an int8 cache holds what the
    reference's modular scatter writes)."""
    if rolling:
        k, v, start, pos = _rolling_chunk(cache, k, v, pos, start)
    if isinstance(cache["k"], QTensor):
        commit_int8(cache["k"], cache["v"], [k], [v], start, layer=li)
        return
    for buf, x in ((cache["k"], k), (cache["v"], v)):
        _put_positions(buf[li], x.to(buf.dtype), pos)


def _rolling_chunk(cache: Dict[str, Any], k: torch.Tensor, v: torch.Tensor,
                   pos, start: torch.Tensor):
    """A rolling write as a plain one: ``(k, v, start, pos)`` for
    :func:`_cache_write` (every row at row 0's position: rolling caches
    are never ragged, which :func:`decode_step` enforces).  A
    multi-token chunk needs a python-int ``pos``, as the reference's
    static-position rule."""
    buf = cache["k"].values if isinstance(cache["k"], QTensor) else \
        cache["k"]
    m = buf.shape[3]
    t = k.shape[1]
    if t == 1:
        slot = start % m
        return k, v, slot, slot
    if not isinstance(pos, int):
        raise ValueError("multi-token rolling-cache writes need a "
                         "static position (prefill); decode rolls one "
                         "token at a time")
    if pos + t <= m:
        return k, v, start, pos
    shift = (pos + t) % m
    k, v = (torch.roll(x[:, t - m:], shifts=shift, dims=1) for x in (k, v))
    return k, v, torch.zeros_like(start), 0


def _paged_cache_write_all(cache: Dict[str, Any],
                           ks: Sequence[torch.Tensor],
                           vs: Sequence[torch.Tensor],
                           start: torch.Tensor) -> None:
    """Commit ALL layers' deferred K and V chunks (``ks[li]``,
    ``vs[li]``: [B, t, KV, Dh]) into the stacked pools at logical
    positions start..start+t-1 per row (``start`` [B] on the device),
    chasing the page table ``cache["pages"]``, IN PLACE (the pool is the
    batcher's long-lived buffer; a copy would double its memory).  The
    block index is clamped to the table width: a parked row's position
    can sit one block past it, and its whole table row is the sink.  An
    int8 pool quantizes every (row, token, layer, head) slot on the way
    in, K and V of every layer in one
    :func:`~tfmesos_tpu_torch.ops.quant.commit_int8`; a plain pool takes
    one indexed write a buffer."""
    table = cache["pages"]
    if isinstance(cache["k"], QTensor):
        commit_int8(cache["k"], cache["v"], ks, vs, start, page_table=table)
        return
    b, t, kvh, dh = ks[0].shape
    pages, offs = _paged_slots(table, start, b, t, cache["k"].shape[3])
    for pool, chunks in ((cache["k"], ks), (cache["v"], vs)):
        # [L, B, t, KV, Dh] -> [B*t, L, KV, Dh]: the advanced indices
        # (pages, offs) around the head slice front the update's row dim.
        x = torch.stack(list(chunks)).permute(1, 2, 0, 3, 4).reshape(
            b * t, len(chunks), kvh, dh)
        pool[:, pages, :, offs] = x.to(pool.dtype)


# -- decode ----------------------------------------------------------------


def _block_decode(cfg: TransformerConfig, x: torch.Tensor, lp: Params,
                  cache: Dict[str, Any], li: int, positions: torch.Tensor,
                  pos: Union[int, torch.Tensor]):
    """One block over a token chunk with cached history.  A multi-token
    chunk at python-int ``pos == 0`` is a prefill from an empty cache and
    attends only to itself.  A LINEAR cache (no ``"pages"``) is written
    first and then attended through ``flash_decode``; a PAGED pool is
    NOT written here: other chunks attend the committed pool plus
    themselves through the deferred ``self_kv`` operand, and the chunk's
    K/V comes back for :func:`decode_step`'s single commit."""
    t = x.shape[1]
    q, k, v = _qkv(cfg, lp, x, positions)
    prefill = t > 1 and isinstance(pos, int) and pos == 0
    pages = cache.get("pages")
    rolling = cfg.window is not None
    if rolling and t > 1 and not prefill:
        raise ValueError("chunked decode over a rolling windowed cache is "
                         "not supported; decode one token per step after "
                         "the prefill")
    if pages is None:
        _cache_write(cache, k, v, li, pos, positions[:, 0], rolling=rolling)
        chunk = None
    else:
        chunk = (k, v)
    if prefill:
        o = flash_attention(q, k, v, causal=True, window=cfg.window)
    elif rolling:
        o = _rolling_decode(cfg, q, cache, li, positions)
    elif pages is None:
        o = flash_decode(q, cache["k"], cache["v"], positions[:, 0],
                         layer=li)
    else:
        # An int8 pool's kernel rounds the chunk as a committed slot holds
        # it (quant.int8_round_trip) before attending it.
        o = flash_decode_paged(q, cache["k"], cache["v"], pages,
                               positions[:, 0], layer=li, self_kv=(k, v),
                               round_self=isinstance(cache["k"], QTensor))
    return _finish_block(cfg, lp, x, o), chunk


def _rolling_decode(cfg: TransformerConfig, q: torch.Tensor,
                    cache: Dict[str, Any], li: int,
                    positions: torch.Tensor) -> torch.Tensor:
    """One token's attention over layer ``li`` of a ROLLING cache (the
    reference's grouped einsum, ``_block_decode``'s window branch — plain
    math there too, not a kernel): slot j holds global position
    ``p - ((p - j) % M)``, the latest position congruent to j not after
    p; negative slot positions are not written yet, and positions older
    than the window are masked.  Rolling caches are never ragged, so
    every row reads row 0's position."""
    b, t, h, d = q.shape
    kc = _cache_read(cache["k"], li, cfg.dtype)
    vc = _cache_read(cache["v"], li, cfg.dtype)
    kv, m = kc.shape[1], kc.shape[2]
    q5 = q.reshape(b, t, kv, h // kv, d)
    s = torch.einsum("btkgd,bkmd->bkgtm", q5, kc).float()
    s = s / math.sqrt(cfg.head_dim)
    p0 = positions[0, 0]
    slot = torch.arange(m, device=q.device)
    spos = p0 - torch.remainder(p0 - slot, m)
    bad = (spos < 0) | (spos < p0 - (cfg.window - 1))
    s = s.masked_fill(bad, float("-inf"))
    probs = torch.softmax(s, dim=-1).to(vc.dtype)
    return torch.einsum("bkgtm,bkmd->btkgd", probs, vc).reshape(b, t, h, d)


def decode_step(cfg: TransformerConfig, params: Params,
                cache: Dict[str, Any], tokens: torch.Tensor,
                pos: Union[int, torch.Tensor]):
    """Advance decoding by a token chunk.

    ``tokens``: [B, t]; ``pos``: first global position of the chunk — a
    [B] tensor of per-row positions (a 0-d tensor or an int for every
    row alike; a python int 0 with t > 1 is a prefill from empty).
    Every other chunk reads its positions from a device tensor, so a
    captured step replays at whatever position its buffer holds.
    ``cache``: a LINEAR cache ``{"k", "v"}`` (:func:`init_cache`; each
    layer writes its chunk, then attends) or a PAGED one ``{"k", "v",
    "pages"}`` with stacked pools [L, P, KV, page, D] and the page table
    [B, NP] (one commit of every layer's chunk after the layer loop).
    Either is plain or int8.  Returns (logits [B, t, V], cache); the
    buffers update IN PLACE."""
    b, t = tokens.shape
    dev = tokens.device
    if (cfg.window is not None and isinstance(pos, torch.Tensor)
            and pos.dim() == 1):
        raise ValueError("ragged positions do not compose with "
                         "sliding-window (rolling-cache) configs")
    offs = torch.arange(t, device=dev)
    if isinstance(pos, int) and pos == 0 and t > 1:
        positions = offs.expand(b, t)
    else:
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((b,), int(pos), dtype=torch.long, device=dev)
        pos = pos.to(dev).long().reshape(-1).expand(b)
        positions = pos[:, None] + offs[None]
    x = _embed_lookup(params["embed"], tokens, cfg.dtype)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for li in range(cfg.n_layers):
        x, chunk = _block_decode(cfg, x, layer_params(params, li), cache,
                                 li, positions, pos)
        if chunk is not None:
            ks.append(chunk[0])
            vs.append(chunk[1])
    if ks:
        _paged_cache_write_all(cache, ks, vs, positions[:, 0])
    x = rms_norm(x, params["norm_f"].to(cfg.dtype))
    return _qmm(x, params["head"], cfg.dtype), cache


# -- generation ----------------------------------------------------------------


def _check_sampling_args(top_k: Optional[int], top_p: Optional[float]):
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def filter_logits(logits: torch.Tensor, temperature: float = 1.0,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Temperature-scale ``logits`` [..., V] in float32 and mask to -inf
    everything outside the ``top_k`` highest logits and/or the ``top_p``
    nucleus (the JAX ``filter_logits``): top-k keeps what is not below
    the k-th value; top-p sorts descending and keeps each token whose
    PRECEDING softmax mass is < ``top_p`` (so the argmax always
    survives).  Static shapes throughout (``topk``, ``sort``, masks), so
    a CUDA graph can hold it.  Requires ``temperature > 0``."""
    if temperature <= 0.0:
        raise ValueError("filter_logits needs temperature > 0 (greedy "
                         "sampling has no distribution to filter)")
    _check_sampling_args(top_k, top_p)
    # A tensor divisor: PyTorch's CUDA division by a python scalar
    # multiplies by its reciprocal, one ulp off the reference.
    x = logits.float() / torch.full((), float(np.float32(temperature)),
                                    dtype=torch.float32,
                                    device=logits.device)
    if top_k is not None and top_k < x.shape[-1]:
        kth = torch.topk(x, top_k, dim=-1).values[..., -1:]
        x = x.masked_fill(x < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        ordered = torch.sort(x, dim=-1, descending=True).values
        probs = torch.softmax(ordered, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        threshold = torch.where(keep, ordered, float("inf")).amin(
            dim=-1, keepdim=True)
        x = x.masked_fill(x < threshold, float("-inf"))
    return x


def sample_logits(logits: torch.Tensor, key: Optional[torch.Tensor],
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Token ids from ``logits`` [..., V] (the JAX ``sample_logits``):
    the float32 argmax when ``temperature <= 0`` (``key`` unused), else
    a categorical draw from :func:`filter_logits` with the threefry
    ``key`` (``ops/prng.py``): one [2] key for the whole batch, or a key
    a row ([B, 2] for logits [B, V], the reference's ``vmap``)."""
    if temperature <= 0.0:
        _check_sampling_args(top_k, top_p)
        return torch.argmax(logits.float(), dim=-1)
    filtered = filter_logits(logits, temperature, top_k, top_p)
    return prng.categorical(key, filtered, axis=-1)


def _prefill(cfg: TransformerConfig, params: Params, prompt: torch.Tensor,
             depth: int, quantized: bool = False, prefix=None, cache=None):
    """Fresh-cache prefill shared by the generation entry points: with a
    ``prefix``, prefill it ONCE at batch 1, broadcast the cache to the
    prompt's batch, then decode the per-row prompt chunk at position t0
    over it.  ``cache`` supplies a caller-managed cache instead (linear
    or paged; not with a prefix).  Returns (prompt-chunk logits,
    cache)."""
    b = prompt.shape[0]
    if cache is not None:
        if prefix is not None:
            raise ValueError("generate: prefix and a caller-provided cache "
                             "cannot combine (the prefix broadcast owns "
                             "the buffer layout)")
        return decode_step(cfg, params, cache, prompt, 0)
    cache = init_cache(cfg, 1 if prefix is not None else b, depth,
                       quantized=quantized, device=prompt.device)
    if prefix is None:
        return decode_step(cfg, params, cache, prompt, 0)
    _, cache = decode_step(cfg, params, cache, prefix[None, :], 0)

    def rows(leaf):
        return leaf.repeat_interleave(b, dim=1)

    cache = {k: (QTensor(rows(c.values), rows(c.scales))
                 if isinstance(c, QTensor) else rows(c))
             for k, c in cache.items()}
    return decode_step(cfg, params, cache, prompt, prefix.shape[0])


@torch.no_grad()
def generate(cfg: TransformerConfig, params: Params, prompt: torch.Tensor,
             max_new_tokens: int, rng: Optional[torch.Tensor] = None,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, quantized_cache: bool = False,
             prompt_lens=None, prefix=None,
             stop_token: Optional[int] = None, cache=None,
             _eager: bool = False) -> torch.Tensor:
    """Autoregressive generation (counterpart of the JAX ``generate``):
    prefill the prompt in one pass, then one :func:`decode_step` per
    token over a linear KV cache (:func:`init_cache`; ``quantized_cache``
    stores it int8 — with :func:`quantize_params` weights the full int8
    serving configuration); greedy, or temperature / top-k / top-p
    sampling (:func:`sample_logits`) with the reference's key schedule:
    ``rng`` (a threefry key, ``ops/prng.py``; default ``PRNGKey(0)``) is
    split once before the first token and once a step.  Runs where
    ``prompt`` and ``params`` live.

    On the card the step is a CUDA graph (``graphs.py``): it runs
    eagerly once, is captured, and is replayed for the remaining steps,
    advancing its token, position, key and output column in the graph
    (no graph is kept across calls; ``_eager`` is a diagnostic that
    runs every step eagerly).

    ``prompt``: [B, Tp] token ids.  Returns [B, Tp + max_new_tokens]
    ([B, T0 + Tp + max_new_tokens] with a ``prefix``).  ``prompt_lens``
    ([B]) serves a ragged batch: row i's real prompt is ``prompt[i,
    :prompt_lens[i]]`` and its continuation lands right after it (later
    entries are padding, 0).  ``prefix`` ([T0]) is a shared prompt
    prefix, prefilled once at batch 1.  ``stop_token``: rows that emit
    it freeze (their tail fills with it) and decoding stops once every
    row has (one host sync a step).  ``cache``: a caller-managed linear
    or paged cache that backs every position of the run."""
    b, tp = prompt.shape
    t0 = 0 if prefix is None else prefix.shape[0]
    dev = prompt.device
    if max_new_tokens <= 0:
        if prefix is None:
            return prompt
        return torch.cat([prefix.to(prompt.dtype).expand(b, t0), prompt], 1)
    _check_sampling_args(top_k, top_p)
    if cache is not None and _cache_logical_len(
            cache["k"], cache.get("pages")) < tp + max_new_tokens - 1:
        raise ValueError(f"generate: the cache holds "
                         f"{_cache_logical_len(cache['k'], cache.get('pages'))}"
                         f" positions; the run needs "
                         f"{tp + max_new_tokens - 1}")
    rng = prng.PRNGKey(0, dev) if rng is None else rng.to(dev).long()

    def sample(logits, key):
        return sample_logits(logits, key, temperature, top_k, top_p)

    logits, cache = _prefill(
        cfg, params, prompt.long(), t0 + tp + max_new_tokens,
        quantized=quantized_cache,
        prefix=None if prefix is None else prefix.to(dev).long(),
        cache=cache)
    keys = prng.split(rng)
    if prompt_lens is None:
        next_logits = logits[:, -1]
        # A window config's step reads one position for every row (a
        # rolling cache is never ragged); others keep a position a row.
        pos = torch.full(() if cfg.window is not None else (b,), t0 + tp,
                         dtype=torch.long, device=dev)
    else:
        lens = torch.as_tensor(prompt_lens, device=dev).long()
        # Row i's next token follows its LAST REAL token, not the padding.
        next_logits = logits[torch.arange(b, device=dev), lens - 1]
        pos = t0 + lens
    tok = sample(next_logits, keys[1])
    # The step's static buffers: the token it feeds, its position, the
    # key, the output and the index of the column it writes.  The real
    # token keeps feeding the model after a stop — only the recorded
    # output freezes — so tokens up to each row's first stop equal a
    # stop-free run.
    rng = keys[0].clone()
    generated = torch.full((b, max_new_tokens),
                           0 if stop_token is None else int(stop_token),
                           dtype=torch.long, device=dev)
    generated[:, 0] = tok
    col = torch.zeros((1,), dtype=torch.long, device=dev)
    done = None if stop_token is None else tok == stop_token

    def step():
        logits, _ = decode_step(cfg, params, cache, tok[:, None], pos)
        keys = prng.split(rng)
        nxt = sample(logits[:, -1], keys[1])
        rng.copy_(keys[0])
        rec = nxt
        if done is not None:
            rec = nxt.masked_fill(done, int(stop_token))
            done.logical_or_(nxt == stop_token)
        col.add_(1)
        generated.index_copy_(1, col, rec[:, None])
        tok.copy_(nxt)
        pos.add_(1)

    steps = graphs.StepGraphs(dev)
    steps.eager = steps.eager or _eager
    for _ in range(max_new_tokens - 1):
        if done is not None and bool(done.all()):
            break
        steps.run("step", step)
    generated = generated.to(prompt.dtype)
    lead = ([prefix.to(prompt.dtype).expand(b, t0)]
            if prefix is not None else [])
    if prompt_lens is None:
        return torch.cat([*lead, prompt, generated], dim=1)
    out = torch.cat([*lead, prompt, prompt.new_zeros((b, max_new_tokens))],
                    dim=1)
    idx = (t0 + lens)[:, None] + torch.arange(max_new_tokens, device=dev)
    return out.scatter_(1, idx, generated)       # row i's continuation


# -- speculative decoding -----------------------------------------------------


def greedy_accept_counts(drafts: torch.Tensor, g: torch.Tensor
                         ) -> torch.Tensor:
    """Greedy speculative acceptance (the JAX ``greedy_accept_counts``):
    draft proposals [B, k] against the target's greedy tokens over the
    verify chunk [B, k+1] -> each row's commit count, the leading run of
    matches plus one (the correction, or the bonus when all matched).
    The argmin over [match | False] is the first mismatch, or k."""
    k = drafts.shape[1]
    match = drafts == g[:, :k]
    ext = torch.cat([match, match.new_zeros((match.shape[0], 1))], dim=1)
    return torch.argmin(ext.to(torch.int32), dim=1) + 1


def rejection_accept(drafts: torch.Tensor, pd: torch.Tensor,
                     pt: torch.Tensor, u: torch.Tensor):
    """Speculative rejection sampling's accept/correct math (the JAX
    ``rejection_accept``): ``drafts`` [B, k], their draft distributions
    ``pd`` [B, k, V], the target's filtered distributions ``pt``
    [B, k+1, V] and uniform draws ``u`` [B, k].  Proposal j is accepted
    iff ``u * pd(x_j) < pt(x_j)``; ``a`` is the first rejection (k when
    all pass).  Returns ``(a, dist)``, ``dist`` [B, V] the correction
    distribution norm(max(0, pt - pd)) at index a (pd zero-padded at k,
    so the all-accepted bonus draws from pt_k)."""
    b, k = drafts.shape
    idx = drafts[..., None]
    ptx = torch.take_along_dim(pt[:, :k], idx, dim=-1)[..., 0]
    pdx = torch.take_along_dim(pd, idx, dim=-1)[..., 0]
    acc = u * pdx < ptx
    a = torch.argmin(torch.cat([acc, acc.new_zeros((b, 1))], dim=1).to(
        torch.int32), dim=1)
    pd_pad = torch.cat([pd, pd.new_zeros((b, 1, pd.shape[-1]))], dim=1)
    sel = a[:, None, None]
    pt_a = torch.take_along_dim(pt, sel, dim=1)[:, 0]
    pd_a = torch.take_along_dim(pd_pad, sel, dim=1)[:, 0]
    resid = torch.clamp_min(pt_a - pd_a, 0.0)
    norm = resid.sum(dim=-1, keepdim=True)
    dist = torch.where(norm > 1e-9, resid / torch.clamp_min(norm, 1e-9),
                       pt_a)
    return a, dist


def speculative_cache_depth(prompt_len: int, max_new_tokens: int,
                            n_draft: int, prefix_len: int = 0) -> int:
    """Cache positions :func:`speculative_generate` may touch, its
    overshoot slack included: size a caller's cache with at least this
    many positions a row."""
    return prefix_len + prompt_len + max_new_tokens + 2 * n_draft + 1


@torch.no_grad()
def speculative_generate(cfg: TransformerConfig, params: Params,
                         draft_cfg: TransformerConfig, draft_params: Params,
                         prompt: torch.Tensor, max_new_tokens: int,
                         n_draft: int = 4, prompt_lens=None,
                         temperature: float = 0.0,
                         top_k: Optional[int] = None,
                         top_p: Optional[float] = None,
                         rng: Optional[torch.Tensor] = None,
                         quantized_cache: bool = False, prefix=None,
                         cache=None, stop_token: Optional[int] = None,
                         _eager: bool = False) -> torch.Tensor:
    """Speculative decoding (the JAX ``speculative_generate``): the
    DRAFT model proposes ``n_draft`` tokens a round (t = 1 steps over
    its own linear cache), the target scores them in ONE chunk of
    ``n_draft + 1`` tokens (``flash_decode`` at t = k+1 over its cache,
    or the paged kernel over a caller's paged ``cache``), and each row
    commits its leading accepted run plus one correction or bonus token.

    Greedy (``temperature <= 0``): the output is the target's own greedy
    continuation whatever the draft proposes.  Sampled: Leviathan
    rejection sampling with the reference's key schedule (``rng`` split
    once for the first token, then ``split(rng, 4)`` a round: the draft
    steps' keys from the second, the acceptance uniforms from the third,
    the correction from the fourth), so the streams are the reference's
    draws.  ``prompt`` [B, Tp], ``prompt_lens``, ``prefix`` and
    ``cache`` as in :func:`generate` (the cache must back
    :func:`speculative_cache_depth` positions); ``stop_token`` freezes a
    row once a committed token is the stop, and the tail after a row's
    first stop is unspecified (truncate there).

    On the card the round is a CUDA graph (captured at the first round,
    replayed after); the loop syncs once a round for its exit test."""
    if cfg.window is not None or draft_cfg.window is not None:
        raise ValueError("speculative decoding does not compose with "
                         "sliding-window configs (rolling caches cannot "
                         "be ragged)")
    b, tp = prompt.shape
    dev = prompt.device
    if max_new_tokens <= 0:
        if prefix is None:
            return prompt
        return torch.cat([prefix.to(dev, prompt.dtype).expand(
            b, prefix.shape[0]), prompt], 1)
    k = int(n_draft)
    if k < 1:
        raise ValueError(f"n_draft must be >= 1, got {n_draft}")
    _check_sampling_args(top_k, top_p)
    sampling = temperature > 0.0
    rng = prng.PRNGKey(0, dev) if rng is None else rng.to(dev).long()
    t0 = 0 if prefix is None else prefix.shape[0]
    pfx = None if prefix is None else prefix.to(dev).long()
    tokens = prompt.long()
    depth = speculative_cache_depth(tp, max_new_tokens, k, prefix_len=t0)
    logits, cache = _prefill(cfg, params, tokens, depth,
                             quantized=quantized_cache, prefix=pfx,
                             cache=cache)
    _, dcache = _prefill(draft_cfg, draft_params, tokens, depth, prefix=pfx)
    if prompt_lens is None:
        lens = torch.full((b,), tp, dtype=torch.long, device=dev)
    else:
        lens = torch.as_tensor(prompt_lens, device=dev).long()
    rows = torch.arange(b, device=dev)
    keys = prng.split(rng)
    tok = sample_logits(logits[rows, lens - 1], keys[1], temperature,
                        top_k, top_p)
    rng = keys[0].clone()
    pos = t0 + lens                     # absolute positions from here on
    width = t0 + tp + max_new_tokens
    # One spare column past the output takes every masked commit (the
    # reference's out-of-bounds scatter that drops).
    lead = [pfx.expand(b, t0)] if pfx is not None else []
    out = torch.cat([*lead, tokens, tokens.new_zeros((b, max_new_tokens
                                                      + 1))], dim=1)
    out[rows, pos] = tok
    limit = pos + max_new_tokens
    committed = torch.ones((b,), dtype=torch.long, device=dev)
    if stop_token is not None:
        committed.masked_fill_(tok == stop_token, max_new_tokens)
    j = torch.arange(k + 1, device=dev)[None]

    def draft_steps(draft_keys):
        dtok, dpos = tok, pos
        drafts, pds = [], []
        for i in range(k + 1):
            lg, _ = decode_step(draft_cfg, draft_params, dcache,
                                dtok[:, None], dpos)
            if sampling:
                f = filter_logits(lg[:, -1], temperature, top_k, top_p)
                dtok = prng.categorical(draft_keys[i], f, axis=-1)
                pds.append(torch.softmax(f, dim=-1))
            else:
                dtok = torch.argmax(lg[:, -1].float(), dim=-1)
            drafts.append(dtok)
            dpos = dpos + 1
        # k+1 steps: the extra one writes the last proposal's K/V at
        # pos+k (its own proposal is dropped), so a fully accepted round
        # leaves no hole in the draft's cache.
        return torch.stack(drafts[:k], dim=1), pds[:k]

    def finish(n_commit, vals, nxt_tok):
        idx = pos[:, None] + 1 + j
        keep = (j < n_commit[:, None]) & (idx < limit[:, None])
        out.scatter_(1, torch.where(keep, idx, width), vals)
        nxt = committed + n_commit
        if stop_token is not None:
            hit = ((vals == stop_token) & (j < n_commit[:, None])).any(1)
            nxt = torch.where(hit, max_new_tokens, nxt)
        active = committed < max_new_tokens
        tok.copy_(torch.where(active, nxt_tok, tok))
        pos.add_(n_commit)
        committed.copy_(nxt)

    def greedy_round():
        drafts, _ = draft_steps(None)
        lg, _ = decode_step(cfg, params, cache,
                            torch.cat([tok[:, None], drafts], dim=1), pos)
        g = torch.argmax(lg.float(), dim=-1)                 # [B, k+1]
        counts = greedy_accept_counts(drafts, g)
        n_commit = torch.where(committed < max_new_tokens, counts, 0)
        finish(n_commit, g,
               torch.take_along_dim(g, (counts - 1)[:, None], dim=1)[:, 0])

    def sampling_round():
        kr = prng.split(rng, 4)
        rng.copy_(kr[0])
        drafts, pds = draft_steps(prng.split(kr[1], k + 1))
        lg, _ = decode_step(cfg, params, cache,
                            torch.cat([tok[:, None], drafts], dim=1), pos)
        pt = torch.softmax(filter_logits(lg, temperature, top_k, top_p),
                           dim=-1)
        u = prng.uniform(kr[2], (b, k))
        a, dist = rejection_accept(drafts, torch.stack(pds, dim=1), pt, u)
        repl = prng.categorical(kr[3], torch.log(dist + 1e-20), axis=-1)
        n_commit = torch.where(committed < max_new_tokens, a + 1, 0)
        cand = torch.cat([drafts, drafts.new_zeros((b, 1))], dim=1)
        finish(n_commit, torch.where(j == a[:, None], repl[:, None], cand),
               repl)

    steps = graphs.StepGraphs(dev)
    steps.eager = steps.eager or _eager
    step = sampling_round if sampling else greedy_round
    while bool((committed < max_new_tokens).any()):
        steps.run("round", step)
    return out[:, :width].to(prompt.dtype)
