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
    (``forward`` only — paged caches refuse it, as in JAX).  Training:
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
    row, head, position), held lane-major [L, B, KV, 1, M].  Sliding
    windows need a rolling cache, which is not ported yet."""
    if cfg.window is not None:
        raise NotImplementedError("rolling (sliding-window) caches are not "
                                  "ported yet")
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

    def _take(self) -> int:
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
                 li: int, pos, start: torch.Tensor) -> None:
    """Insert layer ``li``'s K and V chunks ([B, t, KV, Dh]) into the
    stacked linear cache [L, B, KV, M, Dh] at positions pos..pos+t-1 of
    each row, IN PLACE (the start clamps so the chunk fits, as a dynamic
    slice update clamps).  An int8 cache takes both in one
    :func:`~tfmesos_tpu_torch.ops.quant.commit_int8` (one
    ``quant_int8.cu`` launch on the card), reading the rows' starts from
    the device tensor ``start`` [B]; a plain one takes two indexed
    writes at ``pos`` (the prefill's int 0, else [B] on the device)."""
    if isinstance(cache["k"], QTensor):
        commit_int8(cache["k"], cache["v"], [k], [v], start, layer=li)
        return
    for buf, x in ((cache["k"], k), (cache["v"], v)):
        _put_positions(buf[li], x.to(buf.dtype), pos)


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
    if pages is None:
        _cache_write(cache, k, v, li, pos, positions[:, 0])
        chunk = None
    else:
        chunk = (k, v)
    if prefill:
        o = flash_attention(q, k, v, causal=True, window=cfg.window)
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
        pos = torch.full((b,), t0 + tp, dtype=torch.long, device=dev)
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
