"""Flagship decoder-only transformer, single device (port of
``tfmesos_tpu/models/transformer.py``: config and params ``:42-209``,
the trunk ``:251-262, 581-743``, paged decode ``:791-980, 1304-1560``,
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
``flash_decode_paged.cu`` kernel) — on the card every call launches
its kernel, whatever the context length or chunk size.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tfmesos_tpu_torch.ops.attention import (flash_attention,
                                             flash_decode_paged)
from tfmesos_tpu_torch.ops.layers import (cross_entropy_loss,
                                          fused_linear_cross_entropy,
                                          rms_norm, rope, swiglu)

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


def layer_params(params: Params, li: int) -> Params:
    """Layer ``li``'s slice of the stacked ``layers`` leaves (views)."""
    return {k: v[li] for k, v in params["layers"].items()}


def _qmm(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype):
    """``x @ W`` with the weight cast to the compute dtype at use."""
    return x @ w.to(dtype)


def _embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Embedding gather; casting the gathered rows equals gathering the
    cast table (the cast is elementwise)."""
    return table[tokens].to(dtype)


def _mlp(cfg: TransformerConfig, lp: Params, h: torch.Tensor):
    return swiglu(h, *(lp[n].to(cfg.dtype)
                       for n in ("w_gate", "w_up", "w_down")))


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


def _fused_ce_mode(cfg: TransformerConfig) -> Optional[str]:
    """Which head + cross-entropy path :func:`loss_fn` takes on one
    device: ``"dense"`` (the fused, chunked form) unless
    ``cfg.fused_ce`` is False, then None (materialize the logits)."""
    return None if cfg.fused_ce is False else "dense"


def loss_fn(cfg: TransformerConfig, params: Params,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token prediction: ``batch = {"tokens": [B, T+1]}`` ->
    ``(loss, {"perplexity"})``, loss the float32 mean cross entropy of
    positions 1..T given 0..T-1."""
    tokens = batch["tokens"]
    labels = tokens[:, 1:].long()
    if _fused_ce_mode(cfg) == "dense":
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


# -- paged decode -----------------------------------------------------------


def init_paged_cache(cfg: TransformerConfig, n_pages: int,
                     page_size: int = 128,
                     dtype: Optional[torch.dtype] = None,
                     device: Union[str, torch.device] = "cpu"
                     ) -> Dict[str, torch.Tensor]:
    """A PAGED KV cache: one pool of ``n_pages`` pages per layer shared
    by every sequence, stacked [L, P, KV, page, head_dim] (page and
    head_dim trailing, the kernel's layout).  Pass ``{"k", "v",
    "pages"}`` (this dict plus a page table) to :func:`decode_step`."""
    if cfg.window is not None:
        raise ValueError("paged caches do not compose with sliding-window "
                         "configs (rolling caches address by slot)")
    if page_size % 8 or page_size > 1024:
        raise ValueError(f"page_size ({page_size}) must be a multiple of "
                         f"8 and <= 1024")
    shape = (cfg.n_layers, n_pages, cfg.kv_heads, page_size, cfg.head_dim)
    dt = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


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


def _paged_cache_write_all(pool: torch.Tensor, chunks: torch.Tensor,
                           page_table: torch.Tensor,
                           pos: Union[int, torch.Tensor]) -> torch.Tensor:
    """Commit ALL layers' deferred chunks ([L, B, t, KV, Dh]) into the
    stacked pool at logical positions pos..pos+t-1 per row, chasing the
    page table, in ONE indexed write — IN PLACE (the pool is the
    batcher's long-lived buffer; a copy would double its memory).  The
    block index is clamped to the table width: a parked row's position
    can sit one block past it, and its whole table row is the sink."""
    L, b, t, kvh, dh = chunks.shape
    ps = pool.shape[3]
    dev = pool.device
    table = torch.as_tensor(page_table, device=dev).long()
    posv = torch.as_tensor(pos, device=dev).long().reshape(-1).expand(b)
    lpos = posv[:, None] + torch.arange(t, device=dev)[None]      # [B, t]
    blk = torch.clamp(lpos // ps, max=table.shape[1] - 1)
    pages = torch.take_along_dim(table, blk, dim=1).reshape(-1)
    offs = (lpos % ps).reshape(-1)
    # [L, B, t, KV, Dh] -> [B*t, L, KV, Dh]: the advanced indices
    # (pages, offs) around the head slice front the update's row dim.
    x = chunks.permute(1, 2, 0, 3, 4).reshape(b * t, L, kvh, dh)
    pool[:, pages, :, offs] = x.to(pool.dtype)
    return pool


def _block_decode(cfg: TransformerConfig, x: torch.Tensor, lp: Params,
                  cache: Dict[str, torch.Tensor], li: int,
                  positions: torch.Tensor, pos: Union[int, torch.Tensor]):
    """One block over a token chunk against the paged pool.  A
    multi-token chunk at python-int ``pos == 0`` is a prefill from an
    empty cache and attends only to itself; any other chunk attends
    the committed pool plus itself through the deferred ``self_kv``
    operand.  Either way the pool is NOT written here: the chunk's K/V
    comes back for :func:`decode_step`'s single commit."""
    t = x.shape[1]
    q, k, v = _qkv(cfg, lp, x, positions)
    if t > 1 and isinstance(pos, int) and pos == 0:
        o = flash_attention(q, k, v, causal=True, window=cfg.window)
    else:
        o = flash_decode_paged(q, cache["k"], cache["v"], cache["pages"],
                               positions[:, 0], layer=li, self_kv=(k, v))
    return _finish_block(cfg, lp, x, o), (k, v)


def decode_step(cfg: TransformerConfig, params: Params,
                cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                pos: Union[int, torch.Tensor]):
    """Advance decoding by a token chunk over a PAGED cache.

    ``tokens``: [B, t]; ``pos``: first global position of the chunk — a
    python int (0 = prefill from empty) or a [B] tensor of ragged
    per-row positions.  ``cache``: ``{"k", "v", "pages"}`` with stacked
    pools [L, P, KV, page, D] and the page table [B, NP].  Returns
    (logits [B, t, V], cache); the pools are updated IN PLACE by one
    commit of every layer's chunk after the layer loop."""
    pages = cache.get("pages")
    if pages is None:
        raise ValueError("decode_step serves paged caches: pass "
                         "{'k', 'v', 'pages'}")
    b, t = tokens.shape
    dev = tokens.device
    offs = torch.arange(t, device=dev)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        positions = pos.to(dev).long()[:, None] + offs[None]
    else:
        positions = (int(pos) + offs).expand(b, t)
    x = _embed_lookup(params["embed"], tokens, cfg.dtype)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for li in range(cfg.n_layers):
        x, (k, v) = _block_decode(cfg, x, layer_params(params, li), cache,
                                  li, positions, pos)
        ks.append(k)
        vs.append(v)
    _paged_cache_write_all(cache["k"], torch.stack(ks), pages, pos)
    _paged_cache_write_all(cache["v"], torch.stack(vs), pages, pos)
    x = rms_norm(x, params["norm_f"].to(cfg.dtype))
    return _qmm(x, params["head"], cfg.dtype), cache
