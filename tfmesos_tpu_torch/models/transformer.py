"""Flagship decoder-only transformer, on one device or a mesh (port of
``tfmesos_tpu/models/transformer.py``: config, params and int8 weights
``:42-262``, the feed-forward dispatch (``_zero_aux``, ``_moe_switch``,
``_moe``, ``_ffn``) ``:263-415``, the in-stage forms
(``_block_manual_tp`` ``:467``, ``_sp_gather_attention`` ``:524``,
``_sp_attend`` ``:562``, ``_block`` ``:581``), the trunk ``:581-743``
with its pipeline branch ``:642-735``, linear and paged caches and
decode ``:746-1076, 1248-1560``, sampling and ``generate``
``:1563-1774``, the training loss ``:2103-2176``, ``train_step_1f1b``
``:2179-2386``).

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

Over a mesh (``parallel/mesh.py``; the JAX ``partition_specs`` ``:2409``,
``_block_manual_tp`` ``:467``, ``cache_specs`` / ``paged_cache_specs`` /
``_sharded_paged_step`` ``:1079-1222``) each rank holds plain tensors,
its blocks of the params per :func:`partition_specs`, and the
collectives the JAX package leaves to GSPMD are written out: Megatron
tp (column-parallel q/k/v and gate/up, row-parallel ``wo`` and
``w_down`` each followed by one all-reduce, the vocab-parallel
embedding and head), fsdp's shards gathered a layer at a time; the
kernels run on the rank's heads.  ``ep`` cuts the experts of an MoE
config (whole experts a rank; the dense top-k form computes its local
experts and all-reduces over ep, the switch form moves tokens to their
experts by all-to-all, ``parallel/moe.py``); ``sp`` cuts the sequence
(a rank's tokens at their global positions; attention through
``ops.attention.attend``: the ring or Ulysses).  ``pp`` cuts the layer
stack into stages (``parallel/pipeline.py``): each rank holds its
stage's layers, a stage's body runs JAX's in-stage forms (tp, ep and sp
collectives written out inside the stage), and :func:`train_step_1f1b`
is the fused 1F1B step.  Serving runs on data x tp meshes only, as in
JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils.checkpoint

from tfmesos_tpu_torch import graphs
from tfmesos_tpu_torch.ops import prng
from tfmesos_tpu_torch.ops.attention import (_dequant_lane_major, attend,
                                             flash_attention, flash_decode,
                                             flash_decode_paged)
from tfmesos_tpu_torch.ops.layers import (cross_entropy_loss,
                                          fused_linear_cross_entropy,
                                          rms_norm, rope)
from tfmesos_tpu_torch.ops.quant import (QTensor, _paged_slots,
                                         _put_positions, commit_int8,
                                         quantize_tensors)
from tfmesos_tpu_torch.parallel.collectives import (
    all_reduce_sum_grad, broadcast_replicated_grad, gather_shards,
    psum_replicated_grad)
from tfmesos_tpu_torch.parallel.sharding import (Interleaved, Spec, block,
                                                 data_axes, filter_spec,
                                                 token_axes)

Params = Dict[str, Any]


@dataclass(frozen=True)
class TransformerConfig:
    """Decoder-only transformer configuration (the JAX
    ``TransformerConfig``).
    ``n_kv_heads < n_heads`` is grouped-query attention; ``window`` a
    sliding attention window (``forward``, and rolling linear caches in
    decode — paged caches refuse it, as in JAX).  MoE: ``n_experts``
    routed experts (0: the dense MLP), each token to ``top_k`` of them,
    plus ``n_shared_experts`` always-on ones stored as one FFN of that
    many times ``d_ff``; ``moe_impl`` ``"dense"`` (exact top-k, every
    expert computing every token under the router's mask) or
    ``"switch"`` (capacity ``capacity_factor`` and token dispatch,
    ``parallel/moe.py``); the router's load-balance and z losses join
    the training objective at ``router_aux_weight`` and
    ``router_z_weight``.  ``sp_impl``: ``"ring"`` or ``"ulysses"`` over
    an sp mesh.  ``pp_schedule`` (``"gpipe"`` or ``"circular"``) and
    ``pp_virtual_stages`` (chunks a pp rank; circular only) run the
    forward over a pp mesh (``n_layers`` must divide into pp x
    virtual stages).  Training: ``fused_ce`` (None = auto, which is the
    fused head + cross entropy; False = materialize the logits),
    ``ce_chunk`` tokens per fused chunk, ``z_loss`` the LM-head z-loss
    weight; ``remat`` recomputes each block's forward in the backward
    instead of keeping its activations."""

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
    top_k: int = 2
    n_shared_experts: int = 0
    moe_impl: str = "dense"
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    pp_schedule: str = "gpipe"
    pp_virtual_stages: int = 1
    sp_impl: str = "ring"
    fused_ce: Optional[bool] = None
    ce_chunk: int = 2048
    z_loss: float = 0.0

    def __post_init__(self):
        if self.window is not None and self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window} "
                             f"(use None for full causal attention)")
        if self.moe_impl not in ("dense", "switch"):
            raise ValueError(f"moe_impl must be 'dense' or 'switch', got "
                             f"{self.moe_impl!r}")

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
    scales (the MoE leaves ``router``, ``e_*`` and ``s_*`` in place of
    the MLP's with experts), drawn on the CPU from ``generator`` (so a
    seed gives the same weights on every device) and moved to
    ``device``."""
    if cfg.n_shared_experts and not cfg.n_experts:
        raise ValueError(
            "n_shared_experts requires n_experts > 0 — without routed "
            "experts there is nothing to share beside; widen d_ff instead")
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
    }
    if cfg.n_experts:
        e = cfg.n_experts
        layers.update(
            router=norm((l, d, e), 1 / math.sqrt(d)),
            e_gate=norm((l, e, d, f), 1 / math.sqrt(d)),
            e_up=norm((l, e, d, f), 1 / math.sqrt(d)),
            e_down=norm((l, e, f, d), 1 / math.sqrt(f) / math.sqrt(2 * l)))
        if cfg.n_shared_experts:
            sf = cfg.n_shared_experts * f
            layers.update(
                s_gate=norm((l, d, sf), 1 / math.sqrt(d)),
                s_up=norm((l, d, sf), 1 / math.sqrt(d)),
                s_down=norm((l, sf, d),
                            1 / math.sqrt(sf) / math.sqrt(2 * l)))
    else:
        layers.update(
            w_gate=norm((l, d, f), 1 / math.sqrt(d)),
            w_up=norm((l, d, f), 1 / math.sqrt(d)),
            w_down=norm((l, f, d), 1 / math.sqrt(f) / math.sqrt(2 * l)))
    return {
        "embed": norm((cfg.vocab_size, d), 1.0),
        "layers": layers,
        "norm_f": ones((d,)),
        "head": norm((d, cfg.vocab_size), 1 / math.sqrt(d)),
    }


#: Weight leaves quantize_params converts: the big matmul operands
#: (norms are tiny and precision-critical; the router is tiny and
#: decides routing).
_QUANT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
     "e_gate", "e_up", "e_down", "s_gate", "s_up", "s_down"})


def _quantizable(cfg: TransformerConfig, key: str) -> bool:
    """Which layer leaves :func:`quantize_params` converts (the JAX
    ``_quantizable``): switch-MoE expert weights stay fp, as the
    capacity-dispatch path consumes raw arrays."""
    if cfg.moe_impl == "switch" and key.startswith("e_"):
        return False
    return key in _QUANT_KEYS


def quantize_params(cfg: TransformerConfig, params: Params) -> Params:
    """Weight-only int8 quantization (per-row absmax, ``ops/quant.py``):
    the embedding table, the head and every per-layer projection and
    expert weight (:func:`_quantizable`) become :class:`QTensor` s, all
    of them in one ``quant_int8.cu`` launch on the card; norms and the
    router stay as they are.  The tree drops into ``forward``,
    ``decode_step``, ``generate`` and the batcher unchanged."""
    keys = [k for k in params["layers"] if _quantizable(cfg, k)]
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


def _wt(w, dtype: torch.dtype) -> torch.Tensor:
    """Weight-on-use for the einsum sites (the MoE experts): an int8
    :class:`QTensor` dequantized in ``dtype``, a plain weight cast."""
    if isinstance(w, QTensor):
        return w.dequantize(dtype)
    return w.to(dtype)


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


AUX_KEYS = ("load_balance_loss", "z_loss", "overflow_frac")


def _zero_aux(device=None) -> Dict[str, torch.Tensor]:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {k: z for k in AUX_KEYS}


def _moe_axes(mesh) -> Tuple[str, ...]:
    """The axes a dense MoE's partial products sum over: ep (each rank's
    whole experts) and tp (each expert's FFN width)."""
    return tuple(a for a in ("ep", "tp")
                 if mesh is not None and mesh.axis_size(a) > 1)


def _manual_mesh(mesh, ep_axis: Optional[str], tp_axis: Optional[str]):
    """The mesh a stage body's manual collectives run over: ``mesh``
    seen along the named ep / tp axes alone (no token axis: a stage's
    statistics are its microbatch's), None when neither is named."""
    axes = tuple(a for a in (ep_axis, tp_axis) if a)
    return mesh.only(axes) if axes else None


def _moe(cfg: TransformerConfig, lp: Params, h: torch.Tensor, mesh=None,
         want_aux: bool = True):
    """Top-k routed MoE computed densely over the expert axis (the JAX
    ``_moe``): every expert processes every token and the router's mask
    zeroes the unrouted ones — exact top-k routing.  Returns (out, aux).

    On a mesh the experts are this rank's block: whole experts over ep,
    each expert's FFN width over tp (Megatron per expert).  The router
    (replicated) picks over all E experts; the tokens and the mask fan
    out through Megatron's *f* over ep and tp, the rank computes its
    local experts' slice of the masked products, and one all-reduce
    (*g*) over ep and tp sums the partials (the JAX manual form
    ``:327-348``).  The aux statistics (assignment counts, router
    probabilities, logsumexps) are summed over the mesh's token axes
    first (data and sp), so the aux is the global batch's, as GSPMD
    computes it; ``want_aux=False`` (decode) skips them (aux None).
    Inside a pipeline stage ``mesh`` is seen along ep and tp alone
    (:func:`_manual_mesh`, the JAX manual form ``_moe(ep_axis=,
    tp_axis=)``): no token axis, the aux this microbatch's own."""
    e = cfg.n_experts
    logits = (h @ lp["router"].to(cfg.dtype)).float()        # [B, T, E]
    top_vals, top_idx = torch.topk(logits, cfg.top_k, dim=-1)
    gates = torch.softmax(top_vals, dim=-1)                  # [B, T, k]
    onehot = torch.nn.functional.one_hot(top_idx, e).float()  # [B,T,k,E]
    mask = (onehot * gates[..., None]).sum(-2)               # [B, T, E]
    axes = _moe_axes(mesh)
    h_l, mask = h, mask
    if axes:
        h_l = broadcast_replicated_grad(h, mesh, axes)
        mask = broadcast_replicated_grad(mask, mesh, axes)
    if mesh is not None and mesh.axis_size("ep") > 1:
        eg = lp["e_gate"]
        e_loc = (eg.values if isinstance(eg, QTensor) else eg).shape[0]
        lo = mesh.coord("ep") * e_loc
        mask = mask[..., lo:lo + e_loc]
    g = torch.nn.functional.silu(torch.einsum(
        "btd,edf->btef", h_l, _wt(lp["e_gate"], cfg.dtype)))
    u = torch.einsum("btd,edf->btef", h_l, _wt(lp["e_up"], cfg.dtype))
    y = torch.einsum("btef,efd->bted", g * u, _wt(lp["e_down"], cfg.dtype))
    out = torch.einsum("bted,bte->btd", y, mask.to(cfg.dtype))
    if axes:
        out = psum_replicated_grad(out, mesh, axes)
    if not want_aux:
        return out, None
    n = logits.shape[0] * logits.shape[1]
    stats = torch.cat([onehot.sum((0, 1, 2)),
                       torch.softmax(logits, dim=-1).sum((0, 1)),
                       (torch.logsumexp(logits, dim=-1) ** 2).sum()[None],
                       torch.full((1,), float(n), device=logits.device)])
    tok = token_axes(mesh)
    if tok:
        stats = all_reduce_sum_grad(stats, mesh, tok)
    count = stats[-1]
    f = stats[:e] / (count * cfg.top_k)
    aux = {"load_balance_loss": e * torch.sum(f * stats[e:2 * e] / count),
           "z_loss": stats[2 * e] / count,
           "overflow_frac": torch.zeros((), dtype=torch.float32,
                                        device=logits.device)}
    return out, aux


def _moe_switch(cfg: TransformerConfig, lp: Params, h: torch.Tensor,
                mesh=None):
    """Switch MoE (the JAX ``_moe_switch``): the tokens flattened through
    ``parallel.moe.switch_moe`` (top-k with capacity, all-to-all
    dispatch over ep; the single-device reference without an ep or tp
    axis — the same routing semantics either way).  Capacity is a
    competition over a data shard's WHOLE sequence: under sp the tokens
    are gathered over sp before routing and this rank's block cut after
    (the JAX in-spec ``P(data_axes)`` replicates them over sp), so the
    same tokens drop as in JAX.  Without ep ``switch_moe`` gathers them
    over the data axes as well (JAX routes the global batch there); over
    ep the aux metrics come back averaged over the data axes, as JAX
    pmeans them."""
    from tfmesos_tpu_torch.parallel.moe import switch_moe

    sp = 1 if mesh is None else mesh.axis_size("sp")
    if sp > 1:
        h = gather_shards(h.contiguous(), mesh, "sp", 1)
    b, t, d = h.shape
    tp_axis = "tp" if mesh is not None and mesh.axis_size("tp") > 1 \
        else None
    out, aux = switch_moe(h.reshape(b * t, d), lp["router"].to(cfg.dtype),
                          lp["e_gate"], lp["e_up"], lp["e_down"], mesh,
                          capacity_factor=cfg.capacity_factor,
                          top_k=cfg.top_k, return_aux=True, tp_axis=tp_axis)
    out = out.reshape(b, t, d)
    if sp > 1:
        tl = t // sp
        out = out[:, mesh.coord("sp") * tl:(mesh.coord("sp") + 1) * tl]
    return out, aux


def _ffn(cfg: TransformerConfig, lp: Params, h: torch.Tensor, mesh=None,
         want_aux: bool = True, ep_axis: Optional[str] = None,
         tp_axis: Optional[str] = None, inbody_ad: bool = False):
    """The block's feed-forward dispatch (the JAX ``_ffn``): the dense
    MLP, the switch MoE or the dense top-k MoE, plus the shared experts'
    always-on FFN — shared by the training and decode paths, so they
    cannot drift.  ``h`` is the normed input, whole over tp; the output
    comes back whole (each tp- or ep-cut product all-reduced once).
    Returns (out, aux), aux None for the dense MLP (and for a dense
    MoE without ``want_aux``): nothing to add to a tick's work.

    ``ep_axis`` / ``tp_axis`` select the manual forms of a pipeline
    stage's body: tokens replicated over ep and tp, experts cut over
    them, the partial outputs summed (switch through
    ``parallel.moe.switch_moe_replicated_local``: capacity a
    competition over the microbatch's tokens).  ``inbody_ad`` (the 1F1B
    step) refuses switch, as JAX does; the port's *f* / *g* carry their
    own gradients, so it changes nothing else here."""
    if ep_axis or tp_axis:
        if cfg.n_experts and cfg.moe_impl == "switch":
            if inbody_ad:
                raise ValueError(
                    "moe_impl='switch' does not support in-body AD (1F1B);"
                    " use the dense top-k MoE or pp_schedule="
                    "'gpipe'/'circular'")
            from tfmesos_tpu_torch.parallel.moe import (
                switch_moe_replicated_local)

            b, t, d = h.shape
            out, aux = switch_moe_replicated_local(
                h.reshape(b * t, d), lp["router"].to(cfg.dtype),
                lp["e_gate"], lp["e_up"], lp["e_down"], mesh,
                ep_axis=ep_axis, capacity_factor=cfg.capacity_factor,
                top_k=cfg.top_k, tp_axis=tp_axis)
            out = out.reshape(b, t, d)
            if cfg.n_shared_experts:
                sub = _manual_mesh(mesh, None, tp_axis)
                out = out + psum_replicated_grad(_qswiglu(
                    broadcast_replicated_grad(h, sub), lp["s_gate"],
                    lp["s_up"], lp["s_down"], cfg.dtype), sub)
            return out, aux
        mesh = _manual_mesh(mesh, ep_axis, tp_axis)
    if not cfg.n_experts:
        out = psum_replicated_grad(
            _mlp(cfg, lp, broadcast_replicated_grad(h, mesh)), mesh)
        return out, None
    if cfg.moe_impl == "switch":
        out, aux = _moe_switch(cfg, lp, h, mesh)
    else:
        out, aux = _moe(cfg, lp, h, mesh, want_aux)
    if cfg.n_shared_experts:
        # The shared weights replicate over ep; under tp their width is
        # cut like the dense MLP's.
        out = out + psum_replicated_grad(_qswiglu(
            broadcast_replicated_grad(h, mesh), lp["s_gate"], lp["s_up"],
            lp["s_down"], cfg.dtype), mesh)
    return out, aux


def _tp(mesh) -> int:
    return 1 if mesh is None else mesh.axis_size("tp")


def _check_tp(cfg: TransformerConfig, mesh, what: str) -> int:
    """tp of ``mesh`` after the check every tp call makes: it divides
    both head counts (the q-head -> kv-head map stays local, the JAX
    ``_check_sharded_paged`` rule).  The vocab need not divide: the
    embedding and head cut into ``sharding.block`` s, the last shorter,
    as GSPMD pads an uneven shard."""
    tp = _tp(mesh)
    if tp > 1 and (cfg.kv_heads % tp or cfg.n_heads % tp):
        raise ValueError(f"{what}: tp ({tp}) must divide kv_heads "
                         f"({cfg.kv_heads}) and n_heads ({cfg.n_heads})")
    return tp


def _pp(mesh) -> int:
    return 1 if mesh is None else mesh.axis_size("pp")


def _layer_dim(cfg: TransformerConfig, mesh):
    """The layer-stack dim's spec entry: whole, or over a pp axis the
    rank's stage (its ``pp_virtual_stages`` chunks round-robin,
    ``sharding.Interleaved``)."""
    v = cfg.pp_virtual_stages
    if _pp(mesh) == 1:
        return None
    return "pp" if v == 1 else Interleaved("pp", v)


def partition_specs(cfg: TransformerConfig, mesh) -> Dict[str, Any]:
    """The spec tree of the params (the JAX ``partition_specs``):
    Megatron tp (``wq/wk/wv/w_gate/w_up`` cut on their output columns,
    ``wo/w_down`` on their input rows, the embedding on its vocab rows
    and the head on its vocab columns), fsdp on the other dim, norms
    whole; the layer-stack dim whole, or over a pp axis cut into the
    stages (rank d: its ``pp_virtual_stages`` chunks d, d + pp, …).
    JAX keeps that dim whole in its spec and cuts it inside the
    pipeline's ``shard_map``; the port places each rank's stage only
    (ROADMAP C.3).  ``embed``, ``norm_f`` and ``head`` stay whole over
    pp.  MoE: the router over fsdp, the
    experts' ``e_*`` over ep (whole experts), fsdp and tp (each
    expert's FFN width, Megatron per expert), the shared ``s_*`` as the
    dense MLP's.  Axes of size 1 are
    dropped, so on a mesh without tp or fsdp every leaf is whole.  An
    int8 leaf's scales follow its values (``parallel.sharding``)."""
    tp = _tp(mesh)
    if tp > 1 and (cfg.kv_heads * cfg.head_dim) % tp:
        raise ValueError(
            f"partition_specs: tp ({tp}) must divide the GQA kv projection "
            f"width ({cfg.kv_heads} kv heads x {cfg.head_dim})")
    _pp_chunks(cfg, mesh)
    li = _layer_dim(cfg, mesh)
    col, row = (li, "fsdp", "tp"), (li, "tp", "fsdp")
    layers = {"attn_norm": (li, None), "wq": col, "wk": col, "wv": col,
              "wo": row, "mlp_norm": (li, None)}
    if cfg.n_experts:
        layers.update(router=(li, "fsdp", None),
                      e_gate=(li, "ep", "fsdp", "tp"),
                      e_up=(li, "ep", "fsdp", "tp"),
                      e_down=(li, "ep", "tp", "fsdp"))
        if cfg.n_shared_experts:
            layers.update(s_gate=col, s_up=col, s_down=row)
    else:
        layers.update(w_gate=col, w_up=col, w_down=row)
    tree = {
        "embed": ("tp", "fsdp"),
        "layers": layers,
        "norm_f": (None,),
        "head": ("fsdp", "tp"),
    }
    return {k: ({n: filter_spec(v, mesh) for n, v in t.items()}
                if isinstance(t, dict) else filter_spec(t, mesh))
            for k, t in tree.items()}


def _unshard(x, spec: Spec, mesh):
    """A leaf cut over fsdp, gathered whole on its fsdp dim for use
    (all-gather forward, reduce-scatter backward: the rank keeps only
    its shard of the parameter and of its gradient); other leaves pass
    through."""
    if mesh is None or mesh.axis_size("fsdp") == 1:
        return x
    for d, entry in enumerate(spec):
        if entry == "fsdp" or (isinstance(entry, tuple) and "fsdp" in entry):
            if isinstance(x, QTensor):
                return QTensor(gather_shards(x.values, mesh, "fsdp", d),
                               x.scales if x.scales.shape[d] == 1 else
                               gather_shards(x.scales, mesh, "fsdp", d))
            return gather_shards(x, mesh, "fsdp", d)
    return x


def _layer(params: Params, li: int, mesh=None,
           specs: Optional[Dict[str, Any]] = None) -> Params:
    """Layer ``li``'s leaves ready for use: :func:`layer_params`, with
    fsdp shards gathered whole (``specs`` the layers' partition specs)."""
    lp = layer_params(params, li)
    if specs is None or mesh is None or mesh.axis_size("fsdp") == 1:
        return lp
    return {k: _unshard(v, specs[k][1:], mesh) for k, v in lp.items()}


def _qkv(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
         positions: torch.Tensor, mesh=None):
    """Attention-norm, the q/k/v projections and rope.  Under tp the
    projections are this rank's column blocks: its n_heads/tp query and
    kv_heads/tp kv heads, the normed input fanned out through Megatron's
    *f* (its gradient all-reduced over tp)."""
    b, t, _ = x.shape
    tp = _tp(mesh)
    h = broadcast_replicated_grad(
        rms_norm(x, lp["attn_norm"].to(cfg.dtype)), mesh)
    q = _qmm(h, lp["wq"], cfg.dtype).reshape(b, t, cfg.n_heads // tp,
                                             cfg.head_dim)
    k = _qmm(h, lp["wk"], cfg.dtype).reshape(b, t, cfg.kv_heads // tp,
                                             cfg.head_dim)
    v = _qmm(h, lp["wv"], cfg.dtype).reshape(b, t, cfg.kv_heads // tp,
                                             cfg.head_dim)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _finish_block(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
                  o: torch.Tensor, mesh=None, want_aux: bool = True):
    """Output projection, residual, MLP-norm, the feed-forward dispatch
    (:func:`_ffn`), residual; returns (x, aux).  Under tp ``wo`` is a
    row block whose partial product is all-reduced once (Megatron's
    *g*), as is the dense MLP's ``w_down``, whose input fans out through
    *f*."""
    b, t, _ = x.shape
    x = x + psum_replicated_grad(_qmm(o.reshape(b, t, -1), lp["wo"],
                                      cfg.dtype), mesh)
    ffn, aux = _ffn(cfg, lp, rms_norm(x, lp["mlp_norm"].to(cfg.dtype)),
                    mesh, want_aux)
    return x + ffn, aux


def _block(cfg: TransformerConfig, x: torch.Tensor, lp: Params,
           positions: torch.Tensor, mesh=None,
           ep_axis: Optional[str] = None, sp_axis: Optional[str] = None,
           inbody_ad: bool = False):
    """One transformer block over a full sequence (causal attention;
    over sp, the ring or Ulysses through ``attend``); returns (x,
    aux).

    ``ep_axis`` / ``sp_axis``: the block inside a pipeline stage (the
    JAX ``_block(ep_axis=, sp_axis=, inbody_ad=)``): whole heads, the
    experts cut over ``ep_axis`` (:func:`_ffn`'s manual form), and with
    ``sp_axis`` the sequence cut over it (``positions`` global) and
    attended by :func:`_sp_attend`; without either axis a stage runs
    the plain block (``mesh`` None)."""
    if ep_axis is None and sp_axis is None:
        q, k, v = _qkv(cfg, lp, x, positions, mesh)
        o = attend(q, k, v, mesh, causal=True, sp_impl=cfg.sp_impl,
                   window=cfg.window)
        return _finish_block(cfg, lp, x, o, mesh)
    b, t, _ = x.shape
    q, k, v = _qkv(cfg, lp, x, positions)
    if sp_axis is not None:
        o = _sp_attend(cfg, q, k, v, mesh, sp_axis, inbody_ad)
    else:
        o = attend(q, k, v, None, causal=True, window=cfg.window)
    x = x + _qmm(o.reshape(b, t, -1), lp["wo"], cfg.dtype)
    ffn, aux = _ffn(cfg, lp, rms_norm(x, lp["mlp_norm"].to(cfg.dtype)),
                    mesh if ep_axis else None, ep_axis=ep_axis,
                    inbody_ad=inbody_ad)
    return x + ffn, aux


def _block_manual_tp(cfg: TransformerConfig, x: torch.Tensor, lp: Params,
                     positions: torch.Tensor, mesh, tp_axis: str = "tp",
                     ep_axis: Optional[str] = None, inbody_ad: bool = False,
                     sp_axis: Optional[str] = None):
    """The Megatron block inside a pipeline stage (the JAX
    ``_block_manual_tp``): ``lp`` this rank's tp blocks (q/k/v on their
    output columns, ``wo`` on its input rows, the FFN widths), the
    normed input fanned out through *f* and each row-parallel product
    summed through *g* over ``tp_axis``; with experts the FFN half is
    :func:`_ffn`'s manual form over ep and tp, with ``sp_axis`` the
    attention :func:`_sp_attend`'s on the local heads.  Returns (x,
    aux)."""
    b, t, _ = x.shape
    tpm = mesh.only(tp_axis)
    q, k, v = _qkv(cfg, lp, x, positions, tpm)
    if sp_axis is not None:
        o = _sp_attend(cfg, q, k, v, mesh, sp_axis, inbody_ad)
    else:
        o = attend(q, k, v, None, causal=True, window=cfg.window)
    x = x + psum_replicated_grad(_qmm(o.reshape(b, t, -1), lp["wo"],
                                      cfg.dtype), tpm)
    ffn, aux = _ffn(cfg, lp, rms_norm(x, lp["mlp_norm"].to(cfg.dtype)),
                    mesh, ep_axis=ep_axis, tp_axis=tp_axis,
                    inbody_ad=inbody_ad)
    return x + ffn, aux


def _sp_gather_attention(cfg: TransformerConfig, q: torch.Tensor,
                         k: torch.Tensor, v: torch.Tensor, mesh,
                         axis: str) -> torch.Tensor:
    """Sequence-parallel attention by K/V all-gather (the JAX
    ``_sp_gather_attention``, the 1F1B step's form): the local query
    shard attends the WHOLE gathered sequence with global-position
    masks, in float32.  The narrow (kv-width) K/V are gathered and the
    GQA groups broadcast after; the gather's backward sums each rank's
    dK/dV over the axis and keeps this rank's block."""
    scale = 1.0 / math.sqrt(cfg.head_dim)
    tq = q.shape[1]
    kg = gather_shards(k.contiguous(), mesh, axis, 1)      # [B, T, KV, D]
    vg = gather_shards(v.contiguous(), mesh, axis, 1)
    g = q.shape[2] // kg.shape[2]
    if g > 1:
        kg = kg.repeat_interleave(g, dim=2)
        vg = vg.repeat_interleave(g, dim=2)
    tk = kg.shape[1]
    qpos = mesh.coord(axis) * tq + torch.arange(tq, device=q.device)[:, None]
    kpos = torch.arange(tk, device=q.device)[None, :]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kg.float())
    bad = kpos > qpos
    if cfg.window is not None:
        bad = bad | (kpos < qpos - (cfg.window - 1))
    s = s.masked_fill(bad, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vg.float()).to(q.dtype)


def _sp_attend(cfg: TransformerConfig, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, mesh, sp_axis: str,
               inbody_ad: bool) -> torch.Tensor:
    """A stage body's sequence-parallel attention (the JAX
    ``_sp_attend``; q/k/v may be tp-local heads): the K/V-gather form
    under ``inbody_ad`` (the 1F1B step), else the einsum ring
    (``ring_attention_local``), GQA broadcast before its hops."""
    if inbody_ad:
        return _sp_gather_attention(cfg, q, k, v, mesh, sp_axis)
    from tfmesos_tpu_torch.parallel.ring_attention import \
        ring_attention_local

    g = q.shape[2] // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return ring_attention_local(q, k, v, mesh, axis=sp_axis, causal=True,
                                window=cfg.window)


def _embed(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
           mesh=None, specs=None) -> torch.Tensor:
    """The embedding lookup.  Under tp the table is this rank's vocab
    rows: ids outside them are masked (a rank never gathers outside its
    own range) and the rows all-reduced over tp, one rank holding each
    id's row."""
    table = params["embed"]
    if specs is not None:
        table = _unshard(table, specs["embed"], mesh)
    tp = _tp(mesh)
    if tp == 1:
        return _embed_lookup(table, tokens, cfg.dtype)
    rows = (table.values if isinstance(table, QTensor) else table).shape[0]
    local = tokens - mesh.coord("tp") * block(cfg.vocab_size, tp)
    ok = (local >= 0) & (local < rows)
    x = _embed_lookup(table, local.clamp(0, max(rows - 1, 0)), cfg.dtype)
    x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
    return psum_replicated_grad(x, mesh)


class _GatherVocab(torch.autograd.Function):
    """The vocab-cut logits [..., V/tp] gathered whole ([..., V]) over
    tp, each rank's block padded to the full block for the gather; the
    backward keeps this rank's columns of the (tp-replicated)
    gradient."""

    @staticmethod
    def forward(ctx, x, mesh, vocab):
        from tfmesos_tpu_torch.parallel.collectives import all_gather

        b = block(vocab, mesh.axis_size("tp"))
        ctx.lo, ctx.width = mesh.coord("tp") * b, x.shape[-1]
        if x.shape[-1] < b:
            x = torch.nn.functional.pad(x, (0, b - x.shape[-1]))
        return all_gather(x, mesh, "tp", dim=x.dim() - 1)[..., :vocab]

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.lo + ctx.width], None, None


def _logits(cfg: TransformerConfig, params: Params, x: torch.Tensor,
            mesh=None, specs=None) -> torch.Tensor:
    """The head over final hidden states: whole logits [..., V] (under
    tp each rank's vocab columns, gathered)."""
    head = params["head"]
    if specs is not None:
        head = _unshard(head, specs["head"], mesh)
    if _tp(mesh) == 1:
        return _qmm(x, head, cfg.dtype)
    x = broadcast_replicated_grad(x, mesh)
    return _GatherVocab.apply(_qmm(x, head, cfg.dtype), mesh,
                              cfg.vocab_size)


def _pp_chunks(cfg: TransformerConfig, mesh) -> int:
    """The pipeline's chunk count over ``mesh`` (pp x virtual stages),
    after JAX's check that the layers divide into them."""
    n_chunks = _pp(mesh) * cfg.pp_virtual_stages
    if _pp(mesh) > 1 and cfg.n_layers % n_chunks:
        raise ValueError(f"{cfg.n_layers} layers not divisible into "
                         f"{n_chunks} pipeline chunks")
    return n_chunks


def _pipeline_trunk(cfg: TransformerConfig, params: Params,
                    x: torch.Tensor, mesh, specs):
    """The layer stack over a pp mesh (the JAX ``forward_hidden`` pp
    branch ``:642-735``): the rank's layers [v·per, ...] seen as its v
    chunks of ``per`` layers, run by ``parallel.pipeline.pipeline_apply``
    on ``cfg.pp_schedule`` with pp microbatches.  A stage's body is the
    block in JAX's in-stage forms (:func:`_block_manual_tp` with tp,
    :func:`_block` with the ep and sp axes), each layer's fsdp shards
    gathered as it runs, each block checkpointed under ``cfg.remat``.
    ``x`` is the embedded input: over sp the rank's sequence shard (the
    stages attend across shards) — or, for switch MoE, whose capacity
    is a competition over the whole sequence, the whole sequence.
    Returns (the last stage's output on every pp rank, the router aux
    averaged over chunks x microbatches x data shards)."""
    from tfmesos_tpu_torch.parallel.pipeline import pipeline_apply

    v = cfg.pp_virtual_stages
    per = cfg.n_layers // _pp_chunks(cfg, mesh)
    tp = _tp(mesh)
    ep_axis = "ep" if cfg.n_experts and mesh.axis_size("ep") > 1 else None
    sp_axis = "sp" if _seq_in_stages(cfg, mesh) else None
    lspecs = specs["layers"]
    fsdp = mesh.axis_size("fsdp") > 1

    def block(h, cp, i, pos):
        lp = {k: w[i] for k, w in cp.items()}
        if fsdp:
            lp = {k: _unshard(w, lspecs[k][1:], mesh) for k, w in lp.items()}
        if tp > 1:
            h, aux = _block_manual_tp(cfg, h, lp, pos, mesh,
                                      ep_axis=ep_axis, sp_axis=sp_axis)
        else:
            h, aux = _block(cfg, h, lp, pos,
                            mesh if ep_axis or sp_axis else None,
                            ep_axis=ep_axis, sp_axis=sp_axis)
        return (h,) + (() if aux is None else
                       tuple(aux[k] for k in AUX_KEYS))

    def stage_fn(cp, h):
        b, t = h.shape[:2]
        start = mesh.coord("sp") * t if sp_axis else 0
        pos = (start + torch.arange(t, device=h.device)).expand(b, t)
        sums = None
        for i in range(per):
            if cfg.remat:
                h, *aux = torch.utils.checkpoint.checkpoint(
                    block, h, cp, i, pos, use_reentrant=False)
            else:
                h, *aux = block(h, cp, i, pos)
            if aux:
                sums = aux if sums is None else [a + b_
                                                 for a, b_ in zip(sums, aux)]
        if not cfg.n_experts:
            return h
        return h, {k: a / per for k, a in zip(AUX_KEYS, sums)}

    stacked = {k: w.unflatten(0, (v, per))
               for k, w in params["layers"].items()}
    out = pipeline_apply(stage_fn, stacked, x, mesh,
                         schedule=cfg.pp_schedule, virtual_stages=v,
                         with_aux=AUX_KEYS if cfg.n_experts else False,
                         seq_axis=sp_axis)
    if cfg.n_experts:
        return out
    return out, _zero_aux(x.device)


def _seq_in_stages(cfg: TransformerConfig, mesh) -> bool:
    """Whether a pp mesh's stages see the sequence cut over sp (JAX's
    rule: not for switch MoE, whose capacity drops tokens in a
    competition over the whole sequence; the port's batches always cut
    T over sp evenly, ``sharding.seq_window``)."""
    return mesh.axis_size("sp") > 1 and not (
        cfg.n_experts and cfg.moe_impl == "switch")


def _check_pp(cfg: TransformerConfig, mesh) -> None:
    """JAX's pp-branch checks, before the partition specs' own."""
    if _pp(mesh) == 1:
        return
    _pp_chunks(cfg, mesh)
    tp = _tp(mesh)
    if tp > 1 and cfg.kv_heads % tp:
        raise ValueError(
            f"pp x tp needs tp ({tp}) to divide kv_heads "
            f"({cfg.kv_heads}) so the local head grouping stays "
            f"aligned; lower tp or raise kv_heads")


def _specs(cfg: TransformerConfig, mesh):
    """The partition specs ``params`` are cut by on ``mesh`` (None
    without one)."""
    if mesh is None:
        return None
    _check_pp(cfg, mesh)
    _check_tp(cfg, mesh, "forward")
    return partition_specs(cfg, mesh)


def forward_hidden(cfg: TransformerConfig, params: Params,
                   tokens: torch.Tensor, mesh=None):
    """tokens [B, T] -> (final-norm hidden states [B, T, d], the router
    aux metrics averaged over the layers; zeros without experts).  With
    ``cfg.remat`` each block is a non-reentrant activation checkpoint:
    the backward re-runs its forward (attention kernel included) from
    the block's input, as ``jax.checkpoint`` does in the reference.

    ``mesh`` (a ``parallel.mesh.RankMesh``): ``params`` are this rank's
    blocks per :func:`partition_specs` and ``tokens`` its share of the
    batch; tp runs each block Megatron-style (:func:`_qkv`,
    :func:`_finish_block`) and fsdp gathers each layer's shards whole
    just before it runs (a remat block gathers again in its backward).
    Over sp ``tokens`` are this rank's block of the sequence: the
    embedding and rope run at GLOBAL positions (the rank's offset
    ``coord("sp") · T``).  The hidden states are whole on every tp and
    ep rank.  Over pp the layers run as a pipeline
    (:func:`_pipeline_trunk`) and the output is the last stage's, on
    every pp rank."""
    b, t = tokens.shape
    specs = _specs(cfg, mesh)
    if _pp(mesh) > 1:
        sp = mesh.axis_size("sp")
        whole = sp > 1 and not _seq_in_stages(cfg, mesh)
        if whole:
            from tfmesos_tpu_torch.parallel.collectives import all_gather

            tokens = all_gather(tokens.contiguous(), mesh, "sp", 1)
        x, aux = _pipeline_trunk(cfg, params, _embed(cfg, params, tokens,
                                                     mesh, specs),
                                 mesh, specs)
        if whole:
            x = x[:, mesh.coord("sp") * t:(mesh.coord("sp") + 1) * t]
        return rms_norm(x, params["norm_f"].to(cfg.dtype)), aux
    x = _embed(cfg, params, tokens, mesh, specs)
    start = 0 if mesh is None else mesh.coord("sp") * t
    positions = (start + torch.arange(t, device=tokens.device)).expand(b, t)
    lspecs = None if specs is None else specs["layers"]

    def block(x_, li):
        x_, aux = _block(cfg, x_, _layer(params, li, mesh, lspecs),
                         positions, mesh)
        return (x_,) + (() if aux is None else
                        tuple(aux[k] for k in AUX_KEYS))

    sums = None
    for li in range(cfg.n_layers):
        if cfg.remat:
            x, *aux = torch.utils.checkpoint.checkpoint(
                block, x, li, use_reentrant=False)
        else:
            x, *aux = block(x, li)
        if aux:
            sums = aux if sums is None else [a + b
                                             for a, b in zip(sums, aux)]
    aux = (_zero_aux(tokens.device) if sums is None else
           {k: v / cfg.n_layers for k, v in zip(AUX_KEYS, sums)})
    return rms_norm(x, params["norm_f"].to(cfg.dtype)), aux


def forward(cfg: TransformerConfig, params: Params,
            tokens: torch.Tensor, mesh=None, return_aux: bool = False):
    """tokens [B, T] -> logits [B, T, V] in the compute dtype (whole on
    every tp rank of a ``mesh``), with the per-layer-averaged router aux
    metrics when ``return_aux``."""
    x, aux = forward_hidden(cfg, params, tokens, mesh)
    logits = _logits(cfg, params, x, mesh, _specs(cfg, mesh))
    return (logits, aux) if return_aux else logits


def _fused_ce_mode(cfg: TransformerConfig, params: Optional[Params] = None,
                   mesh=None) -> Optional[str]:
    """Which head + cross-entropy path :func:`loss_fn` takes (the JAX
    ``_fused_ce_mode``): ``"dense"`` (the fused, chunked form) on one
    rank, ``"dp"`` on a mesh of data axes only, ``"tp"`` (vocab
    parallel) on one with tp, or None (materialize the logits) when
    ``cfg.fused_ce`` is False or the head is an int8 :class:`QTensor`
    (a serving tree)."""
    if cfg.fused_ce is False or (params is not None
                                 and isinstance(params["head"], QTensor)):
        return None
    if mesh is None or mesh.size() == 1:
        return "dense"
    return "tp" if _tp(mesh) > 1 else "dp"


def loss_fn(cfg: TransformerConfig, params: Params,
            batch: Dict[str, torch.Tensor], mesh=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token prediction: ``batch = {"tokens": [B, T+1]}`` ->
    ``(loss, metrics)``, loss the float32 mean cross entropy of
    positions 1..T given 0..T-1 and ``metrics`` its perplexity.  With
    experts the router's losses join the objective
    (``router_aux_weight · load_balance_loss + router_z_weight ·
    z_loss``) and the metrics carry ``load_balance_loss``,
    ``router_z_loss`` and ``moe_overflow_frac`` (the JAX ``loss_fn``).

    On a ``mesh`` the batch is this rank's share (over sp its window of
    the sequence, ``sharding.seq_window``) and the loss the GLOBAL
    batch's mean on every rank (its gradient is the rank's own share's:
    the train step averages the gradients over the data axes and sp),
    through ``data_parallel_fused_cross_entropy`` without tp or
    ``vocab_parallel_cross_entropy`` with it, as ``cfg.fused_ce`` says;
    z-loss on every path."""
    from tfmesos_tpu_torch.ops.layers import (
        data_mean, data_parallel_fused_cross_entropy,
        vocab_parallel_cross_entropy)

    tokens = batch["tokens"]
    labels = tokens[:, 1:].long()
    mode = _fused_ce_mode(cfg, params, mesh)
    specs = _specs(cfg, mesh)
    if mode is None:
        logits, aux = forward(cfg, params, tokens[:, :-1], mesh,
                              return_aux=True)
        loss = data_mean(cross_entropy_loss(logits, labels,
                                            z_loss=cfg.z_loss), mesh)
    else:
        x, aux = forward_hidden(cfg, params, tokens[:, :-1], mesh)
        # The master-dtype head: the op computes in x's dtype and
        # accumulates dw in float32 at the param dtype.
        head = params["head"] if specs is None else _unshard(
            params["head"], specs["head"], mesh)
        if mode == "tp":
            loss = vocab_parallel_cross_entropy(x, head, labels, mesh,
                                                z_loss=cfg.z_loss,
                                                chunk=cfg.ce_chunk,
                                                vocab=cfg.vocab_size)
        elif mode == "dp":
            loss = data_parallel_fused_cross_entropy(x, head, labels, mesh,
                                                     cfg.z_loss,
                                                     cfg.ce_chunk)
        else:
            loss = fused_linear_cross_entropy(x, head, labels,
                                              z_loss=cfg.z_loss,
                                              chunk=cfg.ce_chunk)
    metrics = {"perplexity": torch.exp(loss)}
    if cfg.n_experts:
        loss = (loss + cfg.router_aux_weight * aux["load_balance_loss"]
                + cfg.router_z_weight * aux["z_loss"])
        metrics.update(load_balance_loss=aux["load_balance_loss"],
                       router_z_loss=aux["z_loss"],
                       moe_overflow_frac=aux["overflow_frac"])
    return loss, metrics


def _fsdp_entries(spec: Spec, also: Tuple[str, ...] = ()) -> Spec:
    """``spec`` with only its fsdp entries (and those of ``also``)."""
    keep = {"fsdp", *also}
    return tuple(e if isinstance(e, str) and e in keep else None
                 for e in spec)


def train_step_1f1b(cfg: TransformerConfig, params: Params,
                    batch: Dict[str, torch.Tensor], mesh,
                    num_microbatches: Optional[int] = None):
    """One fused 1F1B forward+backward pass of the LM objective on a pp
    mesh (the JAX ``train_step_1f1b``): returns ``(loss, grads)``,
    ``grads`` float32 in ``params``' structure — this rank's blocks per
    :func:`partition_specs`, each the GLOBAL batch's gradient (averaged
    over the data axes already, never over pp).

    ``parallel.pipeline.pipeline_train_1f1b`` runs the layers: a
    stage's body is :func:`_block_manual_tp` under tp and :func:`_block`
    otherwise, in their in-body forms (sp attention by K/V gather, the
    stage's weights fanned over sp through *f*); MoE stages (dense top-k
    only) carry their layers' router terms, normalized by ``n_layers``,
    as a stage aux seeded with the loss's 1/m.  The embedding is
    differentiated through the returned dx (its gradient summed over
    the ranks of distinct tokens); the final norm and the head ride as
    tail params of the loss stage: under tp the vocab-parallel CE
    (``ops.layers.vocab_parallel_cross_entropy`` on the tp axis alone,
    the JAX ``vocab_parallel_ce_inbody``'s math), a vocab that does not
    divide over tp the fused CE on the whole head.  Leaves cut over fsdp
    are gathered whole for the step and their gradients cut back, as
    GSPMD gathers them at the JAX ``shard_map``'s edge."""
    from tfmesos_tpu_torch.ops.layers import vocab_parallel_cross_entropy
    from tfmesos_tpu_torch.parallel.collectives import all_reduce_sum
    from tfmesos_tpu_torch.parallel.pipeline import pipeline_train_1f1b
    from tfmesos_tpu_torch.parallel.sharding import cut, uncut

    pp, tp = _pp(mesh), _tp(mesh)
    ep, sp = mesh.axis_size("ep"), mesh.axis_size("sp")
    if tp > 1 and cfg.kv_heads % tp:
        raise ValueError(f"1f1b x tp needs tp ({tp}) to divide kv_heads "
                         f"({cfg.kv_heads})")
    if tp > 1 and cfg.d_ff % tp:
        raise ValueError(f"1f1b x tp needs tp ({tp}) to divide d_ff "
                         f"({cfg.d_ff}) for the Megatron FFN split")
    if ep > 1 and not cfg.n_experts:
        raise ValueError("an ep axis needs n_experts > 0")
    if cfg.n_experts and cfg.n_experts % max(ep, 1):
        raise ValueError(f"ep ({ep}) must divide n_experts "
                         f"({cfg.n_experts})")
    if cfg.n_experts and cfg.moe_impl == "switch":
        raise ValueError("train_step_1f1b runs the dense top-k MoE "
                         "(moe_impl='switch' assumes outer "
                         "differentiation); use pp_schedule="
                         "'gpipe'/'circular' for switch dispatch")
    v = cfg.pp_virtual_stages
    if v > 1 and pp < 2:
        raise ValueError("pp_virtual_stages > 1 needs a real pp axis")
    n_chunks = max(pp, 1) * v
    if cfg.n_layers % n_chunks:
        raise ValueError(f"{cfg.n_layers} layers not divisible into "
                         f"{n_chunks} pipeline chunks "
                         f"({pp} stages x {v} virtual)")
    specs = partition_specs(cfg, mesh)
    per = cfg.n_layers // n_chunks
    ep_axis = "ep" if cfg.n_experts and ep > 1 else None
    sp_axis = "sp" if sp > 1 else None
    vocab_parallel_tail = tp > 1 and cfg.vocab_size % tp == 0
    # What each leaf is gathered over for the step (and its gradient
    # cut back over): fsdp, and tp for a head the replicated tail uses.
    gather = {"embed": _fsdp_entries(specs["embed"]),
              "norm_f": specs["norm_f"],
              "head": _fsdp_entries(specs["head"],
                                    () if vocab_parallel_tail else ("tp",)),
              "layers": {k: _fsdp_entries(s_)
                         for k, s_ in specs["layers"].items()}}

    def whole(w, spec):
        return uncut(w.detach(), spec, mesh)

    stage_aux = bool(cfg.n_experts)
    inbody = ep_axis is not None or sp_axis is not None

    def block(h, cp, i, pos):
        lp = {k: w[i] for k, w in cp.items()}
        if tp > 1:
            return _block_manual_tp(cfg, h, lp, pos, mesh, ep_axis=ep_axis,
                                    inbody_ad=True, sp_axis=sp_axis)
        return _block(cfg, h, lp, pos, mesh if inbody else None,
                      ep_axis=ep_axis, sp_axis=sp_axis, inbody_ad=inbody)

    def stage_fn(cp, h):
        if sp_axis is not None:
            # Weights whole over sp, used by each shard's own tokens:
            # *f* sums their gradients over sp.
            cp = {k: broadcast_replicated_grad(w, mesh, "sp")
                  for k, w in cp.items()}
        b, t = h.shape[:2]
        start = mesh.coord("sp") * t if sp_axis else 0
        pos = (start + torch.arange(t, device=h.device)).expand(b, t)
        lb = z = 0.0
        for i in range(per):
            if cfg.remat:
                h, aux = torch.utils.checkpoint.checkpoint(
                    block, h, cp, i, pos, use_reentrant=False)
            else:
                h, aux = block(h, cp, i, pos)
            if stage_aux:
                lb = lb + aux["load_balance_loss"]
                z = z + aux["z_loss"]
        if not stage_aux:
            return h
        aux = (cfg.router_aux_weight * lb
               + cfg.router_z_weight * z) / cfg.n_layers
        if sp_axis is not None:
            aux = psum_replicated_grad(aux, mesh, "sp") / sp
        return h, aux.float()

    def tail_loss(tail, h, tgt_mb):
        if sp_axis is not None:
            tail = {k: broadcast_replicated_grad(w, mesh, "sp")
                    for k, w in tail.items()}
        x = rms_norm(h, tail["norm_f"].to(cfg.dtype))
        if vocab_parallel_tail:
            loss = vocab_parallel_cross_entropy(
                x, tail["head"], tgt_mb, mesh.only("tp"),
                z_loss=cfg.z_loss, chunk=cfg.ce_chunk, vocab=cfg.vocab_size)
        else:
            loss = fused_linear_cross_entropy(x, tail["head"], tgt_mb,
                                              z_loss=cfg.z_loss,
                                              chunk=cfg.ce_chunk)
        if sp_axis is not None:
            loss = psum_replicated_grad(loss, mesh, "sp") / sp
        return loss

    tokens = batch["tokens"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:].long()
    embed = whole(params["embed"], gather["embed"]).requires_grad_(True)
    with torch.enable_grad():
        x = _embed(cfg, {"embed": embed}, inp, mesh)
    stacked = {k: whole(w, gather["layers"][k]).unflatten(0, (v, per))
               for k, w in params["layers"].items()}
    tail = {k: whole(params[k], gather[k]) for k in ("norm_f", "head")}
    loss, g_stacked, g_tail, dx = pipeline_train_1f1b(
        stage_fn, tail_loss, stacked, x.detach(), tgt, mesh,
        num_microbatches=num_microbatches, tail_params=tail,
        stage_aux=stage_aux, virtual_stages=v)
    (g_embed,) = torch.autograd.grad(x, embed, dx.to(x.dtype))
    # dx is each rank's tokens' share of the global gradient: the
    # embedding's is the sum over the ranks of distinct tokens.
    g_embed = all_reduce_sum(g_embed.float(), mesh, token_axes(mesh) or ())
    back = lambda g, spec: cut(g, spec, mesh).contiguous()  # noqa: E731
    grads = {
        "embed": back(g_embed, gather["embed"]),
        "layers": {k: back(g_stacked[k].flatten(0, 1), gather["layers"][k])
                   for k in params["layers"]},
        "norm_f": g_tail["norm_f"],
        "head": back(g_tail["head"], gather["head"]),
    }
    return loss, {k: grads[k] for k in params}


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
               device: Union[str, torch.device] = "cpu", mesh=None
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
    long generation runs.

    On a ``mesh`` the buffers are this rank's block of
    :func:`cache_specs`: ``batch`` (the global batch) over the data axes
    and the kv heads over tp."""
    if cfg.window is not None:
        max_len = min(max_len, cfg.window)
    batch, kv = _local_dims(cfg, mesh, batch, "init_cache")
    shape = (cfg.n_layers, batch, kv, max_len, cfg.head_dim)
    return {name: _kv_buffer(shape, dtype, quantized, cfg, device,
                             "init_cache") for name in ("k", "v")}


def init_paged_cache(cfg: TransformerConfig, n_pages: int,
                     page_size: int = 128,
                     dtype: Optional[torch.dtype] = None,
                     quantized: bool = False,
                     device: Union[str, torch.device] = "cpu", mesh=None
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
    n_pages, kv = _local_dims(cfg, mesh, n_pages, "init_paged_cache")
    shape = (cfg.n_layers, n_pages, kv, page_size, cfg.head_dim)
    return {name: _kv_buffer(shape, dtype, quantized, cfg, device,
                             "init_paged_cache") for name in ("k", "v")}


def cache_specs(cfg: TransformerConfig, mesh) -> Dict[str, Spec]:
    """Specs of a linear cache [L, B, KV, M, Dh] (the JAX
    ``cache_specs``): the batch over the data axes, the kv heads over tp
    (which must divide them).  An int8 cache's lane-major scales
    [L, B, KV, 1, M] take the same spec."""
    _check_tp(cfg, mesh, "cache_specs")
    spec = filter_spec((None, data_axes(mesh), "tp", None, None), mesh)
    return {"k": spec, "v": spec}


def paged_cache_specs(cfg: TransformerConfig, mesh) -> Dict[str, Spec]:
    """Specs of a paged pool [L, P, KV, page, Dh] (the JAX
    ``paged_cache_specs``): the pages over the data axes (each data
    shard a sub-pool indexed with shard-local ids), the kv heads over
    tp."""
    _check_tp(cfg, mesh, "paged_cache_specs")
    spec = filter_spec((None, data_axes(mesh), "tp", None, None), mesh)
    return {"k": spec, "v": spec}


def _local_dims(cfg: TransformerConfig, mesh, n: int, what: str
                ) -> Tuple[int, int]:
    """(this rank's share of ``n`` over the data axes, its kv heads)."""
    if mesh is None:
        return n, cfg.kv_heads
    tp = _check_tp(cfg, mesh, what)
    nd = mesh.axis_size(data_axes(mesh) or ())
    if n % nd:
        raise ValueError(f"{what}: {n} must divide over the mesh data "
                         f"axes ({nd})")
    return n // nd, cfg.kv_heads // tp


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
                  pos: Union[int, torch.Tensor], mesh=None):
    """One block over a token chunk with cached history.  A multi-token
    chunk at python-int ``pos == 0`` is a prefill from an empty cache and
    attends only to itself.  A LINEAR cache (no ``"pages"``) is written
    first and then attended through ``flash_decode``; a PAGED pool is
    NOT written here: other chunks attend the committed pool plus
    themselves through the deferred ``self_kv`` operand, and the chunk's
    K/V comes back for :func:`decode_step`'s single commit.  Under tp
    the chunk's heads and the cache's are this rank's; the write and the
    attention run with no collective between them (the JAX island), the
    reduction staying at ``wo``."""
    t = x.shape[1]
    q, k, v = _qkv(cfg, lp, x, positions, mesh)
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
    return _finish_block(cfg, lp, x, o, mesh, want_aux=False)[0], chunk


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


def _check_serving_mesh(mesh) -> None:
    """Decode runs on data (dp/fsdp) x tp meshes, as in JAX
    (``_check_sharded_paged``): a pp, sp or ep mesh is refused with its
    message."""
    if mesh is None:
        return
    real = {a for a, n in mesh.axes.items() if n > 1}
    if not real <= {"dp", "fsdp", "tp"}:
        raise ValueError(f"sharded paged decode runs on data (dp/fsdp) x "
                         f"tp meshes; got axes {sorted(real)}")


def decode_step(cfg: TransformerConfig, params: Params,
                cache: Dict[str, Any], tokens: torch.Tensor,
                pos: Union[int, torch.Tensor], mesh=None):
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
    buffers update IN PLACE.

    ``mesh`` (the JAX ``decode_step(sharded=True, mesh=)``): ``params``
    are this rank's blocks per :func:`partition_specs`, ``cache`` its
    block per :func:`cache_specs` / :func:`paged_cache_specs` (a paged
    table holding shard-local page ids), ``tokens`` and ``pos`` its rows.
    Each block runs Megatron tp with the kernels at this rank's heads;
    the logits come back whole over the vocab on every tp rank."""
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
    _check_serving_mesh(mesh)
    specs = _specs(cfg, mesh)
    lspecs = None if specs is None else specs["layers"]
    x = _embed(cfg, params, tokens, mesh, specs)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for li in range(cfg.n_layers):
        x, chunk = _block_decode(cfg, x, _layer(params, li, mesh, lspecs),
                                 cache, li, positions, pos, mesh)
        if chunk is not None:
            ks.append(chunk[0])
            vs.append(chunk[1])
    if ks:
        _paged_cache_write_all(cache, ks, vs, positions[:, 0])
    x = rms_norm(x, params["norm_f"].to(cfg.dtype))
    return _logits(cfg, params, x, mesh, specs), cache


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
    continuation whatever the draft proposes on the CPU (float32), where
    ``tests/test_torch_speculative.py`` and
    ``tests/test_torch_spec_batcher.py`` hold it to JAX token for token;
    on the card the (k+1)-token verify rounds its bf16 GEMMs otherwise
    than a one-token step does, so a stream may first differ from
    ``generate``'s at a near-tie, within the 0.25 logit margin rule of
    ``chip_smoke.py`` phase 20.  Sampled: Leviathan
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
