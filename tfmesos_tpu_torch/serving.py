"""Continuous batching over the paged KV cache (port of
``tfmesos_tpu/serving.py``: the bypass registry ``:75-183``, ``Request``
/ ``Prefilled`` / the artifact packing / ``Completion`` / ``Suspended``
/ ``Expired`` / ``_Row`` ``:186-525``, ``_PagedSide`` ``:603-776``, the
prefix cache ``:779-1196``, the ``ContinuousBatcher`` loop and
admission ``:2499-2700, 3799-4445``, chunked prefill ``:2389-2410,
4398-4443``, warmup ``:2722``, KV export/import ``:2930-3382``, the
schedule modes — the K-step block, overlap, the pipeline and the fused
prefill tick — ``:2116-2197, 2412-2470, 4445-4751``, deadlines and
preemption ``:4909-5043``, the KV tier's prefix spill/promote and
session park/resume ``:857-866, 1097-1138, 1703-1727, 3040-3100,
3383-3791, 4018-4060``, the static ``prefix`` ``:2040-2090, 4188-4209``,
speculative decoding ``:1958-1969, 2199-2388, 4753-4906`` and the
weight swaps ``:1798-1940``).

A persistent page pool plus an admission loop that feeds new prompts
into a RUNNING batched decode: rows free on stop token or quota,
arrivals prefill into freed rows, and the allocator's state persists
across the whole stream.  Admission reserves each request's WORST-CASE
page count against the pool up front while pages are backed
incrementally as the row grows, so memory use tracks live tokens and
mid-flight pool exhaustion is impossible by construction.

Streams are the JAX batcher's: the same admission order, padding
buckets, page tables (inactive rows write to a reserved sink page) and
argmax, or with ``temperature > 0`` the same draws (each row's key is
``fold_in(fold_in(rng, rid), step)``, threefry in ``ops/prng.py``).
The fleet surface is the reference's too: chunked prefill
(``prefill_chunk``), the cross-request prefix cache
(``prefix_cache_pages``), disaggregated KV export/import with artifacts
either side can read (:func:`pack_prefilled`), priority preemption with
the :meth:`ContinuousBatcher.preempt_all` drain, deadlines, the KV
tier (``kv_tier``: spilled prefix pages and parked sessions), a static
shared ``prefix``, speculative decoding with a draft model, and online
weight swaps (:meth:`ContinuousBatcher.swap_adapter`,
:meth:`ContinuousBatcher.set_weights`).

On the card every device call is a CUDA graph (``graphs.py``): the
admission prefill a prompt width, a prefill chunk or prefix-cache tail a
(tokens, table width), the draft's prompt chunk a width, the decode
block a table width, the speculative round a (target, draft) table
width and the fused tick a (table width, slot count), each captured at
:meth:`ContinuousBatcher.warmup` or at its first call and replayed
after: the host copies its inputs in one host-to-device copy and
replays.  Every layer of every call launches the hand-written attention
kernel (``ops/attention.py``).  Graphs hold the addresses of the pools
and of the parameters, so nothing here reallocates either: copy-on-write
copies, imports and commits write into the existing pool tensors, and a
weight swap copies into the existing parameter tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import queue as _queue
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from tfmesos_tpu_torch import prefixhash as _ph
from tfmesos_tpu_torch.device import resolve_device
from tfmesos_tpu_torch.graphs import StepGraphs
from tfmesos_tpu_torch.models.transformer import (PageAllocator, Params,
                                                  TransformerConfig,
                                                  _check_sampling_args,
                                                  _check_tp, decode_step,
                                                  filter_logits,
                                                  greedy_accept_counts,
                                                  init_paged_cache,
                                                  partition_specs,
                                                  rejection_accept,
                                                  sample_logits)
from tfmesos_tpu_torch.ops import prng
from tfmesos_tpu_torch.ops.quant import QTensor
from tfmesos_tpu_torch.parallel import collectives
from tfmesos_tpu_torch.parallel.sharding import data_axes, place_tree

__all__ = ["Request", "Completion", "Suspended", "Expired",
           "ContinuousBatcher", "SubmissionQueue", "Prefilled",
           "pack_prefilled", "unpack_prefilled",
           "BYPASS_ALLOWLIST", "compute_bypass_reasons"]

# SubmissionQueue.poll's end-of-stream marker (distinct from None, which
# means "nothing available right now, more may come").
_CLOSED = object()
# SubmissionQueue.kick's wake-up marker: ends an idle loop's blocking
# poll without submitting work, so a queued weight update applies now.
_KICK = object()

#: The bypass registry's allowlist (the reference's, key for key): every
#: reason a ``*_bypass_reason`` attribute may carry, per registry.
BYPASS_ALLOWLIST = {
    # An int8 pool's tail-recompute path is not bit-stable against the
    # cold fused prefill, so shared pages could break warm == cold.
    "prefix_cache": ("quantized kv cache",),
    "kv_tier": ("mesh data sharding", "quantized kv cache"),
    "pipeline": ("speculative decoding",),
    "overlap": ("pipelined decode carry",),
    "multi_step": ("speculative overlap round carry",),
    "suspend": ("mesh data sharding", "lagged decode carry"),
    "fused_prefill": ("mesh data sharding", "speculative decoding",
                      "lagged decode carry"),
}


def compute_bypass_reasons(*, speculative: bool = False,
                           n_shards: int = 1,
                           quantized_cache: bool = False,
                           draft_quantized_cache: bool = False,
                           pipeline_depth: int = 0,
                           overlap: bool = False,
                           multi_step: int = 1
                           ) -> Dict[str, Optional[str]]:
    """The ``*_bypass_reason`` values a :class:`ContinuousBatcher` built
    from these mode flags records (keys of :data:`BYPASS_ALLOWLIST`;
    None = the feature composes), computed as the reference computes
    them (``n_shards`` the mesh's data shards)."""
    quant = quantized_cache or (speculative and draft_quantized_cache)
    out: Dict[str, Optional[str]] = {key: None for key in BYPASS_ALLOWLIST}
    if quant:
        out["prefix_cache"] = "quantized kv cache"
        out["kv_tier"] = "quantized kv cache"
    if n_shards != 1:
        # Spilled and parked pages would have to cross data shards.
        out["kv_tier"] = "mesh data sharding"
    if pipeline_depth and speculative:
        out["pipeline"] = "speculative decoding"
    # The effective lags after those bypasses: overlap yields to an
    # active (non-speculative) pipeline, the pipeline to speculation.
    # Either lag leaves no settled per-row state to suspend, and a chunk
    # slot's first token is host-synchronous.
    pipelined = bool(pipeline_depth) and not speculative
    if pipelined and overlap:
        out["overlap"] = "pipelined decode carry"
    overlap_eff = overlap and out["overlap"] is None
    if speculative and multi_step > 1 and overlap_eff:
        out["multi_step"] = "speculative overlap round carry"
    if overlap_eff or pipelined:
        out["suspend"] = "lagged decode carry"
    if n_shards != 1:
        out["suspend"] = "mesh data sharding"
    if speculative:
        out["fused_prefill"] = "speculative decoding"
    elif overlap_eff or pipelined:
        out["fused_prefill"] = "lagged decode carry"
    if n_shards != 1:
        out["fused_prefill"] = "mesh data sharding"
    return out


class SubmissionQueue:
    """Thread-safe incremental :class:`Request` (or :class:`Prefilled`)
    source for :meth:`ContinuousBatcher.run`.  Any thread may
    :meth:`submit`; :meth:`close` ends the stream (later submissions
    raise).  The run loop polls non-blocking while rows decode and
    blocks only when idle."""

    def __init__(self) -> None:
        self._q: "_queue.Queue" = _queue.Queue()
        self._closed = False
        self._lock = threading.Lock()

    def submit(self, request) -> None:
        if not isinstance(request, (Request, Prefilled)):
            raise TypeError(f"submit() takes a Request or Prefilled, got "
                            f"{type(request).__name__}")
        with self._lock:
            if self._closed:
                raise RuntimeError("submission queue is closed")
            self._q.put(request)

    def close(self) -> None:
        """End the stream; idempotent."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._q.put(_CLOSED)

    def kick(self) -> None:
        """Wake a blocked serve loop without submitting work (a queued
        weight update applies at once on an idle batcher); harmless
        after :meth:`close`."""
        with self._lock:
            if not self._closed:
                self._q.put(_KICK)

    def poll(self, block: bool):
        """Next request; ``None`` when empty (more may come) or when a
        :meth:`kick` woke a blocking poll, the ``_CLOSED`` sentinel at
        end of stream."""
        while True:
            try:
                item = self._q.get(block=block)
            except _queue.Empty:
                return None
            if item is _KICK:
                if block:
                    return None     # woken: the loop re-checks its state
                continue
            if item is _CLOSED:
                self._q.put(_CLOSED)    # keep re-polls terminal
            return item


@dataclasses.dataclass
class Request:
    """One generation request: ``prompt`` is a non-empty 1-D int32 token
    array; generation stops after ``max_new_tokens`` or at
    ``stop_token`` (which is emitted).

    ``priority`` is the preemption rank (higher = more important): under
    allocation pressure a strictly-higher-priority arrival may suspend
    the lowest-priority resident row, whose stream later resumes
    token-identically.  ``deadline_ms`` is the request's remaining
    end-to-end budget at construction: an expired arrival is shed before
    its prefill and an expired resident row is cancelled (an
    :class:`Expired` in the stream).  ``session_id`` names a multi-turn
    conversation: on a batcher with a KV tier the finished request's KV
    parks under it, and a later request whose prompt extends the parked
    history installs that KV and prefills only its new tokens.
    ``trace`` (a trace context with ``event`` and ``span_between``) and
    ``on_tokens(new_tokens, offset)`` (incremental streaming, called
    once a tick with the tokens since the last call) are attributes the
    caller may set; both default to None."""

    prompt: np.ndarray
    max_new_tokens: int
    stop_token: Optional[int] = None
    priority: int = 0
    deadline_ms: Optional[float] = None
    session_id: Optional[str] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1 or self.prompt.size == 0:
            raise ValueError("Request.prompt must be a non-empty 1-D "
                             "token array (there is no position to "
                             "continue from otherwise)")
        if self.max_new_tokens < 1:
            raise ValueError(f"Request.max_new_tokens must be >= 1, got "
                             f"{self.max_new_tokens}")
        self.priority = int(self.priority)
        if self.session_id is not None:
            self.session_id = str(self.session_id)
        self.trace = None
        self.on_tokens = None
        self.deadline: Optional[float] = None
        if self.deadline_ms is not None:
            if not self.deadline_ms > 0:
                raise ValueError(f"Request.deadline_ms must be > 0, got "
                                 f"{self.deadline_ms}")
            self.deadline = (time.perf_counter()
                             + float(self.deadline_ms) / 1000.0)

    @property
    def expired(self) -> bool:
        """Whether the end-to-end deadline has passed (always False
        without one)."""
        return (self.deadline is not None
                and time.perf_counter() >= self.deadline)


@dataclasses.dataclass
class Prefilled:
    """One IMPORTED prefill: the original :class:`Request` plus the KV
    artifact a batcher exported for it (:meth:`ContinuousBatcher.
    export_kv`, or a :class:`Suspended` item's).  Admission installs the
    artifact's pages into the local pool and the row enters decode with
    its emitted tokens already in place — no prefill runs here."""

    request: Request
    artifact: dict

    def __post_init__(self):
        if not isinstance(self.request, Request):
            raise TypeError("Prefilled.request must be a Request")
        if not isinstance(self.artifact, dict):
            raise TypeError("Prefilled.artifact must be an export_kv() "
                            "artifact dict")


# Artifact array leaves, in their fixed wire order, and the small
# header keys: the reference's lists as they are.
_KV_ARRAY_KEYS = ("k", "v", "k_scales", "v_scales",
                  "dk", "dv", "dk_scales", "dv_scales")
_KV_META_KEYS = ("version", "page_size", "prefix_len", "shared_len",
                 "pos", "prompt_len", "first_token", "rid", "quantized",
                 "model", "step", "tokens", "history", "draft")

# A bf16 page travels as its raw 16-bit words under numpy's name for the
# type, "bfloat16" (what the reference's ml_dtypes arrays are called), so
# neither side needs a numpy bf16 type to read the other's bytes.
_BF16 = "bfloat16"
_TORCH_NAMES = {torch.bfloat16: _BF16, torch.float32: "float32",
                torch.float16: "float16", torch.int8: "int8"}


def _dtype_name(a) -> str:
    """numpy's name of an artifact array's dtype (a numpy array, or a
    CPU tensor: bf16 pages are tensors here)."""
    if isinstance(a, torch.Tensor):
        return _TORCH_NAMES.get(a.dtype, str(a.dtype))
    return str(a.dtype)


def _array_bytes(a):
    """The raw bytes of an artifact array, zero-copy where numpy can."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 \
            else a.numpy()
    a = np.ascontiguousarray(a)
    try:
        return memoryview(a).cast("B")
    except (ValueError, TypeError):     # extension dtypes (a numpy bf16)
        return a.tobytes()


def _as_tensor(a) -> torch.Tensor:
    """An artifact array as a CPU tensor (a numpy bf16 array — the
    reference's own artifacts — through its 16-bit words)."""
    if isinstance(a, torch.Tensor):
        return a
    if str(a.dtype) == _BF16:
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def pack_prefilled(artifact: dict) -> tuple:
    """Split an :meth:`~ContinuousBatcher.export_kv` artifact into a
    small JSON-encodable ``meta`` dict and one contiguous ``body``
    buffer, byte for byte the reference's encoding (bf16 pages as their
    raw words under dtype "bfloat16")."""
    meta = {k: artifact[k] for k in _KV_META_KEYS if k in artifact}
    specs, parts = [], []
    for name in _KV_ARRAY_KEYS:
        a = artifact.get(name)
        if a is None:
            continue
        specs.append({"name": name, "dtype": _dtype_name(a),
                      "shape": list(a.shape)})
        parts.append(_array_bytes(a))
    meta["arrays"] = specs
    return meta, b"".join(parts)


def unpack_prefilled(meta: dict, body) -> dict:
    """Inverse of :func:`pack_prefilled` (and of the reference's): the
    artifact dict from a received frame.  Array leaves are numpy views
    into ``body``, but bf16 pages, which become bf16 CPU tensors;
    malformed frames raise ``ValueError``."""
    art = {k: meta[k] for k in _KV_META_KEYS if k in meta}
    specs = meta.get("arrays")
    if not isinstance(specs, (list, tuple)):
        raise ValueError("prefilled meta carries no array manifest")
    view = memoryview(body).cast("B")
    off = 0
    for spec in specs:
        try:
            name = spec["name"]
            bf16 = spec["dtype"] == _BF16
            dtype = np.dtype(np.int16 if bf16 else spec["dtype"])
            shape = tuple(int(d) for d in spec["shape"])
        except (TypeError, KeyError, ValueError) as e:
            raise ValueError(f"bad prefilled array spec {spec!r}") from e
        if name not in _KV_ARRAY_KEYS:
            raise ValueError(f"unexpected prefilled array {name!r}")
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = count * dtype.itemsize
        if off + nbytes > len(view):
            raise ValueError("prefilled body shorter than its manifest")
        a = np.frombuffer(view, dtype=dtype, count=count,
                          offset=off).reshape(shape)
        art[name] = (torch.from_numpy(a.copy()).view(torch.bfloat16)
                     if bf16 else a)
        off += nbytes
    if off != len(view):
        raise ValueError(f"prefilled body has {len(view) - off} trailing "
                         f"bytes beyond its manifest")
    return art


@dataclasses.dataclass
class Completion:
    """A finished request: ``tokens`` are the continuation (including
    the stop token when one was emitted), ``rid`` the admission-order
    id.  ``ttft_s`` is wall time from admission to the first token,
    ``total_s`` to the last."""

    rid: int
    request: Request
    tokens: List[int]
    ttft_s: float = 0.0
    total_s: float = 0.0


@dataclasses.dataclass
class Suspended:
    """An in-flight request the batcher gave back after
    :meth:`ContinuousBatcher.preempt_all`: ``artifact`` (an
    ``export_kv``-shaped dict with the row's pages and emitted tokens)
    resumes it token-identically through ``submit(request,
    prefilled=artifact)``; None when it held no resumable state (queued
    or still prefilling) and simply reruns."""

    rid: int
    request: Request
    artifact: Optional[dict] = None


@dataclasses.dataclass
class Expired:
    """A request cancelled because its deadline passed, yielded where
    its Completion would have gone; ``rid`` is -1 when it never reached
    admission."""

    rid: int
    request: Request


@dataclasses.dataclass
class _Row:
    """Host-side state of one in-flight row."""

    rid: int
    req: Request
    pos: int            # next cache position to write (= current length)
    step: int           # tokens generated so far
    last: int           # last emitted token (feeds the next decode step)
    out: List[int]
    worst_pages: int    # admission-time page reservation (target pool)
    worst_draft: int = 0    # ... and the draft pool's, when speculating
    t_admit: float = 0.0
    t_first: float = 0.0
    # Chunked prefill: the padded prompt and how much of it is written;
    # the row decodes only once filled.
    padded: Optional[np.ndarray] = None
    filled: int = 0
    decoding: bool = True
    limit: int = 0      # absolute position cap the reservation covers
    streamed: int = 0   # tokens of ``out`` already passed to on_tokens


@dataclasses.dataclass
class _PrefixPlan:
    """Admission's decision to serve a request's leading prompt pages
    from the prefix cache: map ``nodes``' pages read-only and prefill
    from ``tail_start`` on.  ``cow`` marks the page-aligned full hit,
    whose deepest page is copied into an own page before the one-token
    logits chunk rewrites its last position."""

    nodes: list
    cow: bool
    tail_start: int     # first ABSOLUTE position the prefill writes

    @property
    def save(self) -> int:
        """Own-page reservations the mapping saves."""
        return len(self.nodes) - (1 if self.cow else 0)


class _ShardedAlloc:
    """``PageAllocator``'s surface over the sub-pools of a mesh's data
    shards (the JAX ``_ShardedAlloc``): the rows are cut into
    ``n_shards`` contiguous blocks (shard = row // rows_per_shard, the
    layout a cut batch dim gives), each block allocating from its own
    shard's sub-pool, and every page id handed out is LOCAL to its
    shard.  Reservations are taken in every shard in lockstep and land
    on the same local id, so one id names the sink or a static-prefix
    page in every sub-pool."""

    def __init__(self, n_pages_per_shard: int, page_size: int,
                 n_shards: int, rows_per_shard: int):
        self.page_size = int(page_size)
        self.n_shards = int(n_shards)
        self.rows_per_shard = int(rows_per_shard)
        self.shards = [PageAllocator(n_pages_per_shard, page_size)
                       for _ in range(self.n_shards)]

    def shard_of(self, row: int) -> int:
        return row // self.rows_per_shard

    @property
    def rows(self) -> Dict[int, list]:
        """Merged row -> local page list view (row ids never collide
        across shards; the lists are the shards' own)."""
        out: Dict[int, list] = {}
        for a in self.shards:
            out.update(a.rows)
        return out

    @property
    def free(self) -> list:
        """Every shard's free local ids, concatenated (read-only)."""
        return [p for a in self.shards for p in a.free]

    def ensure(self, row: int, length: int) -> None:
        self.shards[self.shard_of(row)].ensure(row, length)

    def release(self, row: int) -> None:
        self.shards[self.shard_of(row)].release(row)

    def allocated(self, row: int) -> int:
        return self.shards[self.shard_of(row)].allocated(row)

    def free_count(self, shard: Optional[int] = None) -> int:
        if shard is not None:
            return self.shards[shard].free_count()
        return sum(a.free_count() for a in self.shards)

    def reserve_page(self) -> int:
        ids = [a.reserve_page() for a in self.shards]
        if any(i != ids[0] for i in ids):
            raise RuntimeError("asymmetric reservation: shards must "
                               "reserve in lockstep")
        return ids[0]


class _PagedSide:
    """Host-side state of ONE paged pool, the target's or (speculative
    mode) the draft's: the allocator, the reserved sink page, the shared
    prefix pages, the prefix-cache pages each row maps read-only, and the
    cached page tables the model calls consume.  A row's table is
    [shared prefix pages | cached-prefix pages | own pages | sink ...]; a
    row with neither cached nor own pages is all-sink.  ``pool`` is the
    side's device pool (set by the owner).  Over ``n_shards`` mesh data
    shards the allocator is a :class:`_ShardedAlloc` and every table
    entry is a shard-local page id."""

    def __init__(self, n_pages: int, page_size: int, rows: int,
                 np_max: int, n_shards: int = 1):
        if n_pages % n_shards:
            raise ValueError(f"n_pages ({n_pages}) must divide over "
                             f"{n_shards} mesh data shards")
        if rows % n_shards:
            raise ValueError(f"rows ({rows}) must divide over "
                             f"{n_shards} mesh data shards")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.rows = int(rows)
        self.np_max = int(np_max)
        self.n_shards = int(n_shards)
        self.alloc = (PageAllocator(self.n_pages, self.page_size)
                      if n_shards == 1 else
                      _ShardedAlloc(self.n_pages // n_shards,
                                    self.page_size, n_shards,
                                    self.rows // n_shards))
        # Inactive decode rows still execute the batched write: their
        # table entries must point somewhere writable that no live
        # request owns.
        self.sink = self.alloc.reserve_page()
        self.pool: Optional[Dict[str, Any]] = None
        self.shared_pages: List[int] = []   # full prefix pages, read-only
        self.shared_len = 0                 # positions they cover
        self.tail_template: Optional[int] = None    # partial-page template
        self.peak = 0                       # high-water mark of pages used
        self.pcache: Optional["_PrefixCache"] = None
        self.row_cached: Dict[int, List[int]] = {}
        self._cache_np: Optional[np.ndarray] = None
        self._masked = None                 # ((masked rows, width), table)

    def dirty(self) -> None:
        """Invalidate the derived tables after any page-mapping change
        (growth, release, a cached-prefix mapping or its COW remap)."""
        self._cache_np = self._masked = None

    def ensure(self, row: int, length: int) -> None:
        """Back ABSOLUTE positions [0, length) of ``row``: the shared
        prefix pages cover [0, shared_len), its mapped cached pages the
        next ``len(row_cached[row]) * page_size``, its own allocation
        the rest."""
        before = self.alloc.allocated(row)
        covered = self.shared_len + self.page_size * len(
            self.row_cached.get(row, ()))
        self.alloc.ensure(row, max(0, length - covered))
        if self.alloc.allocated(row) != before:
            self.dirty()
        used = self.n_pages - self.alloc.free_count()
        if used > self.peak:
            self.peak = used

    def release(self, row: int) -> None:
        if self.pcache is not None:
            self.pcache.release_row(row)
        self.alloc.release(row)
        self.dirty()

    def shard_of(self, row: int) -> int:
        return row * self.n_shards // self.rows

    def shard_alloc(self, shard: int) -> PageAllocator:
        """The allocator of ``shard``'s sub-pool."""
        return (self.alloc if self.n_shards == 1
                else self.alloc.shards[shard])

    def headroom(self, active: Dict[int, _Row], worst_of,
                 shard: int = 0) -> int:
        """Free pages of ``shard`` not spoken for by its in-flight rows'
        reservations (``worst_of(row)``: ``worst_pages`` or
        ``worst_draft``); zero-ref cached pages count as free (the
        allocator reclaims them on demand), so the cache never blocks
        admission."""
        outstanding = sum(worst_of(row) - self.alloc.allocated(r)
                          for r, row in active.items()
                          if self.shard_of(r) == shard)
        reclaimable = (self.pcache.reclaimable(shard)
                       if self.pcache is not None else 0)
        return (self.shard_alloc(shard).free_count() + reclaimable
                - outstanding)

    def table_np(self) -> np.ndarray:
        """Host master copy of the [rows, np_max] table."""
        if self._cache_np is None:
            t = np.full((self.rows, self.np_max), self.sink, np.int32)
            ns = len(self.shared_pages)
            for r in range(self.rows):
                own = self.alloc.rows.get(r) or []
                cached = self.row_cached.get(r) or []
                if not own and not cached:
                    continue
                nc = len(cached)
                t[r, :ns] = self.shared_pages
                t[r, ns:ns + nc] = cached
                t[r, ns + nc:ns + nc + len(own)] = own
            self._cache_np = t
        return self._cache_np

    def bucket_width(self) -> int:
        """Smallest power-of-two table width covering every mapped row
        (shared, cached and own pages), capped at ``np_max``: a decode
        tick reads no wider table than the live rows need, and the width
        is strictly greater than the widest mapping, so a clamped write
        lands on a sink column, never a live page."""
        ns = len(self.shared_pages)
        rows = self.alloc.rows
        occ = max((ns + len(self.row_cached.get(r, ()))
                   + len(rows.get(r, ()))
                   for r in set(rows) | set(self.row_cached)
                   if rows.get(r) or self.row_cached.get(r)), default=1)
        return self.width_for(occ, self.np_max)

    @staticmethod
    def width_for(occ: int, np_max: int) -> int:
        return min(1 << occ.bit_length(), np_max)

    def decode_table(self, active: Optional[Dict[int, _Row]] = None,
                     decoding: Optional[Dict[int, _Row]] = None
                     ) -> np.ndarray:
        """The decode tick's table, sliced to :meth:`bucket_width`
        columns, with rows of ``active`` not in ``decoding`` (still-
        filling chunked prefills own their pages) pinned to the sink
        (none without ``active``); cached
        until the allocation or the masked set changes."""
        w = self.bucket_width()
        masked = (frozenset() if active is None
                  or len(decoding) == len(active)
                  else frozenset(r for r in active if r not in decoding))
        if self._masked is None or self._masked[0] != (masked, w):
            t = self.table_np()[:, :w].copy()
            for r in masked:
                t[r, :] = self.sink
            self._masked = ((masked, w), t)
        return self._masked[1]


class _PrefixNode:
    """One cached page-aligned chunk: a trie node owning one resident
    pool page and, on a speculative batcher, its draft-pool twin
    ``dpage`` (the same chunk in the draft's pool, under the same
    refcount).  ``ref`` counts the live rows mapping it; a zero-ref node
    keeps its pages resident (that is the cache) until the LRU evictor
    reclaims them under allocation pressure or the budget."""

    __slots__ = ("digest", "page", "ref", "parent", "children", "last",
                 "shard", "dpage")

    def __init__(self, digest: bytes, page: int, parent, last: int,
                 shard: int, dpage: Optional[int] = None):
        self.digest = digest
        self.page = page
        self.ref = 1
        self.parent = parent        # _PrefixNode or None (root level)
        self.children: Dict[bytes, "_PrefixNode"] = {}
        self.last = last            # LRU tick of the last touch
        self.shard = shard
        self.dpage = dpage


class _PrefixCache:
    """Cross-request prefix cache over one :class:`_PagedSide`: a hash
    trie (``prefixhash`` chain digests of page-aligned prompt chunks) of
    resident pool pages with refcounts.  Admission maps the longest
    cached prefix read-only (``acquire``) and prefills only the tail;
    the tail's full prompt pages are then published (``insert_row``:
    ownership moves from the row's allocation to the cache).  Finished
    rows drop their references; zero-ref pages stay resident and the
    allocator's ``reclaim`` hook evicts LRU leaves only when an
    allocation would otherwise fail; ``budget`` caps resident pages at
    insert time.

    Twin-pool mode (``dside``, a speculative batcher's draft pool):
    every node couples a target page with its draft twin under one
    refcount; acquire maps both, publish moves both, the COW remaps
    both, eviction frees both, and either side's allocation pressure
    reclaims through the same trie.

    Over a mesh's data shards there is one trie a shard (pages are
    pinned to their shard, so a cached page is reachable only from rows
    of its own shard).  Every public method takes the lock (``stats``
    and ``summary`` are read from a heartbeat thread)."""

    def __init__(self, side: _PagedSide, page_size: int, first: int,
                 seed: bytes, budget: int, n_shards: int = 1,
                 dside: Optional[_PagedSide] = None):
        self.side = side
        self.dside = dside
        self.page_size = int(page_size)
        self.first = int(first)     # width of chunk 0
        self.seed = seed            # chain seed
        self.budget = int(budget)   # max cached pages per shard
        self.n_shards = int(n_shards)
        self.roots: List[Dict[bytes, _PrefixNode]] = [
            {} for _ in range(self.n_shards)]
        self.row_nodes: Dict[int, List[_PrefixNode]] = {}
        self._n_nodes = [0] * self.n_shards
        self._n_zero = [0] * self.n_shards
        self._tick = 0
        self._lock = threading.Lock()
        # The eviction seam (the KV tier's spill): called as
        # ``on_evict(shard, digest, page, dpage)`` (dpage None without a
        # draft twin) before the pages free, while they still hold the
        # published chunk.  A raising callback costs the spill, never the
        # eviction.
        self.on_evict = None
        self._stats = {"hits": 0, "misses": 0, "hit_pages": 0,
                       "hit_tokens": 0, "inserted": 0, "evicted": 0,
                       "cow_copies": 0, "skipped": 0, "promoted": 0}
        for s in (side, dside):
            if s is not None:
                s.pcache = self
                for shard in range(self.n_shards):
                    s.shard_alloc(shard).reclaim = functools.partial(
                        self._reclaim_cb, shard)

    def _dirty(self) -> None:
        self.side.dirty()
        if self.dside is not None:
            self.dside.dirty()

    # -- trie walks (call under the lock) ---------------------------------

    def _walk(self, shard: int):
        stack = list(self.roots[shard].values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n

    def match(self, shard: int, digests) -> List[_PrefixNode]:
        """Longest cached path for ``digests`` (read-only)."""
        with self._lock:
            level = self.roots[shard]
            path: List[_PrefixNode] = []
            for d in digests:
                node = level.get(d)
                if node is None:
                    break
                path.append(node)
                level = node.children
            return path

    # -- row mapping -------------------------------------------------------

    def acquire(self, row: int, nodes: List[_PrefixNode]) -> None:
        """Map ``nodes``' pages read-only into ``row``'s table."""
        with self._lock:
            self._tick += 1
            for n in nodes:
                n.ref += 1
                if n.ref == 1:
                    self._n_zero[n.shard] -= 1
                n.last = self._tick
            self.row_nodes[row] = list(nodes)
            self.side.row_cached[row] = [n.page for n in nodes]
            if self.dside is not None:
                self.dside.row_cached[row] = [n.dpage for n in nodes]
        self._dirty()

    def unmap_last(self, row: int) -> _PrefixNode:
        """Drop the deepest mapped page from ``row``'s table (the COW
        remap); its reference stays held until ``release_nodes``, so the
        evictor cannot reclaim the source mid-copy."""
        with self._lock:
            node = self.row_nodes[row][-1]
            self.side.row_cached[row].pop()
            if self.dside is not None:
                self.dside.row_cached[row].pop()
        self._dirty()
        return node

    def _drop_ref(self, n: _PrefixNode) -> None:
        n.ref -= 1
        if n.ref == 0:
            self._n_zero[n.shard] += 1
        n.last = self._tick

    def release_nodes(self, row: int, nodes) -> None:
        with self._lock:
            self._tick += 1
            held = self.row_nodes.get(row, [])
            for n in nodes:
                self._drop_ref(n)
                held.remove(n)

    def release_row(self, row: int) -> None:
        """The row finished: drop every reference it holds (idempotent);
        its pages stay resident up to the budget."""
        with self._lock:
            self._tick += 1
            for n in self.row_nodes.pop(row, []):
                self._drop_ref(n)
            self.side.row_cached.pop(row, None)
            if self.dside is not None:
                self.dside.row_cached.pop(row, None)

    def insert_row(self, row: int, shard: int, digests, state) -> None:
        """Publish ``row``'s freshly prefilled full prompt pages: the
        leading own pages move to the cache (the row keeps referencing
        them at the same table slots), extending the path it already
        holds.  Stops at a chunk another row published first, or when
        the budget cannot be met by evicting."""
        with self._lock:
            self._tick += 1
            held = self.row_nodes.setdefault(row, [])
            own = self.side.alloc.rows.get(row, [])
            cached = self.side.row_cached.setdefault(row, [])
            twin = self.dside is not None
            down = self.dside.alloc.rows.get(row, []) if twin else None
            dcached = (self.dside.row_cached.setdefault(row, [])
                       if twin else None)
            level = (held[-1].children if held else self.roots[shard])
            moved = 0
            for d in digests[len(held):]:
                if not own or (twin and not down) or d in level:
                    break
                while (self._n_nodes[shard] >= self.budget
                       and self._evict_one(shard)):
                    pass
                if self._n_nodes[shard] >= self.budget:
                    self._stats["skipped"] += 1
                    break
                node = _PrefixNode(d, own.pop(0),
                                   held[-1] if held else None,
                                   self._tick, shard,
                                   dpage=down.pop(0) if twin else None)
                level[d] = node
                self._n_nodes[shard] += 1
                held.append(node)
                cached.append(node.page)
                if twin:
                    dcached.append(node.dpage)
                level = node.children
                moved += 1
            self._stats["inserted"] += moved
        # The moved pages still back the row's positions: its
        # reservation shrinks with its allocation (on each side),
        # keeping headroom exact.
        state.worst_pages -= moved
        if self.dside is not None:
            state.worst_draft -= moved

    # -- eviction ----------------------------------------------------------

    def reclaimable(self, shard: int) -> int:
        """Zero-ref nodes (a referenced descendant keeps its ancestors
        referenced, so a zero-ref subtree is entirely evictable)."""
        return self._n_zero[shard]

    def _evict_one(self, shard: int) -> bool:
        """Reclaim the LRU zero-ref LEAF; its page returns to the free
        list.  Caller holds the lock."""
        best = None
        for n in self._walk(shard):
            if n.ref == 0 and not n.children:
                if best is None or n.last < best.last:
                    best = n
        if best is None:
            return False
        if self.on_evict is not None:
            try:
                self.on_evict(shard, best.digest, best.page, best.dpage)
            except Exception:
                pass    # the spill is best-effort; the eviction stands
        level = (best.parent.children if best.parent is not None
                 else self.roots[shard])
        del level[best.digest]
        self._n_nodes[shard] -= 1
        self._n_zero[shard] -= 1
        self.side.shard_alloc(shard).free.append(best.page)
        if self.dside is not None:
            self.dside.shard_alloc(shard).free.append(best.dpage)
        self._stats["evicted"] += 1
        return True

    def insert_chain(self, shard: int, parent_digests, digest: bytes,
                     page: int, dpage: Optional[int] = None) -> bool:
        """Insert ONE resident page (and its draft twin ``dpage``) as a
        zero-ref node under the path ``parent_digests``: the KV tier's
        promotion (the caller took the pages off the free lists and
        wrote the tier's content into them; on True the cache owns them,
        reclaimable like any zero-ref page).  False when the parent path
        is gone, the chunk is already cached, or the budget cannot be
        met: the caller frees the pages."""
        with self._lock:
            self._tick += 1
            # Budget first: evicting after the walk could reclaim a leaf
            # of the very path just validated.
            while (self._n_nodes[shard] >= self.budget
                   and self._evict_one(shard)):
                pass
            if self._n_nodes[shard] >= self.budget:
                self._stats["skipped"] += 1
                return False
            level = self.roots[shard]
            parent = None
            for d in parent_digests:
                node = level.get(d)
                if node is None:
                    return False
                parent = node
                level = node.children
            if digest in level:
                return False
            node = _PrefixNode(digest, int(page), parent, self._tick,
                               shard,
                               dpage=None if dpage is None else int(dpage))
            node.ref = 0            # resident, unreferenced: the cache
            self._n_zero[shard] += 1
            level[digest] = node
            self._n_nodes[shard] += 1
            self._stats["promoted"] += 1
        return True

    def _reclaim_cb(self, shard: int) -> bool:
        with self._lock:
            return self._evict_one(shard)

    def clear(self) -> int:
        """Drop every cached node, returning its pages to the free lists
        without the eviction callback (the weight-swap invalidation:
        pages of the old weights must neither map into new rows nor
        spill); only with no row referencing one.  Returns the nodes
        dropped."""
        with self._lock:
            if self.row_nodes:
                raise RuntimeError("prefix cache clear with live row "
                                   "references — drain resident rows "
                                   "first")
            dropped = 0
            for shard in range(self.n_shards):
                for n in self._walk(shard):
                    self.side.shard_alloc(shard).free.append(n.page)
                    if self.dside is not None:
                        self.dside.shard_alloc(shard).free.append(n.dpage)
                    dropped += 1
                self.roots[shard] = {}
                self._n_nodes[shard] = self._n_zero[shard] = 0
            self._stats["evicted"] += dropped
        if dropped:
            self._dirty()
        return dropped

    # -- accounting / export ----------------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._stats[name] += n

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._stats)
            out["cached_pages"] = sum(self._n_nodes)
            out["retained_pages"] = sum(self._n_zero)
        return out

    def summary(self, max_entries: int = 64) -> Dict[str, Any]:
        """The heartbeat summary: chunk geometry plus the most recently
        touched chain digests (what the fleet router matches prompts
        against), and the stats."""
        with self._lock:
            nodes = [n for s in range(self.n_shards)
                     for n in self._walk(s)]
            nodes.sort(key=lambda n: n.last, reverse=True)
            return {"page": self.page_size, "first": self.first,
                    "seed": self.seed.hex(),
                    "hashes": [n.digest.hex()
                               for n in nodes[:max_entries]],
                    "stats": dict(self._stats)}


def _pool_leaves(pool: Dict[str, Any]) -> List[torch.Tensor]:
    """The pool's tensors: K and V, or an int8 pool's values and
    scales, each with pages on axis 1."""
    out = []
    for name in ("k", "v"):
        buf = pool[name]
        out.extend((buf.values, buf.scales) if isinstance(buf, QTensor)
                   else (buf,))
    return out


def _gather_pages(pool: Dict[str, Any], ids: torch.Tensor
                  ) -> List[torch.Tensor]:
    """Pool pages ``ids`` of every layer and leaf, on the host: the
    device side of :meth:`ContinuousBatcher.export_kv`."""
    return [buf[:, ids].cpu() for buf in _pool_leaves(pool)]


@torch.no_grad()
def _install_pages(pool: Dict[str, Any], payload: List[torch.Tensor],
                   ids: torch.Tensor) -> None:
    """Write an imported page payload (:func:`_pool_leaves` order) into
    pool pages ``ids`` IN PLACE: the device side of the import
    admission."""
    for buf, src in zip(_pool_leaves(pool), payload):
        buf[:, ids] = src.to(device=buf.device, dtype=buf.dtype)


@torch.no_grad()
def _copy_page(pool: Dict[str, Any], src: int, dst: int) -> None:
    """Copy pool page ``src`` into ``dst`` on every layer and leaf, IN
    PLACE: the copy-on-write of a prefix-cache full hit."""
    for buf in _pool_leaves(pool):
        buf[:, dst].copy_(buf[:, src])


class ContinuousBatcher:
    """Admit a stream of :class:`Request` s into a persistent paged
    decode of ``rows`` concurrent sequences.

    ``n_pages`` sizes the pool (default: fully backs ``rows x
    max_len`` plus the sink page); prompts pad up to a multiple of
    ``prefill_bucket``; ``rid_seed`` is the first request id.
    ``temperature`` 0 is greedy; above it every token is drawn from
    ``sample_logits`` (with ``top_k`` / ``top_p``) under the row's key
    ``fold_in(fold_in(rng, rid), step)`` (``rng`` a threefry key,
    default ``PRNGKey(0)``; the prefill's token is step 0).  Runs on
    the card unless ``device="cpu"`` (no card and no ``device`` raises);
    on the card every device call replays a CUDA graph (:meth:`warmup`).
    ``params`` are the float32 masters or a ``quantize_params`` tree;
    the batcher keeps a copy cast once to the
    compute dtype (the model casts every weight and int8 scale at use,
    so the bits are the same).  ``quantized_cache=True`` stores the page
    pool as int8 with per-position scales.

    ``prefill_chunk`` (a positive multiple of 8) turns on CHUNKED
    PREFILL: admission writes the prompt in chunks of that many tokens,
    one per tick of the oldest filling row, interleaved with the decode
    tick, so a long prompt stalls decoding rows by one chunk a tick.
    The chunk size becomes the prompt padding bucket.  A chunk runs
    ``decode_step`` over the pool (cache attention, the paged kernel
    with the chunk as its self operand), so greedy streams may differ
    from the unchunked batcher's at float ties, as in the reference.

    ``prefix_cache_pages`` (> 0 enables; the value caps resident cached
    pages) turns on the CROSS-REQUEST PREFIX CACHE: full page-aligned
    prompt chunks are published after prefill, later requests sharing a
    leading prompt run map those pages read-only and prefill only the
    uncached tail at its true offset; a page-aligned full hit copies its
    deepest page first (copy-on-write).  Finished requests leave
    zero-ref pages resident, reclaimed LRU-first under allocation
    pressure.  An int8 pool bypasses it (``prefix_cache_bypass_reason``).

    Disaggregated serving: :meth:`export_kv` prefills a request and
    returns its KV pages and sampler state as a host artifact;
    ``submit(request, prefilled=artifact)`` on a matching batcher
    installs the pages and decodes from there, token-identically
    (:func:`pack_prefilled` carries artifacts between processes, and
    between this port and the reference).  Priority preemption suspends
    the lowest-priority resident row for a strictly-higher-priority
    arrival and resumes it later from its artifact;
    :meth:`preempt_all` gives back every in-flight request as a
    :class:`Suspended`.  Deadlines shed an expired arrival before its
    prefill and cancel an expired resident row (:class:`Expired`).

    Schedule modes: ``multi_step=K`` decodes K tokens a dispatch and
    syncs a [rows, K] block, a row's tokens past its stop or quota
    discarded; ``overlap=True`` dispatches block N+1 before syncing
    block N, rows chaining from its last token on the device;
    ``pipeline_depth=1`` also keeps positions and steps on the device,
    uploading host inputs only when the dispatch set changes;
    ``fused_prefill=True`` (with ``prefill_chunk``) runs the decode block
    and up to ``(tokens_per_tick - n_decode * K) / chunk`` chunk slots in
    one dispatch.  Each mode runs the same ops and ``(rid, step)`` folds
    as the synchronous one-token tick, so its streams are the
    synchronous tick's — but for the fused tick at S > 1 chunk slots on
    the card, whose [S, chunk] slot call rounds its bf16 GEMMs otherwise
    than one chunk does: there a stream may first differ from the
    synchronous one at a near-tie, within the 0.25 logit margin rule
    that ``chip_smoke.py`` phase 16 (g) holds it to.  On the CPU
    (float32) every mode is exactly the synchronous tick:
    ``tests/test_torch_multistep.py``, ``tests/test_torch_lagged.py``
    and ``tests/test_torch_fused.py`` hold each against the JAX
    batcher's synchronous streams token for token.  Bypasses are the reference's (``*_bypass_reason``):
    overlap yields to the pipeline, and under either lag rows are not
    suspendable and the fused tick falls back to the phase-split one.

    ``kv_tier`` (a ``fleet.kvtier.KVTierStore``, or a ``KVFabric`` over
    one) adds the host tiers below the pool: prefix pages the cache
    evicts spill into it and promote back at the next matching
    admission, and a finished request with a ``session_id`` parks its KV
    there (at the committed boundary, in every decode mode), so the next
    turn, whose prompt extends the parked history, installs those pages
    and prefills only its new tokens through the prefix-cache tail's
    call.  Every miss (no entry, another weights_version, a corrupt
    entry, a prompt that diverges) prefills cold.  An int8 pool bypasses
    the tier (``kv_tier_bypass_reason``).

    ``prefix`` (1-D int tokens) is a static shared prompt prefix (a
    system prompt) prefilled ONCE into reserved pages that every row's
    table maps read-only; a partial last page is a template copied into
    each row's first own page.  Positions are offset by ``prefix_len``;
    ``max_len`` bounds prefix + prompt + new tokens.  A prompt's prefill
    then runs over the paged pool at position ``prefix_len`` (the paged
    kernel with the prompt as its self chunk).

    ``draft_cfg`` / ``draft_params`` turn on SPECULATIVE decoding: each
    dispatch the draft proposes ``n_draft`` tokens a row (t = 1 steps
    over its own paged pool, sized by ``draft_n_pages``, int8 with
    ``draft_quantized_cache``) and the target verifies them in one
    (k+1)-token chunk, so a row commits 1..k+1 tokens a round.  Greedy
    streams are the target-only batcher's on the CPU (float32), where
    ``tests/test_torch_speculative.py`` and
    ``tests/test_torch_spec_batcher.py`` hold them to the JAX batcher's
    token for token; on the card the verify chunk rounds its bf16 GEMMs
    otherwise than a one-token tick does, so a stream may first differ
    from the target-only one at a near-tie, within the 0.25 logit margin
    rule that ``chip_smoke.py`` phase 20 holds it to.  Sampled rounds are
    Leviathan
    rejection sampling with every draw a fold of (rid, token index): the
    proposal ``fold(rid, step + j)``, its acceptance ``fold_in(., 1)`` and
    the correction ``fold_in(fold(rid, step + a), 2)``.  ``multi_step``
    composes as R = ceil(multi_step / (k+1)) rounds a dispatch,
    ``overlap`` carries each round's state on the device, and the prefix
    cache, the static prefix, chunked prefill, export/import,
    preemption and the KV tier all carry the draft's twin pages.
    :attr:`acceptance_rate` reports the drafts accepted.

    :meth:`swap_adapter` (a param-path delta folded in) and
    :meth:`set_weights` (a whole tree) apply between generations, once no
    row is resident, by copying into the existing parameter tensors (the
    graphs read them by address), then clear the prefix cache and
    restamp the KV tier.

    ``mesh`` (a data (dp/fsdp) x tp ``parallel.mesh.RankMesh``, one rank
    a process) makes the whole loop SPMD, as the JAX batcher is on a
    multi-process mesh: every rank runs the same host loop over the
    same requests and reads the same tokens.  The rows are cut into
    contiguous blocks, one a data shard, and each shard owns an equal
    sub-pool (target and draft) its rows' tables index with shard-local
    page ids, with a prefix-cache trie and a static-prefix template of
    its own; the params are this rank's tp blocks
    (``partition_specs``, whole over the data axes).  A batched call
    (the decode block, the speculative round) runs each shard's rows
    on its own ranks, and the new tokens are all-gathered over the data
    axes; a one-row call (an admission prefill, a chunk, a tail) runs on
    the row's shard alone and its token is shared over the data axes.
    Inside a shard the model runs Megatron tp, the logits whole on every
    tp rank, so sampling folds the same keys everywhere.  ``rows`` must
    divide over the data axes and tp must divide both models' head
    counts.  Over gloo (every rank group on one card) CUDA graphs cannot
    hold the collectives: ``graphs_bypass_reason`` is ``"gloo
    collectives"`` and every call runs eagerly.  Over data shards KV
    export/import, the KV tier, preemption and the fused tick are off,
    as in the reference (``*_bypass_reason``: "mesh data sharding");
    over tp alone the fused tick runs, export/import and the KV tier are
    refused by name and preemption requeues rows without artifacts (a
    rank holds only its KV heads); weight swaps are refused on any
    mesh.

    Counters for measurement: ``prefills`` (full-prompt prefill calls;
    ``prefills_here`` those this rank ran, its data shard's on a mesh),
    ``tail_prefills`` (prefix-cache and session tails), ``prefill_chunks``,
    ``decode_ticks`` (decode dispatches, fused and speculative ones
    included), ``decode_tokens`` (tokens they committed) and
    ``decode_seconds`` (wall time of the decode dispatches and their host
    syncs), ``fused_ticks``, ``fused_chunk_tokens``,
    ``fused_decode_tokens``, ``spec_rounds``, ``spec_row_rounds``,
    ``spec_committed``, ``preemptions``, ``resumes``,
    ``deadline_cancels`` and ``weight_swaps``."""

    def __init__(self, cfg: TransformerConfig, params: Params, rows: int = 8,
                 max_len: Optional[int] = None, page_size: int = 64,
                 n_pages: Optional[int] = None, prefill_bucket: int = 64,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 rng: Optional[torch.Tensor] = None,
                 quantized_cache: bool = False, prefix=None,
                 prefill_chunk: Optional[int] = None,
                 draft_cfg: Optional[TransformerConfig] = None,
                 draft_params: Optional[Params] = None, n_draft: int = 4,
                 draft_n_pages: Optional[int] = None, mesh=None,
                 overlap: bool = False, draft_quantized_cache: bool = False,
                 multi_step: int = 1, prefix_cache_pages: int = 0,
                 pipeline_depth: int = 0, kv_tier=None, rid_seed: int = 0,
                 fused_prefill: bool = False,
                 tokens_per_tick: Optional[int] = None, device=None):
        if rows < 1:
            raise ValueError(f"rows must be >= 1, got {rows}")
        if not 0 <= int(rid_seed) < 2 ** 30:
            raise ValueError(f"rid_seed must be in [0, 2^30), got "
                             f"{rid_seed}")
        if prefix_cache_pages < 0:
            raise ValueError(f"prefix_cache_pages must be >= 0, got "
                             f"{prefix_cache_pages}")
        if multi_step < 1:
            raise ValueError(f"multi_step must be >= 1, got {multi_step}")
        if pipeline_depth not in (0, 1):
            raise ValueError(f"pipeline_depth must be 0 (synchronous "
                             f"host sync) or 1 (one block of device-"
                             f"resident lag), got {pipeline_depth}")
        if fused_prefill and prefill_chunk is None:
            raise ValueError("fused_prefill requires prefill_chunk "
                             "(chunked prefill is the lane being fused)")
        if tokens_per_tick is not None and tokens_per_tick < 1:
            raise ValueError(f"tokens_per_tick must be >= 1, got "
                             f"{tokens_per_tick}")
        self.mesh = mesh
        self.n_shards, self._tp, self._shard = 1, 1, 0
        self._tp_mesh = None
        if mesh is not None:
            real = {a for a, n in mesh.axes.items() if n > 1}
            if not real <= {"dp", "fsdp", "tp"}:
                raise ValueError(f"ContinuousBatcher meshes are data "
                                 f"(dp/fsdp) x tp; got axes {sorted(real)}")
            self.n_shards = mesh.axis_size(("dp", "fsdp"))
            self._tp = mesh.axis_size("tp")
            self._shard = mesh.coord(("dp", "fsdp"))
            self._tp_mesh = mesh.only("tp")
            if rows % self.n_shards:
                raise ValueError(
                    f"rows ({rows}) must divide over the mesh data axes "
                    f"({self.n_shards}) — each data shard serves an equal "
                    f"row block")
            for c in (cfg, draft_cfg):
                if c is not None:
                    _check_tp(c, self._tp_mesh, "ContinuousBatcher")
        #: Why the calls run eagerly on the card (None: CUDA graphs).
        self.graphs_bypass_reason: Optional[str] = None
        if mesh is not None and mesh.size() > 1:
            import torch.distributed as dist

            if dist.get_backend(mesh.get_group()) == "gloo":
                self.graphs_bypass_reason = "gloo collectives"
        self._bypass = compute_bypass_reasons(
            speculative=draft_cfg is not None, n_shards=self.n_shards,
            quantized_cache=quantized_cache,
            draft_quantized_cache=draft_quantized_cache,
            pipeline_depth=pipeline_depth, overlap=overlap,
            multi_step=multi_step)
        self.multi_step = int(multi_step)
        self.pipeline_depth = int(pipeline_depth)
        self.pipeline_bypass_reason: Optional[str] = self._bypass["pipeline"]
        self.overlap_bypass_reason: Optional[str] = self._bypass["overlap"]
        self.multi_step_bypass_reason: Optional[str] = \
            self._bypass["multi_step"]
        # Overlap yields to an active pipeline (its carry covers it).
        self.overlap = bool(overlap) and self.overlap_bypass_reason is None
        self.fused_prefill_bypass_reason: Optional[str] = (
            self._bypass["fused_prefill"] if fused_prefill else None)
        self._fused = bool(fused_prefill) and \
            self.fused_prefill_bypass_reason is None
        #: The fused tick's token budget: by default every row decoding a
        #: full block plus one chunk.
        self.tokens_per_tick = int(tokens_per_tick or rows * self.multi_step
                                   + (prefill_chunk or 0))
        # The lagged modes' state: the block in flight (its host output
        # and event, and its {row: rid} ticket), and under the pipeline
        # the device carry in use and the key of the host inputs last
        # uploaded.
        self._inflight = None
        self._pipe_carry = None
        self._pipe_host = None
        _check_sampling_args(top_k, top_p)
        if prefill_chunk is not None:
            if prefill_chunk < 1 or prefill_chunk % 8:
                raise ValueError(f"prefill_chunk ({prefill_chunk}) must be "
                                 f"a positive multiple of 8")
            prefill_bucket = prefill_chunk
        if prefill_bucket < 1:
            raise ValueError(f"prefill_bucket must be >= 1, got "
                             f"{prefill_bucket}")
        if (draft_cfg is None) != (draft_params is None):
            raise ValueError("draft_cfg and draft_params come together")
        self.device = resolve_device(device)
        self.cfg = cfg
        # The caller's tree, kept for weight folds: a fold adds onto the
        # masters and casts once, as the reference casts at use.
        self._masters = params
        self.params = self._local_params(cfg, params)
        self.rows = int(rows)
        self._rl = self.rows // self.n_shards       # rows a data shard
        self._r0 = self._shard * self._rl
        self.max_len = int(max_len or cfg.max_seq_len)
        if self.max_len > cfg.max_seq_len:
            raise ValueError(f"max_len ({self.max_len}) exceeds the "
                             f"config's max_seq_len ({cfg.max_seq_len})")
        self.page_size = int(page_size)
        self.np_max = -(-self.max_len // self.page_size)
        # Default pool: every row's worst case beyond the shared prefix's
        # full pages, plus the prefix's reserved pages and the sink, in
        # each data shard's sub-pool.
        prefix_np = None if prefix is None else np.asarray(prefix, np.int32)
        n_prefix_pages = (0 if prefix_np is None
                          else -(-int(prefix_np.size) // self.page_size))
        shared_full = (0 if prefix_np is None
                       else (int(prefix_np.size) // self.page_size)
                       * self.page_size)
        own_max = -(-(self.max_len - shared_full) // self.page_size)
        default_pages = self.n_shards * (
            self._rl * own_max + n_prefix_pages + 1)
        self.n_pages = int(n_pages or default_pages)
        self.prefill_chunk = prefill_chunk
        self.prefill_bucket = int(prefill_bucket)
        self.prefix_len = 0
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self._rng = (prng.PRNGKey(0, self.device) if rng is None
                     else rng.to(self.device).long())
        self.t_side = _PagedSide(self.n_pages, self.page_size, self.rows,
                                 self.np_max, self.n_shards)
        self.pool = init_paged_cache(cfg, self.n_pages, self.page_size,
                                     quantized=quantized_cache,
                                     device=self.device, mesh=self.mesh)
        self.t_side.pool = self.pool
        # Speculative decoding: the draft's own paged pool (same page
        # size and table layout, its own allocator), R rounds a dispatch.
        self.draft_cfg = draft_cfg
        self.n_draft = int(n_draft)
        self.draft_params: Optional[Params] = None
        self.d_side: Optional[_PagedSide] = None
        self.dpool: Optional[Dict[str, Any]] = None
        self._spec_rounds = 0
        if draft_cfg is not None:
            if self.n_draft < 1:
                raise ValueError(f"n_draft must be >= 1, got {n_draft}")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share a vocab")
            # +1: the backfill draft step writes one past the proposals,
            # and parked rows sit at position max_len.
            depth = self.max_len + self.n_draft + 1
            if draft_cfg.max_seq_len < depth:
                raise ValueError(
                    f"draft max_seq_len ({draft_cfg.max_seq_len}) must "
                    f"cover max_len + n_draft + 1 ({depth}) — rows can "
                    f"overshoot by a draft run")
            self._spec_rounds = (1 if self.multi_step_bypass_reason
                                 is not None else
                                 max(1, -(-self.multi_step
                                          // (self.n_draft + 1))))
            self.draft_params = self._local_params(draft_cfg, draft_params)
            self.n_draft_pages = int(draft_n_pages or default_pages)
            self.d_side = _PagedSide(self.n_draft_pages, self.page_size,
                                     self.rows, self.np_max, self.n_shards)
            self.dpool = init_paged_cache(
                draft_cfg, self.n_draft_pages, self.page_size,
                quantized=draft_quantized_cache, device=self.device,
                mesh=self.mesh)
            self.d_side.pool = self.dpool
        self._next_rid = int(rid_seed)
        self._submissions: Optional[SubmissionQueue] = None
        self._submissions_lock = threading.Lock()
        # Fences export_kv's row borrowing, warmup and weight updates
        # against the loop.
        self._loop_lock = threading.Lock()
        self._loop_active = False
        # Preempted rows' artifacts waiting for a row to resume through
        # the import path, and the drain-migration request.
        self._parked: deque = deque()
        self._preempt_event = threading.Event()
        # Online weight updates (swap_adapter / set_weights), applied by
        # the serve loop between generations.
        self._weight_updates: deque = deque()
        self._weights_lock = threading.Lock()
        #: Label of the last adapter delta folded in ("" = base weights).
        self.adapter_version = ""
        self.weight_swaps = 0       # updates applied (folds and sets)
        #: Optional hook ``on_weights_applied(kind, version)`` fired after
        #: each update applies (the replica refreshes its heartbeat).
        self.on_weights_applied = None
        # The decode block's static buffers: its inputs (tokens,
        # positions, rids, steps, and the lagged modes' merge flag; one
        # row each), uploaded in one host-to-device copy, its [rows, K]
        # tokens, the pipeline's device carry (last token, position,
        # step), and a page table a width, re-copied only when the
        # allocation changes.  Host staging is a fresh pinned buffer a
        # copy: the caching host allocator keeps it until its copy has
        # run, so a lagged block never races a reused one.
        self._pin = self.device.type == "cuda"
        self._tick_in = torch.zeros((5, self.rows), dtype=torch.long,
                                    device=self.device)
        self._tick_out = torch.zeros((self.rows, self.multi_step),
                                     dtype=torch.long, device=self.device)
        self._carry = torch.zeros((3, self.rows), dtype=torch.long,
                                  device=self.device)
        # width -> (host table last copied, device table), per side.
        self._tables: Dict[int, Tuple[Any, torch.Tensor]] = {}
        self._dtables: Dict[int, Tuple[Any, torch.Tensor]] = {}
        # The speculative round's outputs: R rounds of [rows, k+1]
        # commit candidates and [rows] commit counts; under overlap the
        # round's carry (candidates, counts, positions, steps) the next
        # round continues from.
        k1 = self.n_draft + 1
        R = max(1, self._spec_rounds)
        self._spec_g = torch.zeros((R, self.rows, k1), dtype=torch.long,
                                   device=self.device)
        self._spec_n = torch.zeros((R, self.rows), dtype=torch.long,
                                   device=self.device)
        self._spec_carry = torch.zeros((self.rows, k1 + 3),
                                       dtype=torch.long, device=self.device)
        # (chunk tokens, table width) -> the chunk step's static input
        # (tokens, pos, cap, rid, the row's table) and output buffers.
        self._chunk_bufs: Dict[Tuple[int, int],
                               Tuple[torch.Tensor, torch.Tensor]] = {}
        # prompt width -> the admission prefill's static input (tokens,
        # length - 1, rid, the row's table) and output buffers.
        self._prefill_bufs: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        # draft chunk tokens -> its static input (tokens, pos, the row's
        # np_max-wide draft table).
        self._dchunk_bufs: Dict[int, torch.Tensor] = {}
        # fused slot count S -> the chunk slots' static input ([S] rows
        # of chunk tokens, position, cap, rid, table) and first tokens.
        self._slot_bufs: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._graphs = StepGraphs(self.device)
        self._graphs.eager = (self._graphs.eager
                              or self.graphs_bypass_reason is not None)
        self.prefills = 0
        self.prefills_here = 0      # admission prefills this rank ran
        self.tail_prefills = 0
        self.prefill_chunks = 0
        self.decode_ticks = 0
        self.decode_tokens = 0
        self.decode_seconds = 0.0
        self.preemptions = 0        # rows suspended for a higher class
        self.resumes = 0            # parked rows re-admitted locally
        self.deadline_cancels = 0   # arrivals shed + resident rows cancelled
        self.fused_ticks = 0          # fused prefill+decode dispatches
        self.fused_chunk_tokens = 0   # prefill tokens they coalesced
        self.fused_decode_tokens = 0  # decode tokens they covered
        self.spec_rounds = 0        # speculative rounds run
        self.spec_row_rounds = 0    # rows decoding, summed over rounds
        self.spec_committed = 0     # tokens those row-rounds committed
        if prefix_np is not None:
            self._init_prefix(prefix_np)
        self.suspend_bypass_reason: Optional[str] = self._bypass["suspend"]
        # The prefix cache: with a static prefix its chunks start after
        # the shared full pages, the first one short by the prefix's
        # partial page, and the chain is seeded by that partial page's
        # tokens (the reference's rule, so digests match across
        # frameworks).
        self._pcache: Optional[_PrefixCache] = None
        self.prefix_cache_bypass_reason: Optional[str] = None
        if prefix_cache_pages:
            self.prefix_cache_bypass_reason = self._bypass["prefix_cache"]
            if self.prefix_cache_bypass_reason is None:
                off = self.prefix_len - self.t_side.shared_len
                seed = (b"" if not off else _ph.chunk_digest(
                    b"", prefix_np[self.t_side.shared_len:]))
                self._pcache = _PrefixCache(self.t_side, self.page_size,
                                            self.page_size - off, seed,
                                            prefix_cache_pages,
                                            n_shards=self.n_shards,
                                            dside=self.d_side)
        # The KV tier: prefix pages the pool evicts spill into it and
        # promote back at the next matching admission; finished
        # session-labelled requests park their KV in it for the next
        # turn.  An int8 pool bypasses it (kv_tier_bypass_reason).
        self.kv_tier = kv_tier
        self.kv_tier_bypass_reason: Optional[str] = None
        if kv_tier is not None:
            self.kv_tier_bypass_reason = self._bypass["kv_tier"]
            if self.mesh is not None and self.kv_tier_bypass_reason is None:
                raise NotImplementedError("not ported yet: the KV tier on "
                                          "a tp mesh")
            if self.kv_tier_bypass_reason is None \
                    and self._pcache is not None:
                self._pcache.on_evict = self._spill_page
                kv_tier.prefix_geometry = {
                    "page": self.page_size, "first": self._pcache.first,
                    "seed": self._pcache.seed.hex()}

    def _local_params(self, cfg: TransformerConfig, params: Params
                      ) -> Params:
        """``params`` on the device at the compute dtype; on a mesh this
        rank's tp blocks (``partition_specs`` over tp alone: every data
        shard holds the whole tp-cut tree, so a shard's one-row call
        needs no other shard)."""
        if self._tp_mesh is not None:
            params = place_tree(self._tp_mesh, params,
                                partition_specs(cfg, self._tp_mesh))
        return _to_device(params, self.device, cfg.dtype)

    def _owns(self, row: int) -> bool:
        """Whether ``row`` is in this rank's data shard."""
        return self.t_side.shard_of(row) == self._shard

    def _local(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's row block of a [rows]-wide ``dim`` (all of it
        without a mesh)."""
        if self.n_shards == 1:
            return x
        return x.narrow(dim, self._r0, self._rl)

    def _put_rows(self, dst: torch.Tensor, local: torch.Tensor) -> None:
        """Write every data shard's row block (this rank's ``local``, the
        others' over the data axes) into the [rows, ...] ``dst``."""
        if self.n_shards == 1:
            dst.copy_(local)
        else:
            dst.copy_(collectives.all_gather(local.contiguous(), self.mesh,
                                             data_axes(self.mesh), 0))

    def _share(self, out: torch.Tensor, row: int) -> None:
        """A one-row call's token, computed by ``row``'s shard alone, on
        every rank (a sum over the data axes of it and zeros)."""
        if self.n_shards == 1:
            return
        mine = out if self._owns(row) else torch.zeros_like(out)
        out.copy_(collectives.all_reduce_sum(mine, self.mesh,
                                             data_axes(self.mesh)))

    def _refuse_on_mesh(self, what: str) -> None:
        if self.n_shards != 1:
            raise ValueError(f"{what} requires a single-shard pool (mesh "
                             f"data shards pin pages locally)")
        if self.mesh is not None:
            raise NotImplementedError(f"not ported yet: {what} on a tp "
                                      f"mesh")

    @property
    def peak_pages_used(self) -> int:
        return self.t_side.peak

    @property
    def alloc(self) -> PageAllocator:
        return self.t_side.alloc

    @property
    def prefix_cache_active(self) -> bool:
        return self._pcache is not None

    @property
    def _pipelined(self) -> bool:
        """Pipelined decode is in effect (requested and not bypassed)."""
        return self.pipeline_depth > 0 and self.pipeline_bypass_reason is None

    @property
    def preemptible(self) -> bool:
        """Whether a resident row can be suspended (the ``suspend``
        registry entry is None): not under a lagged decode carry
        (``overlap``, ``pipeline_depth=1``), whose host view of a row
        runs a block behind its pages, nor on a mesh, whose ranks hold
        a row's KV heads apart (a suspended row requeues without an
        artifact, as under the registry's bypass)."""
        return self.suspend_bypass_reason is None and self.mesh is None

    def paged_launches_per_block(self, block_tokens: int = 16) -> int:
        """Target paged-attention launches per layer needed to retire
        ``block_tokens`` decode tokens of one row (the reference's
        analytic metric): one a token, or one verify launch for every
        ``n_draft + 1`` tokens a speculative round can retire."""
        if self.draft_cfg is not None:
            return -(-int(block_tokens) // (self.n_draft + 1))
        return int(block_tokens)

    @property
    def acceptance_rate(self) -> Optional[float]:
        """Fraction of draft proposals accepted: every row-round commits
        its accepted run plus one non-draft token, so (committed -
        row_rounds) over row_rounds x n_draft; None before any round (or
        without a draft)."""
        if self.d_side is None or not self.spec_row_rounds:
            return None
        return ((self.spec_committed - self.spec_row_rounds)
                / (self.spec_row_rounds * self.n_draft))

    def fused_tokens_per_tick(self, n_decode: Optional[int] = None) -> int:
        """Tokens one dispatch covers on a tick with ``n_decode``
        decoding rows (default: all rows): the decode block, plus under
        ``fused_prefill`` the chunk slots the ``tokens_per_tick`` budget
        leaves room for, at least one."""
        n = self.rows if n_decode is None else int(n_decode)
        dt = n * self.multi_step
        if not self._fused:
            return dt
        c = self.prefill_chunk
        return dt + max(1, (self.tokens_per_tick - dt) // c) * c

    def prefix_cache_stats(self) -> Optional[Dict[str, int]]:
        """Hit/miss/eviction counters plus occupancy of the prefix cache
        (None when disabled or bypassed); thread-safe."""
        return None if self._pcache is None else self._pcache.stats()

    def prefix_cache_summary(self, max_entries: int = 64
                             ) -> Optional[dict]:
        """The heartbeat summary of what the prefix cache holds (chunk
        geometry plus recent chain digests); None when disabled."""
        return (None if self._pcache is None
                else self._pcache.summary(max_entries))

    def kv_headroom(self) -> int:
        """Free pool pages a new request could take now: the free list
        plus zero-ref cached pages (a heartbeat-grade load signal; it
        does not subtract in-flight reservations)."""
        free = self.t_side.alloc.free_count()
        if self._pcache is not None:
            free += sum(self._pcache.reclaimable(s)
                        for s in range(self.n_shards))
        return free

    def preempt_all(self) -> None:
        """Ask the serve loop to give back EVERY in-flight request as a
        :class:`Suspended` on its next tick (the drain-migration side):
        resident decoding rows carry their KV artifact, everything else
        requeues with ``artifact=None``.  Thread-safe."""
        self._preempt_event.set()

    # -- online weight updates ----------------------------------------------

    def swap_adapter(self, delta: Dict[str, Any], version: str,
                     on_applied=None) -> None:
        """Fold a weight DELTA (``/``-joined param paths, e.g.
        ``"layers/wq"``, to arrays added onto those leaves) into the
        serving weights.  Validated now (an unknown path, an interior
        node, a shape mismatch or an int8 leaf raises ``ValueError``);
        applied by the serve loop once no row is resident, new
        admissions waiting behind the fence, so every stream runs under
        exactly one delta.  ``version`` labels the result
        (:attr:`adapter_version`); ``on_applied()`` fires after the fold.
        Without a serve loop the fold applies at once."""
        if not isinstance(version, str) or not version:
            raise ValueError("adapter version must be a non-empty "
                             "string")
        self._refuse_swaps_on_mesh()
        resolved = self._resolve_delta(delta)
        self._queue_weight_update(("fold", resolved, version, on_applied))

    def set_weights(self, params: Params, version: str = "",
                    on_applied=None) -> None:
        """Replace the whole parameter tree (the warm-pool adoption: the
        same config and shapes, so nothing is recaptured), under
        :meth:`swap_adapter`'s fence; ``version`` restamps the KV tier so
        entries parked under the old weights read as version misses."""
        self._refuse_swaps_on_mesh()
        self._check_tree(params, self.params, "")
        self._queue_weight_update(("set", params, str(version or ""),
                                   on_applied))

    def _check_tree(self, new, live, path: str) -> None:
        """``new`` has ``live``'s structure, leaf kinds and shapes
        (``ValueError`` otherwise)."""
        if isinstance(live, dict):
            if not isinstance(new, dict) or set(new) != set(live):
                raise ValueError(f"set_weights: the tree at {path or '/'!r} "
                                 f"does not match the serving params")
            for k in live:
                self._check_tree(new[k], live[k], f"{path}/{k}")
            return
        if isinstance(live, QTensor) != isinstance(new, QTensor) \
                or tuple(new.shape if not isinstance(new, QTensor)
                         else new.values.shape) \
                != tuple(live.shape if not isinstance(live, QTensor)
                         else live.values.shape):
            raise ValueError(f"set_weights: leaf {path!r} does not match "
                             f"the serving params")

    def _resolve_delta(self, delta: Dict[str, Any]):
        """Validate a path -> array delta against the live params;
        returns ``[(key_path, float32 CPU tensor), ...]``."""
        if not isinstance(delta, dict) or not delta:
            raise ValueError("adapter delta must be a non-empty dict "
                             "of param-path -> array")
        resolved = []
        for path in sorted(delta):
            keys = tuple(k for k in str(path).split("/") if k)
            node = self.params
            for k in keys:
                if not isinstance(node, dict) or k not in node:
                    raise ValueError(f"adapter delta names unknown param "
                                     f"path {path!r}")
                node = node[k]
            if not keys or isinstance(node, dict):
                raise ValueError(
                    f"adapter delta path {path!r} does not name a param "
                    f"array (it is "
                    f"{'empty' if not keys else 'an interior node'})")
            if isinstance(node, QTensor):
                raise ValueError(f"adapter delta path {path!r} names an "
                                 f"int8 weight; folds need float weights")
            arr = np.asarray(delta[path])
            if tuple(arr.shape) != tuple(node.shape):
                raise ValueError(
                    f"adapter delta shape mismatch at {path!r}: delta "
                    f"{tuple(arr.shape)} vs param {tuple(node.shape)}")
            resolved.append((keys, torch.from_numpy(
                arr.astype(np.float32))))
        return resolved

    def _refuse_swaps_on_mesh(self) -> None:
        if self.mesh is not None:
            raise NotImplementedError("not ported yet: weight swaps on a "
                                      "mesh")

    def _queue_weight_update(self, update) -> None:
        with self._loop_lock:
            if self._loop_active:
                # The loop owns the rows: it applies the update at its
                # next point with nothing resident; the kick wakes an
                # idle loop so the update never waits for traffic.
                with self._weights_lock:
                    self._weight_updates.append(update)
                src = self._submissions
                if src is not None:
                    src.kick()
            else:
                self._apply_weight_update(update)

    def _apply_pending_weight_updates(self) -> None:
        while True:
            with self._weights_lock:
                if not self._weight_updates:
                    return
                update = self._weight_updates.popleft()
            self._apply_weight_update(update)

    @torch.no_grad()
    def _apply_weight_update(self, update) -> None:
        """Apply one update IN PLACE: every captured graph reads the
        parameter tensors by address, so a fold or a set copies into the
        existing storage (an int8 leaf's values and scales alike) and
        recaptures nothing.  Then the prefix cache clears (no spill) and
        the KV tier restamps, so no KV of the old weights feeds a new
        decode."""
        kind, payload, version, cb = update
        if kind == "fold":
            masters = _tree_copy(self._masters)
            for keys, arr in payload:
                node, live = masters, self.params
                for key in keys[:-1]:
                    node, live = node[key], live[key]
                leaf = node[keys[-1]]
                new = leaf + arr.to(device=leaf.device, dtype=leaf.dtype)
                node[keys[-1]] = new
                live[keys[-1]].copy_(new.to(live[keys[-1]].dtype))
            self._masters = masters
            self.adapter_version = version
        else:
            _copy_tree(self.params, payload)
            self._masters = payload
            self.adapter_version = ""
        if self._pcache is not None:
            self._pcache.clear()
        if self._tier_active:
            restamp = getattr(self.kv_tier, "restamp", None)
            if restamp is not None:
                if kind == "fold":
                    restamp(adapter=version)
                else:
                    restamp(weights_version=version or None, adapter="")
        self.weight_swaps += 1
        for fn, args in ((self.on_weights_applied, (kind, version)),
                         (cb, ())):
            if fn is not None:
                try:
                    fn(*args)
                except Exception:
                    pass    # an observer or waiter never costs the update

    # -- validation / online submission -----------------------------------

    def validate(self, req) -> None:
        """Raise ``ValueError`` if ``req`` (a :class:`Request` or
        :class:`Prefilled`) can never be served here."""
        if isinstance(req, Prefilled):
            self._worst_pages(req.request)
            self._validate_artifact(req.artifact, req.request)
            return
        self._worst_pages(req)

    def _submission_source(self) -> SubmissionQueue:
        with self._submissions_lock:
            if self._submissions is None:
                self._submissions = SubmissionQueue()
            return self._submissions

    def submit(self, request: Request, prefilled: Optional[dict] = None
               ) -> None:
        """Thread-safe online admission: queue ``request`` for
        :meth:`serve`; raises after :meth:`close`.  ``prefilled`` (an
        :meth:`export_kv` artifact) puts it on the import path."""
        if prefilled is not None:
            request = Prefilled(request, prefilled)
        self._submission_source().submit(request)

    def close(self) -> None:
        """End the online stream: :meth:`serve` drains and returns."""
        self._submission_source().close()

    def serve(self) -> Iterator[Completion]:
        """:meth:`run` over the submission queue."""
        return self.run(self._submission_source())

    # -- the loop ---------------------------------------------------------

    def run(self, requests: Iterable) -> Iterator:
        """Serve ``requests`` (any iterable of :class:`Request` or
        :class:`Prefilled`, or a :class:`SubmissionQueue` via
        :meth:`serve`), yielding :class:`Completion` s in finish order,
        and :class:`Expired` / :class:`Suspended` items where deadlines
        and :meth:`preempt_all` say.  Requests are pulled lazily, only
        when a row and pages are free; queued online arrivals admit by
        priority, FIFO within a priority.  An invalid request raises —
        after every admitted request has drained.  Abandoning the
        iterator releases every row."""
        incremental = isinstance(requests, SubmissionQueue)
        source = None if incremental else iter(requests)
        pending: deque = deque()
        active: Dict[int, _Row] = {}
        free_rows = list(range(self.rows))
        exhausted = False
        bad_request: Optional[Exception] = None

        def rank_of(item):
            return (item.request if isinstance(item, Prefilled)
                    else item).priority

        def rank_insert(item):
            p = rank_of(item)
            i = len(pending)
            while i > 0 and rank_of(pending[i - 1]) < p:
                i -= 1
            pending.insert(i, item)

        def pull(block=True):
            nonlocal exhausted
            if exhausted:
                return
            if incremental:
                want_block = block and not pending
                while True:
                    item = requests.poll(want_block)
                    want_block = False
                    if item is _CLOSED:
                        exhausted = True
                        return
                    if item is None:
                        return
                    rank_insert(item)
            if pending:
                return
            try:
                pending.append(next(source))
            except StopIteration:
                exhausted = True

        with self._loop_lock:
            self._loop_active = True
        try:
            while True:
                if self._preempt_event.is_set():
                    yield from self._preempt_everything(
                        pending, active, free_rows,
                        requests if incremental else None)
                yield from self._cancel_expired(active, free_rows)
                burst: list = []
                # Parked (preempted) artifacts resume first, unless a
                # queued arrival strictly outranks them.
                if self._parked and incremental:
                    pull(block=False)
                while free_rows and self._parked and bad_request is None:
                    pre = self._parked[0]
                    if pre.request.expired:
                        self._parked.popleft()
                        self.deadline_cancels += 1
                        self._trace_event(pre.request, "deadline_cancel",
                                          where="parked")
                        yield Expired(rid=int(pre.artifact.get("rid", -1)),
                                      request=pre.request)
                        continue
                    if pending and rank_of(pending[0]) > \
                            pre.request.priority:
                        break
                    try:
                        wt, wd, need = self._worst_pages(pre.request)
                        row, _ = self._admit_row(free_rows, active, wt, wd,
                                                 pre.request,
                                                 use_cache=False)
                    except RuntimeError:
                        # The import can never fit this pool: rerun it
                        # from scratch through the normal path.
                        self._parked.popleft()
                        pending.appendleft(pre.request)
                        continue
                    if row is None:
                        break       # resume once pages free up
                    self._parked.popleft()
                    self.resumes += 1
                    self._trace_event(pre.request, "resume")
                    burst.append(self._admit_import(row, pre, wt, wd,
                                                    need, active))
                # A pending weight update gates new admissions: resident
                # rows and parked resumes finish on the old weights.
                while free_rows and bad_request is None \
                        and not self._weight_updates:
                    if not pending and not exhausted and burst \
                            and not incremental:
                        # next(source) may block: settle the admissions
                        # already dispatched first.
                        yield from self._finalize_burst(burst, active,
                                                        free_rows)
                    pull(block=False)
                    if not pending:
                        break
                    item = pending[0]
                    imported = isinstance(item, Prefilled)
                    req0 = item.request if imported else item
                    if req0.expired:
                        # Shed before any prefill (or import) dispatches.
                        pending.popleft()
                        self.deadline_cancels += 1
                        self._trace_event(req0, "deadline_cancel",
                                          where="queued")
                        yield Expired(
                            rid=(int(item.artifact.get("rid", -1))
                                 if imported else -1), request=req0)
                        continue
                    try:
                        wt, wd, need = self._worst_pages(req0)
                        if imported:
                            self._validate_artifact(item.artifact, req0)
                    except ValueError as e:
                        bad_request = e     # raise after draining
                        break
                    # KV tier: a usable parked session takes the resume
                    # path (its pages come from the artifact, so no
                    # prefix plan and no promotion); otherwise spilled
                    # prefix pages this prompt could map promote first.
                    sess_art = (None if imported
                                else self._session_lookup(req0))
                    if not imported and sess_art is None:
                        self._tier_promote(req0)
                    row, plan = self._admit_row(
                        free_rows, active, wt, wd, req0,
                        use_cache=not imported and sess_art is None)
                    if row is None:
                        # Allocation pressure: a strictly-higher-priority
                        # head may suspend the lowest-priority resident
                        # row and retry.
                        if self._maybe_preempt(req0.priority, active,
                                               free_rows):
                            continue
                        break   # wait for an in-flight row to finish
                    pending.popleft()
                    if imported:
                        # Imports keep their exporter's rid (the sampling
                        # folds continue that stream).
                        res = self._admit_import(row, item, wt, wd, need,
                                                 active)
                    elif sess_art is not None:
                        rid = self._next_rid
                        self._next_rid += 1
                        res = self._admit_session(row, rid, item, wt, wd,
                                                  need, active, sess_art)
                    else:
                        rid = self._next_rid
                        self._next_rid += 1
                        res = self._admit_dispatch(row, rid, item, wt, wd,
                                                   need, active, plan)
                    if res is not None:
                        burst.append(res)
                # Every row busy: one eager pull lets a strictly
                # higher-priority online arrival preempt now.
                if (not free_rows and incremental and self.preemptible
                        and bad_request is None
                        and not self._weight_updates):
                    pull(block=False)
                    if pending and self._maybe_preempt(
                            rank_of(pending[0]), active, free_rows):
                        yield from self._finalize_burst(burst, active,
                                                        free_rows)
                        continue
                yield from self._finalize_burst(burst, active, free_rows)
                self._flush_streams(active)
                if not active:
                    if bad_request is not None:
                        raise bad_request
                    if self._parked:
                        continue    # resume parked work before idling
                    if self._weight_updates:
                        # Between generations, nothing resident: the
                        # weight-update point.
                        self._apply_pending_weight_updates()
                        continue
                    pull()
                    if not pending and exhausted:
                        return
                    continue
                if (self._fused
                        and any(row.decoding for row in active.values())
                        and any(not row.decoding
                                for row in active.values())):
                    # Both lanes live: the decode block and the budgeted
                    # chunk slots in one dispatch.
                    yield from self._step_fused(active, free_rows)
                    self._flush_streams(active)
                    continue
                if self.prefill_chunk is not None:
                    done_row = self._advance_prefill(active)
                    if done_row is not None:
                        done = self._completion(active[done_row])
                        self._finish_completed(done_row, active, free_rows)
                        yield done
                if any(row.decoding for row in active.values()):
                    if self.draft_cfg is not None and self.overlap:
                        yield from self._step_spec_overlap(active,
                                                           free_rows)
                    elif self.draft_cfg is not None:
                        yield from self._step_spec(active, free_rows)
                    elif self._pipelined or self.overlap:
                        yield from self._step_lagged(active, free_rows)
                    else:
                        yield from self._step(active, free_rows)
                    self._flush_streams(active)
        finally:
            # A stale lagged block and its device carry die with the loop.
            self._inflight = None
            self._pipe_carry = self._pipe_host = None
            self._parked.clear()    # pages already released at suspend
            for row in list(active):
                self._finish(row, active, free_rows)
            # Updates still queued apply here, under the lock a new one
            # takes, so no waiter is stranded by a dying loop.
            with self._loop_lock:
                self._loop_active = False
                self._apply_pending_weight_updates()

    def _flush_streams(self, active: Dict[int, _Row]) -> None:
        """Pass each streaming row's not-yet-streamed tokens to its
        ``Request.on_tokens``; a raising callback is disarmed (it costs
        its stream, never the request)."""
        for row in active.values():
            cb = row.req.on_tokens
            n = len(row.out)
            if cb is None or n <= row.streamed:
                continue
            chunk = [int(t) for t in row.out[row.streamed:n]]
            off = row.streamed
            row.streamed = n
            try:
                cb(chunk, off)
            except Exception:
                row.req.on_tokens = None

    # -- admission --------------------------------------------------------

    @torch.no_grad()
    def _init_prefix(self, prefix: np.ndarray) -> None:
        """Reserve pages for the static shared prefix and prefill it once
        into each side's pool (the draft's too when speculating): rows
        then map the full pages read-only, and a partial last page is
        kept as a template copied into each row's first own page."""
        if prefix.ndim != 1 or prefix.size == 0:
            raise ValueError("prefix must be a non-empty 1-D token array")
        if prefix.size >= self.max_len:
            raise ValueError(f"prefix ({prefix.size} tokens) leaves no "
                             f"room under max_len ({self.max_len})")
        lo, hi = int(prefix.min()), int(prefix.max())
        if lo < 0 or hi >= self.cfg.vocab_size:
            raise ValueError(f"prefix token ids must lie in [0, "
                             f"{self.cfg.vocab_size}), got [{lo}, {hi}]")
        self.prefix_len = int(prefix.size)
        full = self.prefix_len // self.page_size
        tail = self.prefix_len % self.page_size
        n_reserve = full + (1 if tail else 0)
        toks = torch.as_tensor(prefix, device=self.device).long()[None]
        for side, cfg, params in self._sides():
            pages = [side.alloc.reserve_page() for _ in range(n_reserve)]
            table = np.full((1, side.np_max), side.sink, np.int32)
            table[0, :n_reserve] = pages
            # Every data shard prefills its own sub-pool (the same
            # local page ids in each).
            decode_step(cfg, params, dict(side.pool, pages=torch.as_tensor(
                table, device=self.device)), toks, 0, mesh=self._tp_mesh)
            if tail:
                side.tail_template = pages[-1]
                side.shared_pages = pages[:-1]
            else:
                side.shared_pages = pages
            side.shared_len = len(side.shared_pages) * self.page_size
            side.dirty()

    def _sides(self) -> List[Tuple[_PagedSide, TransformerConfig, Params]]:
        """(side, config, params) of the target and, when speculating,
        the draft."""
        out = [(self.t_side, self.cfg, self.params)]
        if self.d_side is not None:
            out.append((self.d_side, self.draft_cfg, self.draft_params))
        return out

    def _worst_pages(self, req: Request) -> Tuple[int, int, int]:
        """Worst-case OWN pages of ``req`` beyond the shared prefix pages
        on each side, and the absolute position cap they cover: ``(target,
        draft, need_len)`` (draft 0 without speculation); ``ValueError``
        if it can never be served."""
        lo, hi = int(req.prompt.min()), int(req.prompt.max())
        if lo < 0 or hi >= self.cfg.vocab_size:
            # Checked here: on the card an out-of-range id is a device-side
            # assert that takes the whole CUDA context down.
            raise ValueError(f"prompt token ids must lie in [0, "
                             f"{self.cfg.vocab_size}), got [{lo}, {hi}]")
        width = -(-req.prompt.size // self.prefill_bucket) * \
            self.prefill_bucket
        need_len = self.prefix_len + max(
            width, req.prompt.size + req.max_new_tokens - 1)
        if self.draft_cfg is not None:
            # A round at the final position still verifies k+1 tokens.
            need_len += self.n_draft
        if self.overlap or self._pipelined:
            if self.draft_cfg is not None:
                # Any ending surfaces a round late, and the overshoot
                # round writes up to n_draft + 1 more positions.
                need_len += self.n_draft + 1
            elif req.stop_token is not None:
                # A stop is seen a block late: one position past it.
                need_len += 1
        if need_len > self.max_len:
            raise ValueError(
                f"request needs {need_len} cache positions (prefix "
                f"{self.prefix_len} + prompt {req.prompt.size} padded to "
                f"{width}, plus {req.max_new_tokens} new tokens) > "
                f"max_len ({self.max_len})")
        wt = -(-(need_len - self.t_side.shared_len) // self.page_size)
        wd = 0
        if self.d_side is not None:
            wd = -(-(need_len - self.d_side.shared_len) // self.page_size)
        return wt, wd, need_len

    def _req_digests(self, req: Request) -> list:
        """Chain digests of ``req``'s complete page-aligned prompt
        chunks, memoized on the request (keyed by the chunk geometry)."""
        pc = self._pcache
        key = (pc.page_size, pc.first, pc.seed)
        memo = getattr(req, "_pfx_digests", None)
        if memo is None or memo[0] != key:
            memo = (key, _ph.prompt_digests(req.prompt, pc.page_size,
                                            pc.first, pc.seed))
            req._pfx_digests = memo
        return memo[1]

    def _prefix_plan(self, req: Request, shard: int = 0,
                     max_nodes: Optional[int] = None
                     ) -> Optional[_PrefixPlan]:
        """The longest USABLE cached prefix for ``req`` (at most
        ``max_nodes`` pages): the trie match, trimmed until the uncached
        tail's padded prefill window fits the page table and, in chunked
        mode, starts on the chunk grid.  A page-aligned full hit keeps
        its deepest page and marks it COW."""
        digs = self._req_digests(req)
        if not digs:
            return None
        nodes = self._pcache.match(shard, digs)
        if not nodes:
            return None
        E = self.prefix_len + int(req.prompt.size)
        sl = self.t_side.shared_len
        ps, bucket = self.page_size, self.prefill_bucket
        n = len(nodes)
        if max_nodes is not None:
            n = min(n, max_nodes)
            if not n:
                return None
        if self.prefill_chunk is not None:
            c = self.prefill_chunk
            while n and (sl + n * ps > E - 1
                         or (sl + n * ps - self.prefix_len) % c):
                n -= 1
            return _PrefixPlan(nodes[:n], False, sl + n * ps) if n else None
        while n:
            cow = sl + n * ps >= E
            ts = E - 1 if cow else sl + n * ps
            w = -(-(E - ts) // bucket) * bucket
            if ts + w <= self.np_max * ps:
                return _PrefixPlan(nodes[:n], cow, ts)
            n -= 1
        return None

    def _admit_row(self, free_rows: List[int], active: Dict[int, _Row],
                   wt: int, wd: int, req: Request, use_cache: bool = True
                   ) -> Tuple[Optional[int], Optional[_PrefixPlan]]:
        """Pop a free row whose shard's pool(s) can take each worst-case
        reservation (``wt`` target, ``wd`` draft pages), preferring the
        shard with the longest prefix-cache plan for ``req`` (pages are
        shard-pinned), then the most target headroom (one shard: a
        headroom check): ``(row, plan)``, or ``(None, None)`` to wait.
        Raises when a free row's shard has nothing in flight and still
        cannot fit (waiting would deadlock)."""
        best = None
        empty_shard = None
        by_shard: Dict[int, tuple] = {}
        for i, r in enumerate(free_rows):
            s = self.t_side.shard_of(r)
            if s not in by_shard:
                by_shard[s] = self._shard_fit(s, active, wt, wd, req,
                                              use_cache)
            ok, ht, plan = by_shard[s]
            if ok:
                key = (plan.save if plan is not None else 0, ht)
                if best is None or key > best[1]:
                    best = (i, key, plan)
            elif not any(self.t_side.shard_of(rr) == s for rr in active):
                empty_shard = s
        if best is not None:
            return free_rows.pop(best[0]), best[2]
        if empty_shard is not None:
            s = empty_shard
            free = self.t_side.shard_alloc(s).free_count()
            if self._pcache is not None:
                free += self._pcache.reclaimable(s)
            free_d = (0 if self.d_side is None
                      else self.d_side.shard_alloc(s).free_count())
            where = f" in shard {s}" if self.n_shards > 1 else ""
            raise RuntimeError(
                f"request needs {wt} target pages (+ {wd} draft) but only "
                f"{free} target / {free_d} draft are free{where} with "
                f"nothing in flight to wait for — raise n_pages")
        return None, None

    def _shard_fit(self, s: int, active: Dict[int, _Row], wt: int, wd: int,
                   req: Request, use_cache: bool
                   ) -> Tuple[bool, int, Optional[_PrefixPlan]]:
        """``(fits, target headroom, plan)`` of an admission into shard
        ``s``, with the longest prefix-cache plan that fits."""
        ht = self.t_side.headroom(active, lambda x: x.worst_pages, s)
        hd = (self.d_side.headroom(active, lambda x: x.worst_draft, s)
              if self.d_side is not None else None)
        plan = (self._prefix_plan(req, s)
                if self._pcache is not None and use_cache else None)
        while True:
            save = plan.save if plan is not None else 0
            # headroom() counts zero-ref cached pages as reclaimable, but
            # a plan that maps them makes them unevictable for this very
            # admission: discounting wt by the plan's saving AND counting
            # them free would over-admit (a "page pool exhausted" crash
            # out of the serve loop).  Twin nodes save as many draft
            # pages.
            zref = (sum(1 for n in plan.nodes if n.ref == 0)
                    if plan is not None else 0)
            ok = (wt - save) <= ht - zref
            if ok and hd is not None:
                ok = (wd - save) <= hd - zref
            if ok or plan is None:
                return ok, ht, plan
            # A deep plan that does not fit (a COW full hit needs a fresh
            # page on top of every mapped one) retries shallower, down to
            # the cold admission, which evicts unused cached pages.
            depth = len(plan.nodes) - 1
            plan = (self._prefix_plan(req, s, max_nodes=depth)
                    if depth else None)

    def _sample(self, last: torch.Tensor, rids: torch.Tensor,
                steps: torch.Tensor) -> torch.Tensor:
        """[n, V] logits -> [n] tokens: the float32 argmax, or a draw
        under each row's key ``fold_in(fold_in(rng, rid), step)``, folded
        on the device (inside the graphs)."""
        if self.temperature <= 0.0:
            return torch.argmax(last.float(), dim=-1)
        keys = prng.fold_in(prng.fold_in(self._rng, rids), steps)
        return sample_logits(last, keys, self.temperature, self.top_k,
                             self.top_p)

    @torch.no_grad()
    def _ensure_sides(self, row: int, length: int) -> None:
        """Back ABSOLUTE positions [0, length) of ``row`` on the target
        (and, speculating, the draft) side.  The first time a row gains
        own pages, a static prefix's partial last page is copied into its
        first own page, before any row write can land there (a row
        holding cached prefix pages skips it: its first own page covers
        a later range)."""
        for side, _, _ in self._sides():
            fresh = side.alloc.allocated(row) == 0
            side.ensure(row, length)
            if (side.tail_template is not None and fresh
                    and not side.row_cached.get(row)
                    and side.alloc.allocated(row) and self._owns(row)):
                _copy_page(side.pool, side.tail_template,
                           side.alloc.rows[row][0])

    @torch.no_grad()
    def _admit_dispatch(self, row: int, rid: int, req: Request, wt: int,
                        wd: int, need: int, active: Dict[int, _Row],
                        plan: Optional[_PrefixPlan] = None
                        ) -> Optional[tuple]:
        """Reserve pages for ``req`` in ``row`` and dispatch its prefill
        (one call at the padded width, or the uncached tail of a
        prefix-cache ``plan``; the draft's prompt chunk beside it when
        speculating); the first token stays on the device until the
        burst syncs.  Chunked mode makes no call here (the loop writes a
        chunk a tick) and returns None."""
        t_admit = time.perf_counter()
        self._trace_event(req, "admit", rid=rid, row=row,
                          prompt_len=int(req.prompt.size),
                          cached=plan is not None)
        length = req.prompt.size
        width = -(-length // self.prefill_bucket) * self.prefill_bucket
        if plan is not None:
            # Map the cached pages read-only BEFORE any ensure(): the
            # references protect them from the evictor.
            self._pcache.acquire(row, plan.nodes)
            self._pcache.count("hits")
            self._pcache.count("hit_pages", len(plan.nodes))
            self._pcache.count("hit_tokens",
                               plan.tail_start - self.prefix_len)
            wt -= plan.save
            if self.d_side is not None:
                wd -= plan.save
        elif self._pcache is not None and self._req_digests(req):
            self._pcache.count("misses")
        if self.prefill_chunk is not None:
            self._ensure_sides(row, self.prefix_len + width)
            padded = np.zeros((width,), np.int32)
            padded[:length] = req.prompt
            active[row] = _Row(
                rid=rid, req=req, pos=self.prefix_len + length, step=1,
                last=0, out=[], worst_pages=wt, worst_draft=wd,
                t_admit=t_admit, padded=padded,
                filled=(0 if plan is None
                        else plan.tail_start - self.prefix_len),
                decoding=False, limit=need)
            return None
        if plan is not None:
            return self._admit_cached(row, rid, req, wt, wd, need, active,
                                      plan, t_admit)
        self._ensure_sides(row, self.prefix_len + width)
        tok = self._prefill_call(row, req.prompt, width, rid)
        if self.d_side is not None:
            padded = np.zeros((width,), np.int32)
            padded[:length] = req.prompt
            self._draft_chunk_call(row, padded, self.prefix_len)
        self.prefills += 1
        state = _Row(rid=rid, req=req, pos=self.prefix_len + length,
                     step=1, last=0, out=[], worst_pages=wt,
                     worst_draft=wd, t_admit=t_admit, limit=need)
        active[row] = state
        self._pcache_insert(row, state)
        return row, state, tok

    def _admit_cached(self, row: int, rid: int, req: Request, wt: int,
                      wd: int, need: int, active: Dict[int, _Row],
                      plan: _PrefixPlan, t_admit: float) -> tuple:
        """Admission over a mapped cached prefix: prefill ONLY the
        uncached tail at its true offset (cache attention through the
        paged kernel; the draft's tail too when speculating) and sample
        the first token at the prompt's last position.  A page-aligned
        full hit first copies the deepest cached page (and its draft
        twin) into a fresh own page, so the last-token rewrite never
        touches shared state."""
        E = self.prefix_len + int(req.prompt.size)
        if plan.cow:
            node = plan.nodes[-1]
            self._pcache.unmap_last(row)
            for side, _, _ in self._sides():
                side.ensure(row, side.shared_len
                            + len(plan.nodes) * self.page_size)
                src = node.page if side is self.t_side else node.dpage
                if self._owns(row):
                    _copy_page(side.pool, src, side.alloc.rows[row][0])
            # The reference protected the source through the ensure()
            # above; the copy is enqueued, so it may go now.
            self._pcache.release_nodes(row, [node])
            self._pcache.count("cow_copies")
        ts = plan.tail_start
        tlen = E - ts
        w = -(-tlen // self.prefill_bucket) * self.prefill_bucket
        # Allocation clamps at the reservation: pad positions past
        # ``need`` land in reserved-but-unread slots or on sink columns.
        self._ensure_sides(row, min(ts + w, need))
        padded = np.zeros((w,), np.int32)
        padded[:tlen] = req.prompt[req.prompt.size - tlen:]
        tok = self._chunk_call(row, padded, ts, tlen - 1, rid)
        if self.d_side is not None:
            self._draft_chunk_call(row, padded, ts)
        self.tail_prefills += 1
        state = _Row(rid=rid, req=req, pos=E, step=1, last=0, out=[],
                     worst_pages=wt, worst_draft=wd, t_admit=t_admit,
                     limit=need)
        active[row] = state
        self._pcache_insert(row, state)
        return row, state, tok

    def _staging(self, *shape: int, dtype=torch.long) -> torch.Tensor:
        """A fresh host buffer for one host-to-device copy (pinned on the
        card: the caching host allocator keeps it until the copy ran)."""
        return torch.zeros(shape, dtype=dtype, pin_memory=self._pin)

    def _prefill_call(self, row: int, prompt: np.ndarray, width: int,
                      rid: int) -> torch.Tensor:
        """The admission prefill of ``prompt`` padded to ``width`` into
        ``row``'s pages, from an empty cache: one graph a prompt width,
        its inputs (tokens, ``length - 1``, rid, the row's table) in one
        copy from pinned memory.  Returns the first token (sampled at
        step 0) on the device."""
        inp, out = self._prefill_buffers(width)
        host = self._staging(width + 2 + self.np_max)
        h = host.numpy()
        h[:prompt.size] = prompt
        h[width:width + 2] = (prompt.size - 1, rid)
        h[width + 2:] = self.t_side.table_np()[row]
        inp.copy_(host, non_blocking=True)
        if self._owns(row):
            self.prefills_here += 1
            self._graphs.run(("prefill", width),
                             functools.partial(self._prefill_step, width))
        self._share(out, row)
        return out.clone()[0]

    def _prefill_buffers(self, width: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        if width not in self._prefill_bufs:
            self._prefill_bufs[width] = (
                torch.zeros((width + 2 + self.np_max,), dtype=torch.long,
                            device=self.device),
                torch.zeros((1,), dtype=torch.long, device=self.device))
        return self._prefill_bufs[width]

    @torch.no_grad()
    def _prefill_step(self, width: int) -> None:
        """The admission prefill over its static buffers (what a graph
        holds): ``pos`` is the python int ``prefix_len``: 0 is a prefill
        from empty, after a static prefix a chunk over the paged pool."""
        inp, out = self._prefill_bufs[width]
        table = inp[width + 2:].to(torch.int32)[None]
        logits, _ = decode_step(self.cfg, self.params,
                                dict(self.pool, pages=table),
                                inp[:width][None], self.prefix_len,
                                mesh=self._tp_mesh)
        last = logits[0].index_select(0, inp[width:width + 1])
        rid = inp[width + 1:width + 2]
        out.copy_(self._sample(last, rid, torch.zeros_like(rid)))

    def _chunk_width(self, pos: int, t: int) -> int:
        return self.chunk_width(pos, t, self.page_size, self.np_max)

    @staticmethod
    def chunk_width(pos: int, t: int, page_size: int, np_max: int) -> int:
        """The table width a chunk call at ``pos`` of ``t`` tokens takes:
        a decode width (``_decode_widths``) whose columns cover every
        position the chunk writes, so none clamps onto a live page."""
        cols = -(-(pos + t) // page_size)
        return _PagedSide.width_for(max(cols - 1, 1), np_max)

    def _chunk_buffers(self, t: int, w: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The chunk step's static input (tokens, pos, cap, rid, the
        row's table) and output buffers at (``t``, ``w``), allocated at
        first use."""
        if (t, w) not in self._chunk_bufs:
            self._chunk_bufs[(t, w)] = (
                torch.zeros((t + 3 + w,), dtype=torch.long,
                            device=self.device),
                torch.zeros((1,), dtype=torch.long, device=self.device))
        return self._chunk_bufs[(t, w)]

    def _chunk_call(self, row: int, tokens: np.ndarray, pos: int,
                    cap: int, rid: int) -> torch.Tensor:
        """One call of ``decode_step`` over the pool for ``row``'s chunk
        ``tokens`` [t] at position ``pos``: its K/V ride the paged
        kernel's self operand and are committed once; returns the token
        sampled at chunk index ``cap`` (clamped into the chunk) on the
        device.  The inputs and the row's table travel in one copy from
        pinned memory into static buffers; the call is a graph a (chunk
        tokens, table width): the chunked-prefill width, and each
        prefix-cache tail width."""
        t = int(tokens.size)
        w = self._chunk_width(pos, t)
        inp, out = self._chunk_buffers(t, w)
        host = self._staging(t + 3 + w)
        h = host.numpy()
        h[:t] = tokens
        h[t:t + 3] = (pos, cap, rid)
        h[t + 3:] = self.t_side.table_np()[row, :w]
        inp.copy_(host, non_blocking=True)
        if self._owns(row):
            self._graphs.run(("chunk", t, w),
                             functools.partial(self._chunk_step, t, w))
        self._share(out, row)
        return out.clone()

    @torch.no_grad()
    def _chunk_step(self, t: int, w: int) -> None:
        """The chunk call over its static buffers (what a graph holds)."""
        inp, out = self._chunk_bufs[(t, w)]
        table = inp[t + 3:].to(torch.int32)[None]
        logits, _ = decode_step(self.cfg, self.params,
                                dict(self.pool, pages=table),
                                inp[:t][None], inp[t:t + 1],
                                mesh=self._tp_mesh)
        last = logits[0].index_select(0, inp[t + 1:t + 2].clamp(0, t - 1))
        rid = inp[t + 2:t + 3]
        out.copy_(self._sample(last, rid, torch.zeros_like(rid)))

    def _draft_chunk_call(self, row: int, tokens: np.ndarray,
                          pos: int) -> None:
        """Write ``row``'s prompt chunk ``tokens`` [t] at ``pos`` into the
        DRAFT pool (the whole prompt, a prefill chunk or a tail, in
        lockstep with the target's): ``decode_step`` of the draft over
        its np_max-wide table, a graph a chunk width."""
        t = int(tokens.size)
        inp = self._dchunk_buffer(t)
        host = self._staging(t + 1 + self.np_max)
        h = host.numpy()
        h[:t] = tokens
        h[t] = pos
        h[t + 1:] = self.d_side.table_np()[row]
        inp.copy_(host, non_blocking=True)
        if self._owns(row):
            self._graphs.run(("draft_chunk", t),
                             functools.partial(self._draft_chunk_step, t))

    def _dchunk_buffer(self, t: int) -> torch.Tensor:
        if t not in self._dchunk_bufs:
            self._dchunk_bufs[t] = torch.zeros(
                (t + 1 + self.np_max,), dtype=torch.long,
                device=self.device)
        return self._dchunk_bufs[t]

    @torch.no_grad()
    def _draft_chunk_step(self, t: int) -> None:
        """The draft chunk over its static buffer (what a graph holds)."""
        inp = self._dchunk_bufs[t]
        table = inp[t + 1:].to(torch.int32)[None]
        decode_step(self.draft_cfg, self.draft_params,
                    dict(self.dpool, pages=table), inp[:t][None],
                    inp[t:t + 1], mesh=self._tp_mesh)

    def _pcache_insert(self, row: int, state: _Row) -> None:
        """Publish ``row``'s freshly prefilled full prompt pages into the
        prefix cache (no-op without one)."""
        if self._pcache is None:
            return
        digs = self._req_digests(state.req)
        if digs:
            self._pcache.insert_row(row, self.t_side.shard_of(row), digs,
                                    state)

    def _finalize_burst(self, burst: list, active: Dict[int, _Row],
                        free_rows: List[int]) -> Iterator[Completion]:
        """Fetch every admission's first token in one host sync (an
        import's is already on the host) and yield the requests that
        already finished.  Clears ``burst``."""
        if not burst:
            return
        # A prefill's token is a scalar, a chunk call's (a prefix-cache
        # or session tail) a [1] vector: one burst may hold both.
        dev = [tok.reshape(1) for _, _, tok in burst
               if isinstance(tok, torch.Tensor)]
        synced = iter(torch.cat(dev).tolist() if dev else ())
        toks = [next(synced) if isinstance(tok, torch.Tensor) else tok
                for _, _, tok in burst]
        now = time.perf_counter()
        for (row, state, _), tok in zip(burst, toks):
            state.t_first = now
            if state.out:
                continue    # a resumed import: its stream is in place
            state.last = tok
            state.out = [tok]
            if tok == state.req.stop_token or state.req.max_new_tokens == 1:
                done = self._completion(state)
                self._finish_completed(row, active, free_rows)
                yield done
        burst.clear()

    @torch.no_grad()
    def _advance_prefill(self, active: Dict[int, _Row]) -> Optional[int]:
        """Write ONE chunk of the oldest still-filling row; it turns to
        decoding once its whole padded prompt is in (the only chunk whose
        token is synced).  Returns the row when that finished its
        request outright (first token the stop, or max_new_tokens 1)."""
        filling = [(row.rid, r) for r, row in active.items()
                   if not row.decoding]
        if not filling:
            return None
        _, r = min(filling)
        row = active[r]
        c = self.prefill_chunk
        chunk = row.padded[row.filled:row.filled + c]
        cap = row.req.prompt.size - 1 - row.filled
        pos = self.prefix_len + row.filled
        tok = self._chunk_call(r, chunk, pos, cap, row.rid)
        if self.d_side is not None:
            # The draft's chunks advance in lockstep, so it can propose
            # the moment the row turns to decoding.
            self._draft_chunk_call(r, chunk, pos)
        self.prefill_chunks += 1
        row.filled += c
        if row.filled < row.padded.size:
            return None
        tok = int(tok.item())
        row.t_first = time.perf_counter()
        row.last = tok
        row.out.append(tok)
        row.decoding = True
        # Published only now: before, a concurrent hit would have mapped
        # pages whose chunks were not written yet.
        self._pcache_insert(r, row)
        if tok == row.req.stop_token or row.req.max_new_tokens == 1:
            return r
        return None

    # -- decode -----------------------------------------------------------

    def _put_table(self, table: np.ndarray, store=None) -> torch.Tensor:
        """The device table of ``table``'s width in ``store`` (the
        target's tables by default, ``_dtables`` the draft's), holding
        ``table``: copied only when the host table changed, from a fresh
        staging buffer (under a lag the previous table's copy may still
        wait behind a block in flight)."""
        store = self._tables if store is None else store
        w = table.shape[1]
        held, dev = store.get(w, (None, None))
        if dev is None:
            dev = torch.zeros((self.rows, w), dtype=torch.int32,
                              device=self.device)
        if held is not table:
            host = self._staging(self.rows, w, dtype=torch.int32)
            host.numpy()[:] = table
            dev.copy_(host, non_blocking=True)
        store[w] = (table, dev)
        return dev

    def _decode_table(self, active: Optional[Dict[int, _Row]] = None,
                      decoding: Optional[Dict[int, _Row]] = None
                      ) -> torch.Tensor:
        return self._put_table(self.t_side.decode_table(active, decoding))

    @torch.no_grad()
    def _tick(self, width: int) -> None:
        """The decode block over the static buffers (what a graph holds):
        every row's next ``multi_step`` tokens into ``_tick_out``.  Under
        a lag the flag row of ``_tick_in`` marks the rows that take the
        host's values; every other row continues on the device: under
        ``overlap`` from the previous block's last token, still in
        ``_tick_out``; under the pipeline from the device carry, which
        the block then advances (clamped at ``max_len + K``)."""
        inp = self._local(self._tick_in, 1)
        tok, pos, rids, steps = inp[0], inp[1], inp[2], inp[3]
        flag = inp[4].bool()
        K = self.multi_step
        if self._pipelined:
            carry = self._local(self._carry, 1)
            tok = torch.where(flag, tok, carry[0])
            pos = torch.where(flag, pos, carry[1])
            steps = torch.where(flag, steps, carry[2])
        elif self.overlap:
            tok = torch.where(flag, tok, self._local(self._tick_out)[:, -1])
        cache = dict(self.pool, pages=self._local(self._tables[width][1]))
        out = []
        for j in range(K):
            logits, _ = decode_step(self.cfg, self.params, cache,
                                    tok[:, None],
                                    torch.clamp(pos + j, max=self.max_len),
                                    mesh=self._tp_mesh)
            tok = self._sample(logits[:, -1], rids, steps + j)
            out.append(tok)
        self._put_rows(self._tick_out, torch.stack(out, dim=1))
        if self._pipelined:
            cap = self.max_len + K
            carry[0].copy_(tok)
            carry[1].copy_(torch.clamp(pos + K, max=cap))
            carry[2].copy_(torch.clamp(steps + K, max=cap))

    def _fetch(self, src: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """Start copying ``src`` to a fresh host buffer; returns it and
        the event its copy completes (None on the CPU, where the copy
        already has)."""
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=self._pin)
        host.copy_(src, non_blocking=True)
        if self.device.type != "cuda":
            return host, None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event

    @staticmethod
    def _read(fetched: Tuple[torch.Tensor, Any]) -> np.ndarray:
        """Wait for a :meth:`_fetch` copy (its own event, never the whole
        stream) and return its values."""
        host, event = fetched
        if event is not None:
            event.synchronize()
        return host.numpy()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _block_inputs(self, rows: Dict[int, _Row]) -> torch.Tensor:
        """The host staging of a synchronous block: each row's last
        token, position, rid and step (no merge flags)."""
        host = self._staging(5, self.rows)
        h = host.numpy()
        for r, row in rows.items():
            h[:4, r] = (row.last, row.pos, row.rid, row.step)
        return host

    def _commit_block(self, r: int, row: _Row, toks, active: Dict[int, _Row],
                      free_rows: List[int], lagged: bool = False
                      ) -> Optional[Completion]:
        """Append a row's block ``toks`` up to its stop or quota (the
        rest of the block is discarded); returns its Completion when it
        finished.  A synchronous block advances ``pos`` and ``step``
        here, a lagged one advanced them at dispatch."""
        for tok in toks:
            tok = int(tok)
            row.out.append(tok)
            row.last = tok
            self.decode_tokens += 1
            if not lagged:
                row.step += 1
                row.pos += 1
            if tok == row.req.stop_token or \
                    len(row.out) >= row.req.max_new_tokens:
                done = self._completion(row)
                self._finish_completed(r, active, free_rows)
                return done
        return None

    def _step(self, active: Dict[int, _Row],
              free_rows: List[int]) -> Iterator[Completion]:
        """One K-step block (``multi_step``; K = 1 the per-token tick):
        every decoding row advances K tokens in one batched call (a
        graph replay on the card) and the host syncs one [rows, K] block.
        A row that stops or meets its quota mid-block keeps the tokens up
        to there; its later in-block writes landed inside its clamped
        reservation or on sink columns.  Other rows ride along at
        position 0 on sink table rows (a still-filling row's pages belong
        to its chunks)."""
        K = self.multi_step
        decoding = {r: row for r, row in active.items() if row.decoding}
        for r, row in decoding.items():
            self._ensure_sides(r, min(row.pos + K, row.limit))
        host = self._block_inputs(decoding)
        width = self._decode_table(active, decoding).shape[1]
        t0 = time.perf_counter()
        self._tick_in.copy_(host, non_blocking=True)
        self._graphs.run(width, functools.partial(self._tick, width))
        nxt = self._read(self._fetch(self._tick_out))
        self.decode_seconds += time.perf_counter() - t0
        self.decode_ticks += 1
        for r in list(decoding):
            done = self._commit_block(r, active[r], nxt[r], active,
                                      free_rows)
            if done is not None:
                yield done

    def _dispatch_set(self, active: Dict[int, _Row]) -> Dict[int, _Row]:
        """The rows a lagged block decodes: decoding, quota not yet
        dispatched (the host's ``step`` runs a block ahead)."""
        return {r: row for r, row in active.items()
                if row.decoding and row.step < row.req.max_new_tokens}

    def _step_lagged(self, active: Dict[int, _Row],
                     free_rows: List[int]) -> Iterator[Completion]:
        """One lagged block (``overlap``, or ``pipeline_depth=1``):
        dispatch the next K-step block before syncing the previous one.
        A row that was in the previous block continues on the device
        (overlap: from its last token; the pipeline: from the carry of
        token, position and step); the rest take the host's values (the
        flag row).  ``pos`` and ``step`` advance at dispatch, while
        ``out``, ``last`` and stop detection wait for :meth:`_retire`,
        one block late.  Overlap uploads its host inputs every block;
        the pipeline only when the dispatch set changes — the ticket
        plus its fresh rows — so a steady-state block uploads nothing.
        Streams are the synchronous batcher's: the same ops on the same
        inputs, only the sync point moves."""
        K = self.multi_step
        dispatch = self._dispatch_set(active)
        prev = self._inflight
        t0 = time.perf_counter()
        if dispatch:
            prev_ticket = {} if prev is None else prev[1]
            ticket = {r: row.rid for r, row in dispatch.items()}
            # Rows entering from host values: fresh admissions, chunk
            # flips, re-admissions into a freed row; rows outside the
            # block ride along on zeros.
            fresh = frozenset(r for r, rid in ticket.items()
                              if prev_ticket.get(r) != rid)
            for r, row in dispatch.items():
                self._ensure_sides(r, min(row.pos + K, row.limit))
            width = self._decode_table(active, dispatch).shape[1]
            key = (tuple(sorted(ticket.items())), fresh)
            if not self._pipelined or self._pipe_host != key:
                host = self._staging(5, self.rows)
                h = host.numpy()
                h[4] = 1
                for r, row in dispatch.items():
                    h[:4, r] = (row.last, row.pos, row.rid, row.step)
                    h[4, r] = r in fresh
                self._tick_in.copy_(host, non_blocking=True)
                self._pipe_host = key if self._pipelined else None
            if self._pipelined and self._pipe_carry is None:
                self._carry.zero_()          # pipeline start
                self._pipe_carry = self._carry
            self._graphs.run(width, functools.partial(self._tick, width))
            self._inflight = (self._fetch(self._tick_out), ticket)
            self.decode_ticks += 1
            for row in dispatch.values():
                row.pos += K
                row.step += K
        else:
            self._inflight = None
            self._pipe_carry = self._pipe_host = None
        if prev is not None:
            yield from self._retire(prev, active, free_rows, t0)
        else:
            self.decode_seconds += time.perf_counter() - t0

    def _retire(self, inflight, active: Dict[int, _Row],
                free_rows: List[int], t0: float) -> Iterator[Completion]:
        """Sync one lagged block (a block behind the newest) and commit
        its tokens; a row that finished at an earlier retire, or was
        re-admitted since, fails the rid check and its block is
        dropped."""
        fetched, ticket = inflight
        nxt = self._read(fetched)
        self.decode_seconds += time.perf_counter() - t0
        for r, rid in ticket.items():
            row = active.get(r)
            if row is None or row.rid != rid:
                continue            # the overshoot block of a freed row
            done = self._commit_block(r, row, nxt[r], active, free_rows,
                                      lagged=True)
            if done is not None:
                yield done

    # -- speculative decoding ----------------------------------------------

    @torch.no_grad()
    def _spec_body(self, toks: torch.Tensor, positions: torch.Tensor,
                   rids: torch.Tensor, steps: torch.Tensor,
                   table: torch.Tensor, dtable: torch.Tensor):
        """One speculative round over every row: k+1 draft steps over the
        draft pool (the extra one writes the last proposal's K/V, so a
        fully accepted round leaves no hole), then the (k+1)-token verify
        over the target pool.  Returns the commit candidates [rows, k+1]
        and each row's commit count.  Greedy: the target's argmax tokens
        and the leading-match count.  Sampled: Leviathan rejection, the
        proposal j drawn under ``fold(rid, step + j)`` (the stream the
        target-only batcher draws from), its acceptance under
        ``fold_in(fold(rid, step + j), 1)``, the correction at the first
        rejection a under ``fold_in(fold(rid, step + a), 2)``."""
        k = self.n_draft
        sampling = self.temperature > 0.0
        T, top_k, top_p = self.temperature, self.top_k, self.top_p
        base = prng.fold_in(self._rng, rids) if sampling else None
        dcache = dict(self.dpool, pages=dtable)
        dtok, dpos = toks, positions
        drafts, pds = [], []
        for j in range(k + 1):
            lg, _ = decode_step(self.draft_cfg, self.draft_params, dcache,
                                dtok[:, None], dpos, mesh=self._tp_mesh)
            if sampling:
                f = filter_logits(lg[:, -1], T, top_k, top_p)
                dtok = prng.categorical(prng.fold_in(base, steps + j), f)
                pds.append(torch.softmax(f, dim=-1))
            else:
                dtok = torch.argmax(lg[:, -1].float(), dim=-1)
            drafts.append(dtok)
            dpos = dpos + 1
        drafts = torch.stack(drafts[:k], dim=1)              # [rows, k]
        lg, _ = decode_step(self.cfg, self.params,
                            dict(self.pool, pages=table),
                            torch.cat([toks[:, None], drafts], dim=1),
                            positions, mesh=self._tp_mesh)
        if not sampling:
            g = torch.argmax(lg.float(), dim=-1)             # [rows, k+1]
            return g, greedy_accept_counts(drafts, g)
        pt = torch.softmax(filter_logits(lg, T, top_k, top_p), dim=-1)
        j = torch.arange(k, device=toks.device)
        # The salts as device scalars: a python int would be copied from
        # the host, which a graph capture refuses.
        salt = steps.new_ones(())
        ukeys = prng.fold_in(prng.fold_in(base[:, None],
                                          steps[:, None] + j[None]), salt)
        a, dist = rejection_accept(drafts, torch.stack(pds[:k], dim=1),
                                   pt, prng.uniform(ukeys, ()))
        repl = prng.categorical(
            prng.fold_in(prng.fold_in(base, steps + a), salt + 1),
            torch.log(dist + 1e-20))
        cand = torch.cat([drafts, drafts.new_zeros((drafts.shape[0], 1))],
                         dim=1)
        jj = torch.arange(k + 1, device=toks.device)[None]
        return torch.where(jj == a[:, None], repl[:, None], cand), a + 1

    @torch.no_grad()
    def _spec_step(self, tw: int, dw: int) -> None:
        """The speculative dispatch over its static buffers (what a graph
        holds).  Synchronous: R rounds chained in the graph, each from
        the previous round's last committed token, positions and steps
        advanced by its counts, into ``_spec_g`` / ``_spec_n``.  Under
        ``overlap`` one round, where the rows the flag row marks continue
        from the previous round's carry on the device (its last committed
        token, position + count, step + count); the round's candidates,
        counts, positions and steps become the next carry."""
        inp = self._local(self._tick_in, 1)
        toks, positions, rids, steps = inp[0], inp[1], inp[2], inp[3]
        table = self._local(self._tables[tw][1])
        dtable = self._local(self._dtables[dw][1])
        k1 = self.n_draft + 1
        if self.overlap:
            carry = self._local(self._spec_carry)
            prev_g, prev_n = carry[:, :k1], carry[:, k1]
            use_dev = inp[4].bool()
            last = torch.clamp(prev_n - 1, min=0)
            toks = torch.where(use_dev, torch.take_along_dim(
                prev_g, last[:, None], dim=1)[:, 0], toks)
            positions = torch.where(use_dev, carry[:, k1 + 1] + prev_n,
                                    positions)
            steps = torch.where(use_dev, carry[:, k1 + 2] + prev_n, steps)
            g, counts = self._spec_body(toks, positions, rids, steps, table,
                                        dtable)
            self._put_rows(self._spec_g[0], g)
            self._put_rows(self._spec_n[0], counts)
            carry.copy_(torch.cat([g, counts[:, None], positions[:, None],
                                   steps[:, None]], dim=1))
            return
        for i in range(max(1, self._spec_rounds)):
            g, counts = self._spec_body(toks, positions, rids, steps, table,
                                        dtable)
            self._put_rows(self._spec_g[i], g)
            self._put_rows(self._spec_n[i], counts)
            last = torch.clamp(counts - 1, min=0)
            toks = torch.take_along_dim(g, last[:, None], dim=1)[:, 0]
            positions = positions + counts
            steps = steps + counts

    def _spec_dispatch(self, active: Dict[int, _Row],
                       rows: Dict[int, _Row], host: torch.Tensor
                       ) -> Tuple[int, int]:
        """Upload a round's host inputs and both sides' tables, and run
        the round's graph (keyed by the two table widths, returned)."""
        tw = self._put_table(self.t_side.decode_table(active, rows)
                             ).shape[1]
        dw = self._put_table(self.d_side.decode_table(active, rows),
                             self._dtables).shape[1]
        self._tick_in.copy_(host, non_blocking=True)
        self._graphs.run(("spec", tw, dw),
                         functools.partial(self._spec_step, tw, dw))
        return tw, dw

    def _step_spec(self, active: Dict[int, _Row],
                   free_rows: List[int]) -> Iterator[Completion]:
        """One synchronous speculative dispatch over every decoding row:
        R rounds (``multi_step`` composed), each committing a row's
        accepted run plus the correction, round by round so quota and
        stop truncation stay exact.  Rows without a request ride along
        parked at position ``max_len`` on sink table rows."""
        R = max(1, self._spec_rounds)
        k1 = self.n_draft + 1
        decoding = {r: row for r, row in active.items() if row.decoding}
        host = self._staging(5, self.rows)
        h = host.numpy()
        h[1] = self.max_len
        for r, row in decoding.items():
            # The verify chunk writes [pos, pos + k] (the draft the same
            # range of its pool); R rounds reach R * (k+1), clamped at the
            # reservation: writes past it land on sink columns.
            self._ensure_sides(r, min(row.pos + R * k1, row.limit))
            h[:4, r] = (row.last, row.pos, row.rid, row.step)
        t0 = time.perf_counter()
        self._spec_dispatch(active, decoding, host)
        fetched = self._fetch(self._spec_n)
        g = self._read(self._fetch(self._spec_g))
        n_commit = self._read(fetched)
        self.decode_seconds += time.perf_counter() - t0
        self.decode_ticks += 1
        self.spec_rounds += R
        for i in range(R):
            live = [r for r in decoding if r in active]
            if not live:
                break
            self.spec_committed += int(sum(int(n_commit[i, r])
                                           for r in live))
            self.spec_row_rounds += len(live)
            yield from self._commit_rows(g[i], n_commit[i], live, active,
                                         free_rows)

    def _commit_rows(self, g, nc, rows, active: Dict[int, _Row],
                     free_rows: List[int]) -> Iterator[Completion]:
        """Commit one round's candidates to ``rows`` (the synchronous and
        the overlap loops alike): each row's first ``nc`` tokens, cut at
        its quota and just after a stop token."""
        for r in rows:
            row = active[r]
            emit = [int(t) for t in g[r, :int(nc[r])]]
            emit = emit[:row.req.max_new_tokens - row.step]
            stop = row.req.stop_token
            if stop is not None and stop in emit:
                emit = emit[:emit.index(stop) + 1]
            row.out.extend(emit)
            row.step += len(emit)
            row.pos += len(emit)
            self.decode_tokens += len(emit)
            if emit:
                row.last = emit[-1]
            if row.step >= row.req.max_new_tokens or (
                    stop is not None and row.out and row.out[-1] == stop):
                done = self._completion(row)
                self._finish_completed(r, active, free_rows)
                yield done

    def _step_spec_overlap(self, active: Dict[int, _Row],
                           free_rows: List[int]) -> Iterator[Completion]:
        """One overlap speculative round: dispatch round t before syncing
        round t-1.  Rows of the previous round continue from its carry on
        the device (commit counts are decided there), so the host's
        ``pos`` / ``step`` lag one retire behind and only back pages
        (the round in flight advanced up to k+1, this one writes k+1
        more).  Endings surface a round late; the overshoot round's
        tokens fail the rid-checked ticket and its writes land in the
        row's reserved overshoot or on the sink."""
        k1 = self.n_draft + 1
        dispatch = {r: row for r, row in active.items()
                    if row.decoding and row.step < row.req.max_new_tokens}
        prev = self._inflight
        t0 = time.perf_counter()
        if dispatch:
            prev_ticket = {} if prev is None else prev[2]
            host = self._staging(5, self.rows)
            h = host.numpy()
            h[1] = self.max_len
            for r, row in dispatch.items():
                self._ensure_sides(r, min(row.pos + 2 * k1, self.max_len))
                if prev_ticket.get(r) == row.rid:
                    h[4, r] = 1         # continue from the device carry
                else:
                    h[:4, r] = (row.last, row.pos, row.rid, row.step)
                h[2, r] = row.rid
            self._spec_dispatch(active, dispatch, host)
            self._inflight = (self._fetch(self._spec_g),
                              self._fetch(self._spec_n),
                              {r: row.rid for r, row in dispatch.items()})
            self.decode_ticks += 1
        else:
            self._inflight = None
        if prev is not None:
            yield from self._retire_spec(prev, active, free_rows, t0)
        else:
            self.decode_seconds += time.perf_counter() - t0

    def _retire_spec(self, inflight, active: Dict[int, _Row],
                     free_rows: List[int], t0: float
                     ) -> Iterator[Completion]:
        """Sync one overlap round (a round behind the newest) and commit
        it, rid-gated so a finished row's overshoot round drops.  Only a
        finishing row is ever truncated, so continuing rows advance by
        exactly the device's counts and stay in step with the carry."""
        g_f, n_f, ticket = inflight
        g = self._read(g_f)[0]
        nc = self._read(n_f)[0]
        self.decode_seconds += time.perf_counter() - t0
        live = [r for r, rid in ticket.items()
                if r in active and active[r].rid == rid]
        self.spec_rounds += 1
        self.spec_row_rounds += len(live)
        self.spec_committed += int(sum(int(nc[r]) for r in live))
        yield from self._commit_rows(g, nc, live, active, free_rows)

    # -- the fused prefill + decode tick ----------------------------------

    @staticmethod
    def _pow2(n: int) -> int:
        return 1 << max(0, int(n) - 1).bit_length()

    def _fused_slot_buckets(self) -> List[int]:
        """Every chunk-slot count a fused tick pads to: powers of two up
        to ``rows`` (at most every row is filling)."""
        return sorted({self._pow2(s) for s in range(1, self.rows + 1)})

    def _slot_buffers(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ``n`` chunk slots' static input ([n] rows of the chunk's
        tokens, position, cap, rid and an ``np_max``-wide table) and
        first-token buffers, allocated at first use."""
        if n not in self._slot_bufs:
            c = self.prefill_chunk
            self._slot_bufs[n] = (
                torch.zeros((n, c + 3 + self.np_max), dtype=torch.long,
                            device=self.device),
                torch.zeros((n,), dtype=torch.long, device=self.device))
        return self._slot_bufs[n]

    def _slot_inputs(self, rows: List[Tuple[int, _Row]], n: int
                     ) -> torch.Tensor:
        """Host staging of ``n`` chunk slots: each picked row's next
        chunk at its own offset, the rest dummy slots (all-sink table,
        cap -1: their token is discarded)."""
        c = self.prefill_chunk
        host = self._staging(n, c + 3 + self.np_max)
        h = host.numpy()
        h[:, c + 1] = -1
        h[:, c + 3:] = self.t_side.sink
        tbl = self.t_side.table_np()
        for i, (r, row) in enumerate(rows):
            h[i, :c] = row.padded[row.filled:row.filled + c]
            h[i, c:c + 3] = (self.prefix_len + row.filled,
                             row.req.prompt.size - 1 - row.filled, row.rid)
            h[i, c + 3:] = tbl[r]
        return host

    @torch.no_grad()
    def _fused_step(self, width: int, n: int) -> None:
        """The fused tick over its static buffers (what a graph holds):
        ``n`` chunk slots through ``decode_step`` at [n, chunk], each at
        its own position, their first tokens sampled at their caps;
        then the K-step block."""
        inp, first = self._slot_bufs[n]
        c = self.prefill_chunk
        table = inp[:, c + 3:].to(torch.int32)
        logits, _ = decode_step(self.cfg, self.params,
                                dict(self.pool, pages=table), inp[:, :c],
                                inp[:, c], mesh=self._tp_mesh)
        cap = inp[:, c + 1].clamp(0, c - 1)
        last = torch.take_along_dim(logits, cap[:, None, None], dim=1)[:, 0]
        rids = inp[:, c + 2]
        first.copy_(self._sample(last, rids, torch.zeros_like(rids)))
        self._tick(width)

    def _step_fused(self, active: Dict[int, _Row],
                    free_rows: List[int]) -> Iterator[Completion]:
        """One fused tick: the decode block over every decoding row plus
        up to ``(tokens_per_tick - n_decode * K) // chunk`` chunk slots
        (the oldest filling rows, one chunk each, at least one slot) in
        one dispatch and one host sync.  A row whose last chunk lands
        here turns to decoding with its first token and joins the next
        tick's block; decode commits are :meth:`_step`'s."""
        K = self.multi_step
        c = self.prefill_chunk
        decoding = {r: row for r, row in active.items() if row.decoding}
        filling = sorted((row.rid, r) for r, row in active.items()
                         if not row.decoding)
        slots = max(1, (self.tokens_per_tick - len(decoding) * K) // c)
        picks = [r for _, r in filling[:slots]]
        n = self._pow2(len(picks))
        for r, row in decoding.items():
            self._ensure_sides(r, min(row.pos + K, row.limit))
        host = self._block_inputs(decoding)
        slot_host = self._slot_inputs([(r, active[r]) for r in picks], n)
        width = self._decode_table(active, decoding).shape[1]
        inp, first = self._slot_buffers(n)
        t0 = time.perf_counter()
        self._tick_in.copy_(host, non_blocking=True)
        inp.copy_(slot_host, non_blocking=True)
        self._graphs.run(("fused", width, n),
                         functools.partial(self._fused_step, width, n))
        fetched = self._fetch(first)
        nxt = self._read(self._fetch(self._tick_out))
        firsts = self._read(fetched)    # one sync covers slots and block
        self.decode_seconds += time.perf_counter() - t0
        self.decode_ticks += 1
        self.fused_ticks += 1
        self.fused_chunk_tokens += len(picks) * c
        self.fused_decode_tokens += len(decoding) * K
        for i, r in enumerate(picks):
            row = active[r]
            row.filled += c
            if row.filled < row.padded.size:
                continue
            tok = int(firsts[i])
            row.t_first = time.perf_counter()
            row.last = tok
            row.out.append(tok)
            row.decoding = True
            self._pcache_insert(r, row)
            if tok == row.req.stop_token or row.req.max_new_tokens == 1:
                done = self._completion(row)
                self._finish_completed(r, active, free_rows)
                yield done
        for r in list(decoding):
            done = self._commit_block(r, active[r], nxt[r], active,
                                      free_rows)
            if done is not None:
                yield done

    # -- disaggregated serving: KV export / import ------------------------

    @torch.no_grad()
    def export_kv(self, request: Request) -> dict:
        """PREFILL-ONLY execution: run ``request``'s prompt through this
        batcher's (chunked) prefill on a borrowed row and return its
        paged-KV state as a host artifact (every page covering its
        positions, int8 values and scales bit-exactly; geometry; the
        first token and the ``rid`` whose key folds drew it).  The row's
        pages are released before returning; prefix-cache hits apply and
        the new pages are published.  Must not run while this batcher's
        serve loop does."""
        if not isinstance(request, Request):
            raise TypeError(f"export_kv() takes a Request, got "
                            f"{type(request).__name__}")
        self._refuse_on_mesh("export_kv")
        with self._loop_lock:
            if self._loop_active:
                raise RuntimeError(
                    "export_kv cannot run concurrently with this "
                    "batcher's serve loop (prefill-role batchers never "
                    "start one)")
            wt, wd, need = self._worst_pages(request)
            self._tier_promote(request)
            active: Dict[int, _Row] = {}
            row, plan = self._admit_row([0], active, wt, wd, request)
            rid = self._next_rid
            self._next_rid += 1
            try:
                res = self._admit_dispatch(row, rid, request, wt, wd, need,
                                           active, plan)
                state = active[row]
                if res is not None:
                    first = int(res[2].item())
                    state.t_first = time.perf_counter()
                    state.last = first
                    state.out = [first]
                else:
                    while not state.decoding:
                        if self._advance_prefill(active) is not None:
                            break
                return self._export_row(row, state)
            finally:
                self._finish(row, active, [])

    def _draft_geom(self) -> Dict[str, Any]:
        """The draft-side geometry an export's ``draft`` header carries
        and every import and resume checks, field for field."""
        return {"n_layers": int(self.draft_cfg.n_layers),
                "kv_heads": int(self.draft_cfg.kv_heads),
                "head_dim": int(self.draft_cfg.head_dim),
                "quantized": isinstance(self.dpool["k"], QTensor),
                "n_draft": int(self.n_draft)}

    def _side_leaves(self, side: _PagedSide, row: int, n: int, prefix: str
                     ) -> Dict[str, Any]:
        """``row``'s ``n`` pages past the shared prefix on ``side``, on the
        host, under their artifact names (``prefix`` "" the target's
        ``k``/``v``/scales, "d" the draft's): bf16 pages as CPU tensors
        (numpy has no bf16), the rest numpy arrays."""
        ns = len(side.shared_pages)
        ids = side.table_np()[row, ns:ns + n].astype(np.int64)
        leaves = _gather_pages(side.pool, torch.as_tensor(
            ids, device=self.device))
        names = (("k", "k_scales", "v", "v_scales")
                 if isinstance(side.pool["k"], QTensor) else ("k", "v"))
        return {prefix + name: (a if a.dtype == torch.bfloat16
                                else a.numpy())
                for name, a in zip(names, leaves)}

    def _export_row(self, row: int, state: _Row,
                    final: bool = False) -> dict:
        """Snapshot ``row``'s KV into a host artifact: the pages covering
        positions [shared_len, pos) in table order (cached prefix pages
        and own pages alike; a static prefix's shared pages stay, an
        importer with the same prefix holds them), plus the sampler
        state (``step`` and the emitted ``tokens``, so a suspended row
        resumes mid-stream).  A speculative row carries the draft pool's
        pages over the same positions (``dk``/``dv`` and the ``draft``
        header).

        ``final`` exports a finished row at its committed boundary,
        ``prefix + prompt + len(out) - 1``: the lagged modes advance
        ``pos`` and ``step`` at dispatch and may run past the committed
        stream, but every position below the boundary was written once
        with the true tokens, so a session parks in every decode mode."""
        E, step = int(state.pos), int(state.step)
        toks = [int(t) for t in state.out]
        if final:
            step = len(toks)
            E = self.prefix_len + int(state.req.prompt.size) + step - 1
        n = -(-(E - self.t_side.shared_len) // self.page_size)
        quantized = isinstance(self.pool["k"], QTensor)
        art = {
            "version": 1, "page_size": self.page_size,
            "prefix_len": self.prefix_len,
            "shared_len": self.t_side.shared_len,
            "pos": E, "prompt_len": int(state.req.prompt.size),
            "first_token": int(state.out[0]), "step": step,
            "tokens": toks, "rid": int(state.rid),
            "quantized": quantized,
            "model": {"n_layers": int(self.cfg.n_layers),
                      "kv_heads": int(self.cfg.kv_heads),
                      "head_dim": int(self.cfg.head_dim)}}
        art.update(self._side_leaves(self.t_side, row, n, ""))
        if self.d_side is not None:
            art["draft"] = self._draft_geom()
            art.update(self._side_leaves(self.d_side, row, n, "d"))
        return art

    def _pool_dtype_name(self, pool: Optional[Dict[str, Any]] = None
                         ) -> str:
        k = (self.pool if pool is None else pool)["k"]
        return _TORCH_NAMES[(k.values if isinstance(k, QTensor) else k).dtype]

    def _validate_artifact(self, art: dict, req: Request) -> None:
        """Reject an import whose artifact cannot drop into THIS pool
        bit-exactly (the reference's checks, each a ``ValueError``)."""
        self._refuse_on_mesh("a KV import")
        if art.get("version") != 1:
            raise ValueError(f"unknown KV artifact version "
                             f"{art.get('version')!r}")
        quantized = isinstance(self.pool["k"], QTensor)
        for key, want in (("page_size", self.page_size),
                          ("prefix_len", self.prefix_len),
                          ("shared_len", self.t_side.shared_len),
                          ("quantized", quantized)):
            if art.get(key) != want:
                raise ValueError(
                    f"KV artifact {key} {art.get(key)!r} does not match "
                    f"this batcher's {want!r}")
        model = art.get("model") or {}
        for key, want in (("n_layers", int(self.cfg.n_layers)),
                          ("kv_heads", int(self.cfg.kv_heads)),
                          ("head_dim", int(self.cfg.head_dim))):
            if model.get(key) != want:
                raise ValueError(
                    f"KV artifact model {key} {model.get(key)!r} does "
                    f"not match this config's {want}")
        try:
            step = int(art.get("step", 1))
        except (TypeError, ValueError):
            raise ValueError(f"KV artifact step {art.get('step')!r} is "
                             f"not an int") from None
        if step < 1:
            raise ValueError(f"KV artifact step {step} must be >= 1")
        toks = art.get("tokens")
        if step > 1 or toks is not None:
            if not isinstance(toks, (list, tuple)) or len(toks) != step:
                raise ValueError(
                    f"KV artifact tokens must list exactly step "
                    f"({step}) emitted tokens, got {toks!r}")
            if int(toks[0]) != int(art.get("first_token", -1)):
                raise ValueError("KV artifact tokens[0] does not match "
                                 "its first_token")
        if step > 1:
            if step >= req.max_new_tokens:
                raise ValueError(
                    f"suspended KV artifact already emitted {step} of "
                    f"{req.max_new_tokens} tokens — a finished request "
                    f"is never suspended")
            if req.stop_token is not None \
                    and int(toks[-1]) == int(req.stop_token):
                raise ValueError("suspended KV artifact ends at the "
                                 "stop token — nothing to resume")
        E = art.get("pos")
        if E != self.prefix_len + int(req.prompt.size) + step - 1 \
                or art.get("prompt_len", -1) != int(req.prompt.size):
            raise ValueError(
                f"KV artifact covers {E!r} positions; this request needs "
                f"prefix {self.prefix_len} + prompt {req.prompt.size} "
                f"(+ {step - 1} resumed tokens)")
        n = -(-(E - self.t_side.shared_len) // self.page_size)
        self._check_payload_arrays(art, quantized, n, self.cfg, self.pool)
        self._validate_artifact_draft(art, n, step)

    def _check_payload_arrays(self, art: dict, quantized: bool, n: int,
                              mcfg: TransformerConfig,
                              pool: Dict[str, Any], prefix: str = "") -> None:
        """One side's payload shape and dtype contract (``prefix`` ""
        ``k``/``v`` against the target, "d" ``dk``/``dv`` against the
        draft)."""
        want_shape = (int(mcfg.n_layers), n, int(mcfg.kv_heads),
                      self.page_size, int(mcfg.head_dim))
        names = (("k", "v", "k_scales", "v_scales") if quantized
                 else ("k", "v"))
        side = "draft " if prefix else ""
        for name in names:
            key = prefix + name
            a = art.get(key)
            if not isinstance(a, (np.ndarray, torch.Tensor)):
                raise ValueError(f"KV artifact is missing {side}array "
                                 f"{key!r}")
            if name.endswith("_scales"):
                want, dtype = want_shape[:3] + (1, self.page_size), \
                    "float32"
            else:
                want, dtype = want_shape, self._pool_dtype_name(pool)
            if tuple(a.shape) != want:
                raise ValueError(f"KV artifact {key} shape "
                                 f"{tuple(a.shape)} != expected {want}")
            if _dtype_name(a) != dtype:
                raise ValueError(f"KV artifact {key} dtype "
                                 f"{_dtype_name(a)} != {side}pool dtype "
                                 f"{dtype}")

    def _validate_artifact_draft(self, art: dict, n: int,
                                 step: int) -> None:
        """The draft half of :meth:`_validate_artifact`: a draftless
        batcher rejects a draft payload; a speculative one needs a
        matching payload for a mid-stream artifact, and takes a fresh
        (step 1) export without one by rebuilding the draft's prompt KV
        (a draftless prefill tier feeding speculative decode replicas)."""
        draft = art.get("draft")
        has_payload = isinstance(art.get("dk"), (np.ndarray, torch.Tensor))
        if self.d_side is None:
            if draft is not None or has_payload:
                raise ValueError(
                    "KV artifact carries a draft-side payload but this "
                    "batcher has no draft model (speculative exports "
                    "resume on speculative batchers)")
            return
        if not has_payload:
            if step > 1:
                raise ValueError(
                    "suspended KV artifact has no draft-side payload; "
                    "a speculative batcher cannot rebuild mid-stream "
                    "draft state bit-exactly")
            return      # a fresh prefill: the import rebuilds the draft
        if not isinstance(draft, dict):
            raise ValueError("KV artifact has draft arrays but no "
                             "'draft' geometry header")
        geom = self._draft_geom()
        for key, want in geom.items():
            if draft.get(key) != want:
                raise ValueError(
                    f"KV artifact draft {key} {draft.get(key)!r} does "
                    f"not match this batcher's {want!r}")
        self._check_payload_arrays(art, geom["quantized"], n,
                                   self.draft_cfg, self.dpool, prefix="d")

    def _install_side(self, side: _PagedSide, row: int, art: dict, n: int,
                      prefix: str = "") -> None:
        """Back ``n`` pages past the shared prefix with own pages on
        ``side`` and write the artifact's ``prefix`` payload into them."""
        side.ensure(row, side.shared_len + n * self.page_size)
        names = (("k", "k_scales", "v", "v_scales")
                 if isinstance(side.pool["k"], QTensor) else ("k", "v"))
        ids = torch.as_tensor(side.alloc.rows[row], dtype=torch.long,
                              device=self.device)
        _install_pages(side.pool, [_as_tensor(art[prefix + k])
                                   for k in names], ids)

    def _admit_import(self, row: int, pre: Prefilled, wt: int, wd: int,
                      need: int, active: Dict[int, _Row]) -> tuple:
        """Admission of an imported prefill: back the payload's positions
        with own pages, write its pages into them (and the draft's), and
        enter the row straight into decode at the exported position with
        the exported tokens (a suspended artifact resumes mid-stream at
        its ``step``, its ``rid``'s key folds continuing).  The imported
        full prompt pages then seed the prefix cache like a local
        prefill's."""
        t_admit = time.perf_counter()
        art = pre.artifact
        req = pre.request
        self._trace_event(req, "import", rid=int(art.get("rid", -1)),
                          row=row, pos=int(art.get("pos", 0)),
                          resumed=int(art.get("step", 1)) > 1)
        n = art["k"].shape[1]
        self._install_side(self.t_side, row, art, n)
        if self.d_side is not None:
            self._admit_import_draft(row, req, art, n, need)
        step = int(art.get("step", 1))
        toks = [int(t) for t in (art.get("tokens") or ())]
        resumed = step > 1
        state = _Row(rid=int(art["rid"]), req=req, pos=int(art["pos"]),
                     step=step, last=toks[-1] if resumed else 0,
                     out=list(toks) if resumed else [], worst_pages=wt,
                     worst_draft=wd, t_admit=t_admit, limit=need)
        active[row] = state
        self._pcache_insert(row, state)
        return row, state, int(art["first_token"])

    def _admit_import_draft(self, row: int, req: Request, art: dict,
                            n: int, need: int) -> None:
        """The draft half of :meth:`_admit_import`: install the paired
        draft payload, or, for a fresh export from a draftless prefill
        tier, rebuild the draft's prompt KV with exactly the chunk calls a
        local admission makes (the same widths and offsets), so the draft
        cache is the local admission's."""
        dside = self.d_side
        if isinstance(art.get("dk"), (np.ndarray, torch.Tensor)):
            self._install_side(dside, row, art, n, prefix="d")
            return
        length = int(req.prompt.size)
        bucket = self.prefill_chunk or self.prefill_bucket
        width = -(-length // bucket) * bucket
        fresh = dside.alloc.allocated(row) == 0
        dside.ensure(row, min(self.prefix_len + width, need))
        if dside.tail_template is not None and fresh \
                and not dside.row_cached.get(row) \
                and dside.alloc.allocated(row):
            _copy_page(dside.pool, dside.tail_template,
                       dside.alloc.rows[row][0])
        padded = np.zeros((width,), np.int32)
        padded[:length] = req.prompt
        c = self.prefill_chunk or width
        for off in range(0, width, c):
            self._draft_chunk_call(row, padded[off:off + c],
                                   self.prefix_len + off)

    # -- the KV tier: prefix spill/promote, session park/resume ----------

    @property
    def _tier_active(self) -> bool:
        return (self.kv_tier is not None
                and self.kv_tier_bypass_reason is None)

    def _tier_geom(self) -> Dict[str, Any]:
        """The geometry stamped on every spilled prefix page and checked
        at promotion, the reference's field for field (``dtype`` is
        numpy's name, e.g. "bfloat16"), so either framework's spilled
        pages promote in the other; the ``draft`` sub-geometry (None
        without one) keeps a speculative batcher's twin-page spills and
        a draftless one's apart."""
        geom: Dict[str, Any] = {
            "page_size": self.page_size,
            "n_layers": int(self.cfg.n_layers),
            "kv_heads": int(self.cfg.kv_heads),
            "head_dim": int(self.cfg.head_dim),
            "dtype": self._pool_dtype_name(), "draft": None}
        if self.d_side is not None:
            geom["draft"] = {
                "n_layers": int(self.draft_cfg.n_layers),
                "kv_heads": int(self.draft_cfg.kv_heads),
                "head_dim": int(self.draft_cfg.head_dim),
                "dtype": self._pool_dtype_name(self.dpool)}
        return geom

    @staticmethod
    def _page_shape(cfg: TransformerConfig, page_size: int
                    ) -> Tuple[int, ...]:
        """One spilled page's K (or V): [layers, 1, kv_heads, page,
        head_dim]."""
        return (int(cfg.n_layers), 1, int(cfg.kv_heads), page_size,
                int(cfg.head_dim))

    def _spill_page(self, shard: int, digest: bytes, page: int,
                    dpage: Optional[int] = None) -> None:
        """The prefix cache's eviction callback: copy the evicted page
        (and its draft twin) to the host and park it in the tier under
        its chain digest (body: K then V, then the draft's K and V).
        Runs on the serve thread while the pages still hold their chunk;
        a page the tier could never hold costs no copy."""
        tier = self.kv_tier
        nbytes = 2 * int(np.prod(self._page_shape(
            self.cfg, self.page_size))) * self.pool["k"].element_size()
        twin = self.d_side is not None and dpage is not None
        if twin:
            nbytes += 2 * int(np.prod(self._page_shape(
                self.draft_cfg, self.page_size))) \
                * self.dpool["k"].element_size()
        if not tier.would_accept(nbytes + 512):
            tier.count("evictions")
            return
        k, v = _gather_pages(self.pool, torch.tensor(
            [int(page)], device=self.device))
        meta = dict(self._tier_geom())
        meta["k_bytes"] = k.numel() * k.element_size()
        body = bytes(_array_bytes(k)) + bytes(_array_bytes(v))
        if twin:
            dk, dv = _gather_pages(self.dpool, torch.tensor(
                [int(dpage)], device=self.device))
            meta["dk_bytes"] = dk.numel() * dk.element_size()
            body += bytes(_array_bytes(dk)) + bytes(_array_bytes(dv))
        tier.put_prefix(digest.hex(), meta, body)

    @staticmethod
    def _body_pair(body: bytes, dtype_name: str, shape, off: int,
                   nbytes: int) -> List[torch.Tensor]:
        """Two consecutive host arrays of ``shape`` at ``off`` (each
        ``nbytes`` long) as CPU tensors."""
        count = int(np.prod(shape))
        dtype = np.int16 if dtype_name == _BF16 else dtype_name
        out = []
        for o in (off, off + nbytes):
            a = torch.from_numpy(np.frombuffer(
                body, dtype=dtype, count=count, offset=o).reshape(
                    shape).copy())
            out.append(a.view(torch.bfloat16) if dtype_name == _BF16
                       else a)
        return out

    def _tier_page_payload(self, meta: dict, body: bytes):
        """A spilled page's ``(target [K, V], draft [K, V] or None)``,
        each [layers, 1, kv_heads, page, head_dim] on the host, or None
        when the entry was cut for another geometry or is malformed."""
        geom = self._tier_geom()
        if any(meta.get(k) != geom[k] for k in geom):
            return None
        shape = self._page_shape(self.cfg, self.page_size)
        kb = meta.get("k_bytes")
        want = int(np.prod(shape)) * self.pool["k"].element_size()
        if not isinstance(kb, int) or kb != want or len(body) < 2 * kb:
            return None
        target = self._body_pair(body, geom["dtype"], shape, 0, kb)
        if self.d_side is None:
            return (target, None) if len(body) == 2 * kb else None
        dshape = self._page_shape(self.draft_cfg, self.page_size)
        dkb = meta.get("dk_bytes")
        dwant = int(np.prod(dshape)) * self.dpool["k"].element_size()
        if not isinstance(dkb, int) or dkb != dwant \
                or len(body) != 2 * kb + 2 * dkb:
            return None
        return target, self._body_pair(body, geom["draft"]["dtype"],
                                       dshape, 2 * kb, dkb)

    def _tier_promote(self, req: Request) -> None:
        """At admission, for each of ``req``'s prompt chunks past the
        trie's longest match, install a tier hit into free pool pages
        (and its draft twin) and insert it as a zero-ref node, so the
        prefix plan maps it like a resident hit.  Free pages only (a
        promotion never evicts the resident cache for room), and once
        per request."""
        if not self._tier_active or self._pcache is None:
            return
        if getattr(req, "_tier_checked", False):
            return
        req._tier_checked = True
        digs = self._req_digests(req)
        pc, alloc = self._pcache, self.t_side.alloc
        dalloc = self.d_side.alloc if self.d_side is not None else None
        n = len(pc.match(0, digs)) if digs else 0
        while n < len(digs):
            d = digs[n]
            got = self.kv_tier.get_prefix(d.hex())
            if got is None:
                break
            payloads = self._tier_page_payload(got[0], got[1])
            if payloads is None or not alloc.free \
                    or (dalloc is not None and not dalloc.free):
                break
            payload, dpayload = payloads
            page = alloc.free.pop()
            dpage = dalloc.free.pop() if dalloc is not None else None
            if not pc.insert_chain(0, digs[:n], d, page, dpage):
                alloc.free.append(page)
                if dalloc is not None:
                    dalloc.free.append(dpage)
                break
            _install_pages(self.pool, payload,
                           torch.tensor([page], device=self.device))
            if dpayload is not None:
                _install_pages(self.dpool, dpayload,
                               torch.tensor([dpage], device=self.device))
            self.kv_tier.count("promotions")
            self._trace_event(req, "tier_promote", digest=d.hex()[:16],
                              depth=n + 1)
            n += 1

    def _validate_session(self, art: dict, req: Request) -> None:
        """Reject a parked session artifact that cannot resume ``req``
        exactly (each mismatch a ``ValueError``: the lookup then misses
        and the turn prefills cold)."""
        if art.get("version") != 1:
            raise ValueError(f"unknown session artifact version "
                             f"{art.get('version')!r}")
        for key, want in (("page_size", self.page_size),
                          ("prefix_len", self.prefix_len),
                          ("shared_len", self.t_side.shared_len),
                          ("quantized", False)):
            if art.get(key) != want:
                raise ValueError(
                    f"session artifact {key} {art.get(key)!r} does not "
                    f"match this batcher's {want!r}")
        model = art.get("model") or {}
        for key, want in (("n_layers", int(self.cfg.n_layers)),
                          ("kv_heads", int(self.cfg.kv_heads)),
                          ("head_dim", int(self.cfg.head_dim))):
            if model.get(key) != want:
                raise ValueError(
                    f"session artifact model {key} {model.get(key)!r} "
                    f"does not match this config's {want}")
        hist = art.get("history")
        if not isinstance(hist, (list, tuple)) or len(hist) < 2:
            raise ValueError("session artifact carries no usable history")
        if req.prompt.size < len(hist):
            raise ValueError(
                f"request prompt ({req.prompt.size} tokens) does not "
                f"extend the parked history ({len(hist)} tokens)")
        if not np.array_equal(req.prompt[:len(hist)],
                              np.asarray(hist, np.int32)):
            raise ValueError("request prompt diverges from the parked "
                             "session history")
        covered = len(hist) - 1     # the last token is the tail's input
        E_art = art.get("pos")
        if E_art != self.prefix_len + covered:
            raise ValueError(
                f"session artifact covers {E_art!r} positions; its "
                f"history implies {self.prefix_len + covered}")
        n = -(-(E_art - self.t_side.shared_len) // self.page_size)
        self._check_payload_arrays(art, False, n, self.cfg, self.pool)
        draft = art.get("draft")
        if self.d_side is None:
            if draft is not None or isinstance(
                    art.get("dk"), (np.ndarray, torch.Tensor)):
                raise ValueError("session artifact carries a draft "
                                 "payload this batcher has no draft "
                                 "model for")
        else:
            # The tier bypasses int8 pools, so the draft's is plain here.
            for key, want in self._draft_geom().items():
                if not isinstance(draft, dict) or draft.get(key) != want:
                    raise ValueError(
                        f"session artifact draft geometry does not "
                        f"match this batcher ({key})")
            self._check_payload_arrays(art, False, n, self.draft_cfg,
                                       self.dpool, prefix="d")
        # The tail's padded window must fit the page table.
        E = self.prefix_len + int(req.prompt.size)
        w = -(-(E - E_art) // self.prefill_bucket) * self.prefill_bucket
        if E_art + w > self.np_max * self.page_size:
            raise ValueError("session tail window exceeds the page "
                             "table; resuming cold instead")

    def _session_lookup(self, req: Request) -> Optional[dict]:
        """The usable parked artifact for ``req.session_id``, or None (no
        tier, no entry, stale weights, corrupt, or not a prefix of this
        prompt: every miss means a cold full-history prefill).  Memoized
        on the request, so a queued arrival reads the tier once."""
        if not self._tier_active or not req.session_id:
            return None
        memo = getattr(req, "_session_art", None)
        if memo is not None:
            return memo[0]
        art = None
        got = self.kv_tier.resume(req.session_id)
        if got is not None:
            try:
                art = unpack_prefilled(dict(got[0]), got[1])
                self._validate_session(art, req)
            except ValueError:
                art = None
        if art is not None:
            self.kv_tier.count("resume")
        req._session_art = (art,)
        return art

    @torch.no_grad()
    def _admit_session(self, row: int, rid: int, req: Request, wt: int,
                       wd: int, need: int, active: Dict[int, _Row],
                       art: dict) -> tuple:
        """Admission of a session resume: install the parked pages (the
        conversation so far; the draft's twin pages too) and prefill only
        the new turn's tail at its true offset, a prefix-cache tail's
        call (the paged kernel with the tail as its self chunk), the
        draft's tail in lockstep.  Returns the burst tuple."""
        t_admit = time.perf_counter()
        n = art["k"].shape[1]
        ts = int(art["pos"])
        self._trace_event(req, "session_resume", rid=rid, row=row,
                          session=str(req.session_id), covered=ts)
        # The artifact's first own page embeds any static prefix's tail
        # template (the parking row's copy): no template re-copy.
        self._install_side(self.t_side, row, art, n)
        if self.d_side is not None:
            self._install_side(self.d_side, row, art, n, prefix="d")
        E = self.prefix_len + int(req.prompt.size)
        tlen = E - ts
        w = -(-tlen // self.prefill_bucket) * self.prefill_bucket
        # Allocation clamps at the reservation, as for a prefix-cache
        # tail: pad positions past ``need`` land on sink columns.
        for side, _, _ in self._sides():
            side.ensure(row, min(ts + w, need))
        padded = np.zeros((w,), np.int32)
        padded[:tlen] = req.prompt[req.prompt.size - tlen:]
        tok = self._chunk_call(row, padded, ts, tlen - 1, rid)
        if self.d_side is not None:
            self._draft_chunk_call(row, padded, ts)
        self.tail_prefills += 1
        state = _Row(rid=rid, req=req, pos=E, step=1, last=0, out=[],
                     worst_pages=wt, worst_draft=wd, t_admit=t_admit,
                     limit=need)
        active[row] = state
        self._pcache_insert(row, state)
        return row, state, tok

    def _park_session(self, r: int, state: _Row) -> None:
        """Park a finished session-labelled row's KV before its pages
        free: the row's export at its committed boundary plus the whole
        conversation (``history``: prompt and output), so the next turn
        resumes from it here, or through a shared disk tier or the
        fabric on another replica.  A full tier is a counted rejected
        park; the completion stands either way."""
        if not self._tier_active:
            return
        sid = state.req.session_id
        if not sid or not state.out or state.t_first <= 0:
            return
        try:
            art = self._export_row(r, state, final=True)
            art["history"] = ([int(t) for t in state.req.prompt]
                              + [int(t) for t in state.out])
            meta, body = pack_prefilled(art)
        except Exception:
            return      # parking is best-effort
        try:
            self.kv_tier.park(str(sid), meta, body)
        except Exception:
            return      # KVTierFull: counted park_rejected by the store
        self._trace_event(state.req, "session_park", session=str(sid),
                          bytes=len(body))

    # -- deadlines ----------------------------------------------------------

    def _cancel_expired(self, active: Dict[int, _Row],
                        free_rows: List[int]) -> Iterator[Expired]:
        """Cancel every resident row whose deadline has passed, exactly
        like a finish (pages released, row freed) but yielding an
        :class:`Expired`."""
        for r in [r for r, row in active.items()
                  if row.req.deadline is not None and row.req.expired]:
            row = active[r]
            self.deadline_cancels += 1
            self._trace_event(row.req, "deadline_cancel", rid=row.rid,
                              where="resident", step=row.step)
            self._finish(r, active, free_rows)
            yield Expired(rid=row.rid, request=row.req)

    # -- priority preemption / drain migration ----------------------------

    def _suspendable(self, state: _Row) -> bool:
        """Decoding, with its first token fetched: a still-filling row
        has no complete KV to export."""
        return (self.preemptible and state.decoding and bool(state.out)
                and state.t_first > 0)

    def _suspend_row(self, r: int, active: Dict[int, _Row],
                     free_rows: List[int]) -> dict:
        """Export row ``r`` (pages plus emitted tokens) and release it:
        a suspended request IS a KV export."""
        art = self._export_row(r, active[r])
        self._finish(r, active, free_rows)
        return art

    def _resume_fits(self, req: Request) -> bool:
        """Whether ``req``'s artifact could ever re-import here: an
        import backs every position with own pages (no cache discount),
        so a row admitted only thanks to a deep cache plan on a tight
        pool must not be suspended locally."""
        wt, wd, _ = self._worst_pages(req)
        for side, want in ((self.t_side, wt), (self.d_side, wd)):
            if side is None:
                continue
            reserved = 1 + len(side.shared_pages) + (
                1 if side.tail_template is not None else 0)
            if want > side.n_pages - reserved:
                return False
        return True

    def _maybe_preempt(self, priority: int, active: Dict[int, _Row],
                       free_rows: List[int]) -> bool:
        """Suspend the lowest-priority suspendable row STRICTLY below
        ``priority`` (ties: the newest) and park its artifact; False when
        there is none (equal priorities never preempt)."""
        if not self.preemptible:
            return False
        victims = [(row.req.priority, -row.rid, r)
                   for r, row in active.items()
                   if self._suspendable(row) and row.req.priority < priority
                   and self._resume_fits(row.req)]
        if not victims:
            return False
        _, _, r = min(victims)
        req = active[r].req
        self._trace_event(req, "preempt", by_priority=priority,
                          priority=req.priority)
        self._parked.append(Prefilled(req, self._suspend_row(r, active,
                                                             free_rows)))
        self.preemptions += 1
        return True

    def _preempt_everything(self, pending: deque, active: Dict[int, _Row],
                            free_rows: List[int],
                            source: Optional[SubmissionQueue]
                            ) -> Iterator[Suspended]:
        """:meth:`preempt_all`'s loop side: a :class:`Suspended` for every
        in-flight request — resident rows (with their artifact when
        suspendable), parked artifacts, queued arrivals and imports."""
        if source is not None:
            while True:
                item = source.poll(False)
                if item is None or item is _CLOSED:
                    break
                pending.append(item)
        # A lagged block in flight dies with its rows.
        self._inflight = None
        self._pipe_carry = self._pipe_host = None
        for r in sorted(active):
            state = active[r]
            art = (self._export_row(r, state)
                   if self._suspendable(state) else None)
            self._trace_event(state.req, "suspend", rid=state.rid,
                              exported=art is not None)
            self._finish(r, active, free_rows)
            yield Suspended(rid=state.rid, request=state.req, artifact=art)
        while self._parked:
            pre = self._parked.popleft()
            yield Suspended(rid=int(pre.artifact.get("rid", -1)),
                            request=pre.request, artifact=pre.artifact)
        while pending:
            item = pending.popleft()
            if isinstance(item, Prefilled):
                yield Suspended(rid=int(item.artifact.get("rid", -1)),
                                request=item.request,
                                artifact=item.artifact)
            else:
                yield Suspended(rid=-1, request=item, artifact=None)
        self._preempt_event.clear()

    # -- ahead-of-time warmup ---------------------------------------------

    def _decode_widths(self) -> List[int]:
        """Every table width a decode tick can take, through the same
        ``_PagedSide.width_for`` the live tick buckets with."""
        np_max = self.t_side.np_max
        return sorted({_PagedSide.width_for(occ, np_max)
                       for occ in range(1, np_max + 1)})

    def _prefill_widths(self) -> List[int]:
        """Every padded prompt width admission can dispatch: multiples of
        ``prefill_bucket`` up to ``max_len - prefix_len``."""
        b = self.prefill_bucket
        cap = ((self.max_len - self.prefix_len) // b) * b
        return list(range(b, cap + 1, b)) or [b]

    @torch.no_grad()
    def warmup(self, decode: bool = True,
               prefill: bool = True) -> Dict[str, Any]:
        """Prepare every shape the serve loop dispatches, before it runs,
        under the reference's names: the admission prefill at each
        reachable prompt width (``prefill[w]``; after a static prefix a
        chunk over the paged pool); with the prefix cache or a KV tier,
        the tail call at each width (``chunk_prefill[w]``, at every table
        width its start can give it); in chunked mode the chunk step at
        each table width (``chunk_prefill[c]``); the decode block at each
        table width (``decode[w]``) and, under ``fused_prefill``, the
        fused tick at each width and slot count (``fused[w,S]``).  A
        speculative batcher captures the round at each table width
        (``spec_round[w]``) instead of the decode block, and the draft's
        prompt chunk at each width admission, chunking or a tail gives it
        (``draft_chunk[w]``).  On the card each is a CUDA graph captured here
        (without warmup a shape is captured at its first call; on a gloo
        mesh nothing is, and the result carries ``graphs_bypass_reason``).
        Every
        write lands on the sink page (all-sink tables, zero tokens and
        positions), so a warmed batcher's streams are bit-identical to a
        cold one's.  Raises while the serve loop is active.  Returns
        ``{"compiled": [...], "seconds": float}``."""
        t0 = time.perf_counter()
        compiled: List[str] = []
        if self.graphs_bypass_reason is not None:
            # Nothing to capture: every call runs eagerly.  Said by name,
            # never a silent fallback.
            return {"compiled": compiled, "seconds": 0.0,
                    "graphs_bypass_reason": self.graphs_bypass_reason}
        with self._loop_lock:
            if self._loop_active:
                raise RuntimeError(
                    "warmup() cannot run while the batcher's serve loop "
                    "is active — warm at boot, before serve()/run()")
            sink = self.t_side.sink
            chunked = self.prefill_chunk is not None
            for w in self._prefill_widths() if prefill and not chunked \
                    else ():
                inp, out = self._prefill_buffers(w)
                inp.zero_()
                inp[w + 2:] = sink
                self._graphs.warm(("prefill", w),
                                  functools.partial(self._prefill_step, w))
                out.tolist()
                compiled.append(f"prefill[{w}]")
            if prefill and chunked:
                c = self.prefill_chunk
                for w in self._decode_widths():
                    self._warm_chunk(c, w)
                compiled.append(f"chunk_prefill[{c}]")
            # A session resume dispatches a tail call at every width, in
            # chunked mode too, so a KV tier widens the set as the
            # prefix cache does.
            if prefill and (self._tier_active or (
                    self._pcache is not None and not chunked)):
                for t in self._prefill_widths():
                    for w in self._tail_widths(t):
                        self._warm_chunk(t, w)
                    if f"chunk_prefill[{t}]" not in compiled:
                        compiled.append(f"chunk_prefill[{t}]")
            spec = self.d_side is not None
            for w in self._decode_widths() if decode and spec else ():
                self._put_table(np.full((self.rows, w), sink, np.int32))
                self._put_table(np.full((self.rows, w), self.d_side.sink,
                                        np.int32), self._dtables)
                self._tick_in.zero_()
                self._tick_in[1] = self.max_len     # rows parked
                self._graphs.warm(("spec", w, w), functools.partial(
                    self._spec_step, w, w))
                self._sync()
                compiled.append(f"spec_round[{w}]")
            if prefill and spec:
                widths = set(self._prefill_widths() if not chunked
                             else [self.prefill_chunk])
                if self._tier_active or self._pcache is not None:
                    widths.update(self._prefill_widths())
                for t in sorted(widths):
                    inp = self._dchunk_buffer(t)
                    inp.zero_()
                    inp[t] = self.prefix_len
                    inp[t + 1:] = self.d_side.sink
                    self._graphs.warm(("draft_chunk", t), functools.partial(
                        self._draft_chunk_step, t))
                    self._sync()
                    compiled.append(f"draft_chunk[{t}]")
            for w in self._decode_widths() if decode and not spec else ():
                self._put_table(np.full((self.rows, w), sink, np.int32))
                self._tick_in.zero_()
                self._graphs.warm(w, functools.partial(self._tick, w))
                self._sync()
                compiled.append(f"decode[{w}]")
                for n in self._fused_slot_buckets() if self._fused else ():
                    inp, _ = self._slot_buffers(n)
                    c = self.prefill_chunk
                    inp.zero_()
                    inp[:, c + 1] = -1
                    inp[:, c + 3:] = sink
                    self._graphs.warm(("fused", w, n), functools.partial(
                        self._fused_step, w, n))
                    self._sync()
                    compiled.append(f"fused[{w},{n}]")
        return {"compiled": compiled, "seconds": time.perf_counter() - t0}

    def _tail_widths(self, t: int) -> List[int]:
        """Every table width a prefix-cache tail of ``t`` padded tokens
        can take: ``chunk_width`` grows with the tail's start, which the
        prefix plan keeps within ``np_max`` pages with the tail."""
        lo = self._chunk_width(0, t)
        hi = self._chunk_width(max(self.np_max * self.page_size - t, 0), t)
        return [w for w in self._decode_widths() if lo <= w <= hi]

    def _warm_chunk(self, t: int, w: int) -> None:
        """Capture the chunk call of ``t`` tokens at table width ``w``
        over an all-sink table."""
        inp, out = self._chunk_buffers(t, w)
        inp.zero_()
        inp[t + 3:] = self.t_side.sink
        self._graphs.warm(("chunk", t, w),
                          functools.partial(self._chunk_step, t, w))
        out.tolist()

    # -- finish -----------------------------------------------------------

    @staticmethod
    def _trace_event(req: Request, name: str, **attrs) -> None:
        """One batcher event on the request's trace (no-op without)."""
        tr = getattr(req, "trace", None)
        if tr is not None:
            tr.event("batcher", name, **attrs)

    @staticmethod
    def _completion(row: _Row) -> Completion:
        now = time.perf_counter()
        tr = getattr(row.req, "trace", None)
        if tr is not None:
            tr.span_between("batcher", "prefill", row.t_admit,
                            max(row.t_first, row.t_admit), rid=row.rid)
            tr.span_between("batcher", "decode",
                            max(row.t_first, row.t_admit), now,
                            rid=row.rid, tokens=len(row.out))
        return Completion(rid=row.rid, request=row.req,
                          tokens=list(row.out),
                          ttft_s=row.t_first - row.t_admit,
                          total_s=now - row.t_admit)

    def _finish_completed(self, row: int, active: Dict[int, _Row],
                          free_rows: List[int]) -> None:
        """Finish a completed row: park its session KV first (while its
        pages still hold it), then :meth:`_finish`."""
        state = active.get(row)
        if state is not None:
            self._park_session(row, state)
        self._finish(row, active, free_rows)

    def _finish(self, row: int, active: Dict[int, _Row],
                free_rows: List[int]) -> None:
        active.pop(row, None)
        self.t_side.release(row)
        if self.d_side is not None:
            self.d_side.release(row)
        free_rows.append(row)


def _to_device(params: Params, device: torch.device,
               dtype: torch.dtype) -> Params:
    """A copy of every leaf on ``device`` in ``dtype`` (an int8
    :class:`QTensor` keeps its int8 values and casts its scales), never
    the caller's own tensors: a weight swap writes into these.  The
    model casts each weight and scale to the compute dtype at use, so
    params cast once give the same bits while skipping the per-call
    casts."""
    def leaf(v):
        if isinstance(v, QTensor):
            return QTensor(v.values.to(device, copy=True),
                           v.scales.to(device=device, dtype=dtype,
                                       copy=True))
        return v.to(device=device, dtype=dtype, copy=True)

    return {k: (_to_device(v, device, dtype) if isinstance(v, dict)
                else leaf(v)) for k, v in params.items()}


def _tree_copy(tree: Params) -> Params:
    """A copy of a param tree's dicts, sharing its leaves."""
    return {k: _tree_copy(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def _copy_tree(dst: Params, src: Params) -> None:
    """Copy ``src``'s leaves into ``dst``'s tensors IN PLACE (cast to
    each destination's dtype and device; an int8 leaf's values and
    scales alike)."""
    for k, d in dst.items():
        v = src[k]
        if isinstance(d, dict):
            _copy_tree(d, v)
        elif isinstance(d, QTensor):
            d.values.copy_(v.values)
            d.scales.copy_(v.scales.to(d.scales.dtype))
        else:
            d.copy_(torch.as_tensor(v).to(d.dtype))
