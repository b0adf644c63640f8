"""Continuous batching over the paged KV cache — the base loop (port
of ``tfmesos_tpu/serving.py``: ``Request``/``Completion``/``_Row``
``:256-330, 444-525``, ``_PagedSide`` ``:603-776``, the
``ContinuousBatcher`` base loop ``:3799-4163``, uncached admission
``:4210-4284``, the prefill and decode calls and per-row sampling keys
``:2101-2197, 2472-2540``, ``warmup`` ``:2700-2760`` and the decode
tick ``:4539-4586``).

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
Each prompt-width prefill is an eager call.  On the card each
table-width decode tick is a CUDA graph (``graphs.py``), captured at
:meth:`ContinuousBatcher.warmup` or at the width's first tick and
replayed after: the tick copies its inputs in one host-to-device copy,
replays, and syncs once for its tokens.  Every layer of either launches
the hand-written attention kernel (``ops/attention.py``).
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

from tfmesos_tpu_torch.device import resolve_device
from tfmesos_tpu_torch.graphs import StepGraphs
from tfmesos_tpu_torch.models.transformer import (PageAllocator, Params,
                                                  TransformerConfig,
                                                  _check_sampling_args,
                                                  decode_step,
                                                  init_paged_cache,
                                                  sample_logits)
from tfmesos_tpu_torch.ops import prng
from tfmesos_tpu_torch.ops.quant import QTensor

__all__ = ["Request", "Completion", "ContinuousBatcher", "SubmissionQueue"]

# SubmissionQueue.poll's end-of-stream marker (distinct from None, which
# means "nothing available right now, more may come").
_CLOSED = object()


class SubmissionQueue:
    """Thread-safe incremental :class:`Request` source for
    :meth:`ContinuousBatcher.run`.  Any thread may :meth:`submit`;
    :meth:`close` ends the stream (later submissions raise).  The run
    loop polls non-blocking while rows decode and blocks only when
    idle."""

    def __init__(self) -> None:
        self._q: "_queue.Queue" = _queue.Queue()
        self._closed = False
        self._lock = threading.Lock()

    def submit(self, request: "Request") -> None:
        if not isinstance(request, Request):
            raise TypeError(f"submit() takes a Request, got "
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

    def poll(self, block: bool):
        """Next request; ``None`` when empty (more may come), the
        ``_CLOSED`` sentinel at end of stream."""
        try:
            item = self._q.get(block=block)
        except _queue.Empty:
            return None
        if item is _CLOSED:
            self._q.put(_CLOSED)    # keep re-polls terminal
        return item


@dataclasses.dataclass
class Request:
    """One generation request: ``prompt`` is a non-empty 1-D int32 token
    array; generation stops after ``max_new_tokens`` or at
    ``stop_token`` (which is emitted)."""

    prompt: np.ndarray
    max_new_tokens: int
    stop_token: Optional[int] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1 or self.prompt.size == 0:
            raise ValueError("Request.prompt must be a non-empty 1-D "
                             "token array (there is no position to "
                             "continue from otherwise)")
        if self.max_new_tokens < 1:
            raise ValueError(f"Request.max_new_tokens must be >= 1, got "
                             f"{self.max_new_tokens}")


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
class _Row:
    """Host-side state of one in-flight row."""

    rid: int
    req: Request
    pos: int            # next cache position to write (= current length)
    step: int           # tokens generated so far
    last: int           # last emitted token (feeds the next decode step)
    out: List[int]
    worst_pages: int    # admission-time page reservation
    t_admit: float = 0.0
    t_first: float = 0.0
    limit: int = 0      # absolute position cap the reservation covers


class _PagedSide:
    """Host-side state of the paged pool: the allocator, the reserved
    sink page and the cached page tables the model calls consume.  A
    row with no allocation is all-sink."""

    def __init__(self, n_pages: int, page_size: int, rows: int,
                 np_max: int):
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.rows = int(rows)
        self.np_max = int(np_max)
        self.alloc = PageAllocator(self.n_pages, self.page_size)
        # Inactive decode rows still execute the batched write: their
        # table entries must point somewhere writable that no live
        # request owns.
        self.sink = self.alloc.reserve_page()
        self.peak = 0                       # high-water mark of pages used
        self._cache_np: Optional[np.ndarray] = None
        self._sliced = None                 # (width, sliced table)

    def dirty(self) -> None:
        """Invalidate the derived tables after any page-mapping change."""
        self._cache_np = self._sliced = None

    def ensure(self, row: int, length: int) -> None:
        """Back positions [0, length) of ``row``."""
        before = self.alloc.allocated(row)
        self.alloc.ensure(row, max(0, length))
        if self.alloc.allocated(row) != before:
            self.dirty()
        used = self.n_pages - self.alloc.free_count()
        if used > self.peak:
            self.peak = used

    def release(self, row: int) -> None:
        self.alloc.release(row)
        self.dirty()

    def headroom(self, active: Dict[int, _Row]) -> int:
        """Free pages not spoken for by in-flight rows' reservations."""
        outstanding = sum(row.worst_pages - self.alloc.allocated(r)
                          for r, row in active.items())
        return self.alloc.free_count() - outstanding

    def table_np(self) -> np.ndarray:
        """Host master copy of the [rows, np_max] table: own pages, then
        sink."""
        if self._cache_np is None:
            t = np.full((self.rows, self.np_max), self.sink, np.int32)
            for r, own in self.alloc.rows.items():
                t[r, :len(own)] = own
            self._cache_np = t
        return self._cache_np

    def bucket_width(self) -> int:
        """Smallest power-of-two table width covering every allocated
        row, capped at ``np_max``: a decode tick reads no wider table
        than the live rows need, and the width is strictly greater than
        the widest allocation, so a clamped write lands on a sink
        column, never a live page."""
        occ = max((len(p) for p in self.alloc.rows.values() if p),
                  default=1)
        return self.width_for(occ, self.np_max)

    @staticmethod
    def width_for(occ: int, np_max: int) -> int:
        return min(1 << occ.bit_length(), np_max)

    def decode_table(self) -> np.ndarray:
        """The decode tick's table, sliced to :meth:`bucket_width`
        columns; cached until the allocation changes."""
        w = self.bucket_width()
        if self._sliced is None or self._sliced[0] != w:
            self._sliced = (w, np.ascontiguousarray(self.table_np()[:, :w]))
        return self._sliced[1]


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
    on the card the decode ticks replay CUDA graphs (:meth:`warmup`).
    ``params`` are the float32 masters or a ``quantize_params`` tree;
    the batcher keeps a copy cast once to the compute dtype (the model
    casts every weight and int8 scale at use, so the bits are the same).
    ``quantized_cache=True`` stores the page pool as int8 with
    per-position scales (the full int8 serving configuration with int8
    params).

    Counters for measurement: ``prefills`` (prefill calls),
    ``decode_ticks``, ``decode_tokens`` and ``decode_seconds`` (wall
    time of the decode ticks, each ending in the host sync of its
    tokens)."""

    def __init__(self, cfg: TransformerConfig, params: Params, rows: int = 8,
                 max_len: Optional[int] = None, page_size: int = 64,
                 n_pages: Optional[int] = None, prefill_bucket: int = 64,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 rng: Optional[torch.Tensor] = None, rid_seed: int = 0,
                 quantized_cache: bool = False, device=None):
        if rows < 1:
            raise ValueError(f"rows must be >= 1, got {rows}")
        if not 0 <= int(rid_seed) < 2 ** 30:
            raise ValueError(f"rid_seed must be in [0, 2^30), got "
                             f"{rid_seed}")
        _check_sampling_args(top_k, top_p)
        if prefill_bucket < 1:
            raise ValueError(f"prefill_bucket must be >= 1, got "
                             f"{prefill_bucket}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _to_device(params, self.device, cfg.dtype)
        self.rows = int(rows)
        self.max_len = int(max_len or cfg.max_seq_len)
        if self.max_len > cfg.max_seq_len:
            raise ValueError(f"max_len ({self.max_len}) exceeds the "
                             f"config's max_seq_len ({cfg.max_seq_len})")
        self.page_size = int(page_size)
        self.np_max = -(-self.max_len // self.page_size)
        self.n_pages = int(n_pages or self.rows * self.np_max + 1)
        self.prefill_bucket = int(prefill_bucket)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self._rng = (prng.PRNGKey(0, self.device) if rng is None
                     else rng.to(self.device).long())
        self.t_side = _PagedSide(self.n_pages, self.page_size, self.rows,
                                 self.np_max)
        self.pool = init_paged_cache(cfg, self.n_pages, self.page_size,
                                     quantized=quantized_cache,
                                     device=self.device)
        self._next_rid = int(rid_seed)
        self._submissions: Optional[SubmissionQueue] = None
        self._submissions_lock = threading.Lock()
        self._loop_lock = threading.Lock()
        self._loop_active = False
        # The decode tick's static buffers: its inputs (tokens, positions
        # clamped to max_len, rids, steps; one row each) packed for one
        # host-to-device copy from pinned memory, its tokens, and a page
        # table a width, re-copied only when the allocation changes.
        pin = self.device.type == "cuda"
        self._tick_host = torch.zeros((4, self.rows), dtype=torch.long,
                                      pin_memory=pin)
        self._tick_in = torch.zeros((4, self.rows), dtype=torch.long,
                                    device=self.device)
        self._tick_out = torch.zeros((self.rows,), dtype=torch.long,
                                     device=self.device)
        self._out_host = torch.zeros((self.rows,), dtype=torch.long,
                                     pin_memory=pin)
        # width -> (host table last copied, pinned staging, device table)
        self._tables: Dict[int, Tuple[Any, torch.Tensor, torch.Tensor]] = {}
        self._graphs = StepGraphs(self.device)
        self.prefills = 0
        self.decode_ticks = 0
        self.decode_tokens = 0
        self.decode_seconds = 0.0

    @property
    def peak_pages_used(self) -> int:
        return self.t_side.peak

    # -- validation / online submission -----------------------------------

    def validate(self, req: Request) -> None:
        """Raise ``ValueError`` if ``req`` can never be served here."""
        self._worst_pages(req)

    def _submission_source(self) -> SubmissionQueue:
        with self._submissions_lock:
            if self._submissions is None:
                self._submissions = SubmissionQueue()
            return self._submissions

    def submit(self, request: Request) -> None:
        """Thread-safe online admission: queue ``request`` for
        :meth:`serve`; raises after :meth:`close`."""
        self._submission_source().submit(request)

    def close(self) -> None:
        """End the online stream: :meth:`serve` drains and returns."""
        self._submission_source().close()

    def serve(self) -> Iterator[Completion]:
        """:meth:`run` over the submission queue."""
        return self.run(self._submission_source())

    # -- the loop ---------------------------------------------------------

    def run(self, requests: Iterable[Request]) -> Iterator[Completion]:
        """Serve ``requests`` (any iterable, or a :class:`SubmissionQueue`
        via :meth:`serve`), yielding :class:`Completion` s in finish
        order.  Requests are pulled lazily, only when a row and pages are
        free.  An invalid request raises — after every admitted request
        has drained.  Abandoning the iterator releases every row."""
        incremental = isinstance(requests, SubmissionQueue)
        source = None if incremental else iter(requests)
        pending: deque = deque()
        active: Dict[int, _Row] = {}
        free_rows = list(range(self.rows))
        exhausted = False
        bad_request: Optional[Exception] = None

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
                    pending.append(item)
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
                # Admit while a row is free and the pool can take the
                # newcomer's worst case; first tokens sync in one burst.
                burst: list = []
                while free_rows and bad_request is None:
                    if not pending and not exhausted and burst \
                            and not incremental:
                        # next(source) may block: settle the admissions
                        # already dispatched first.
                        yield from self._finalize_burst(burst, active,
                                                        free_rows)
                    pull(block=False)
                    if not pending:
                        break
                    req = pending[0]
                    try:
                        wt, need = self._worst_pages(req)
                    except ValueError as e:
                        bad_request = e     # raise after draining
                        break
                    row = self._admit_row(free_rows, active, wt)
                    if row is None:
                        break   # wait for an in-flight row to finish
                    pending.popleft()
                    rid = self._next_rid
                    self._next_rid += 1
                    burst.append(self._admit_dispatch(row, rid, req, wt,
                                                      need, active))
                yield from self._finalize_burst(burst, active, free_rows)
                if not active:
                    if bad_request is not None:
                        raise bad_request
                    pull()
                    if not pending and exhausted:
                        return
                    continue
                yield from self._step(active, free_rows)
        finally:
            for row in list(active):
                self._finish(row, active, free_rows)
            with self._loop_lock:
                self._loop_active = False

    # -- admission --------------------------------------------------------

    def _worst_pages(self, req: Request) -> Tuple[int, int]:
        """Worst-case pages of ``req`` and the absolute position cap the
        reservation covers; ``ValueError`` if it can never be served."""
        lo, hi = int(req.prompt.min()), int(req.prompt.max())
        if lo < 0 or hi >= self.cfg.vocab_size:
            # Checked here: on the card an out-of-range id is a device-side
            # assert that takes the whole CUDA context down.
            raise ValueError(f"prompt token ids must lie in [0, "
                             f"{self.cfg.vocab_size}), got [{lo}, {hi}]")
        width = -(-req.prompt.size // self.prefill_bucket) * \
            self.prefill_bucket
        need_len = max(width, req.prompt.size + req.max_new_tokens - 1)
        if need_len > self.max_len:
            raise ValueError(
                f"request needs {need_len} cache positions (prompt "
                f"{req.prompt.size} padded to {width}, plus "
                f"{req.max_new_tokens} new tokens) > max_len "
                f"({self.max_len})")
        return -(-need_len // self.page_size), need_len

    def _admit_row(self, free_rows: List[int], active: Dict[int, _Row],
                   wt: int) -> Optional[int]:
        """Pop a free row when the pool can take ``wt`` more reserved
        pages; ``None`` means wait.  Raises when nothing is in flight
        and it still cannot fit (waiting would deadlock)."""
        if wt <= self.t_side.headroom(active):
            return free_rows.pop(0)
        if not active:
            raise RuntimeError(
                f"request needs {wt} pages but only "
                f"{self.t_side.alloc.free_count()} are free with nothing "
                f"in flight to wait for — raise n_pages")
        return None

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sample(self, last: torch.Tensor, rids: torch.Tensor,
                steps: torch.Tensor) -> torch.Tensor:
        """[n, V] logits -> [n] tokens: the float32 argmax, or a draw
        under each row's key ``fold_in(fold_in(rng, rid), step)``, folded
        on the device (inside the tick's graph)."""
        if self.temperature <= 0.0:
            return torch.argmax(last.float(), dim=-1)
        keys = prng.fold_in(prng.fold_in(self._rng, rids), steps)
        return sample_logits(last, keys, self.temperature, self.top_k,
                             self.top_p)

    @torch.no_grad()
    def _admit_dispatch(self, row: int, rid: int, req: Request, wt: int,
                        need: int, active: Dict[int, _Row]) -> tuple:
        """Reserve pages for ``req`` in ``row`` and dispatch its prefill
        (one call at the padded width); the first token stays on the
        device until the burst syncs."""
        t_admit = time.perf_counter()
        length = req.prompt.size
        width = -(-length // self.prefill_bucket) * self.prefill_bucket
        self.t_side.ensure(row, width)
        padded = np.zeros((1, width), np.int32)
        padded[0, :length] = req.prompt
        table = self.t_side.table_np()[row:row + 1]
        cache = dict(self.pool, pages=self._dev(table))
        logits, _ = decode_step(self.cfg, self.params, cache,
                                self._dev(padded).long(), 0)
        self.prefills += 1
        tok = self._sample(
            logits[0, length - 1][None],
            torch.full((1,), rid, dtype=torch.long, device=self.device),
            torch.zeros((1,), dtype=torch.long, device=self.device))[0]
        state = _Row(rid=rid, req=req, pos=length, step=1, last=0, out=[],
                     worst_pages=wt, t_admit=t_admit, limit=need)
        active[row] = state
        return row, state, tok

    def _finalize_burst(self, burst: list, active: Dict[int, _Row],
                        free_rows: List[int]) -> Iterator[Completion]:
        """Fetch every admission's first token in one host sync and yield
        the requests that already finished.  Clears ``burst``."""
        if not burst:
            return
        toks = torch.stack([tok for _, _, tok in burst]).tolist()
        now = time.perf_counter()
        for (row, state, _), tok in zip(burst, toks):
            state.t_first = now
            state.last = tok
            state.out = [tok]
            if tok == state.req.stop_token or state.req.max_new_tokens == 1:
                done = self._completion(state)
                self._finish(row, active, free_rows)
                yield done
        burst.clear()

    # -- decode -----------------------------------------------------------

    def _put_table(self, table: np.ndarray) -> torch.Tensor:
        """The device table of ``table``'s width, holding ``table``:
        copied from pinned staging only when the host table changed."""
        w = table.shape[1]
        entry = self._tables.get(w)
        if entry is None:
            pin = self.device.type == "cuda"
            entry = (None, torch.zeros((self.rows, w), dtype=torch.int32,
                                       pin_memory=pin),
                     torch.zeros((self.rows, w), dtype=torch.int32,
                                 device=self.device))
        if entry[0] is not table:
            entry[1].numpy()[:] = table
            entry[2].copy_(entry[1], non_blocking=True)
            entry = (table, entry[1], entry[2])
        self._tables[w] = entry
        return entry[2]

    def _decode_table(self) -> torch.Tensor:
        return self._put_table(self.t_side.decode_table())

    @torch.no_grad()
    def _tick(self, width: int) -> None:
        """The decode tick over the static buffers (what a graph holds):
        every row's next token into ``_tick_out``."""
        inp = self._tick_in
        cache = dict(self.pool, pages=self._tables[width][2])
        logits, _ = decode_step(self.cfg, self.params, cache,
                                inp[0][:, None], inp[1])
        self._tick_out.copy_(self._sample(logits[:, -1], inp[2], inp[3]))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _step(self, active: Dict[int, _Row],
              free_rows: List[int]) -> Iterator[Completion]:
        """One decode tick: every active row advances one token in one
        batched call (a graph replay on the card); inactive rows ride
        along at position 0 on the sink page.  One host sync per tick."""
        host = self._tick_host.numpy()
        host[:] = 0
        for r, row in active.items():
            self.t_side.ensure(r, min(row.pos + 1, row.limit))
            host[:, r] = (row.last, min(row.pos, self.max_len), row.rid,
                          row.step)
        width = self._decode_table().shape[1]
        t0 = time.perf_counter()
        self._tick_in.copy_(self._tick_host, non_blocking=True)
        self._graphs.run(width, functools.partial(self._tick, width))
        self._out_host.copy_(self._tick_out, non_blocking=True)
        self._sync()
        nxt = self._out_host.tolist()
        self.decode_seconds += time.perf_counter() - t0
        self.decode_ticks += 1
        self.decode_tokens += len(active)
        for r in list(active):
            row = active[r]
            tok = int(nxt[r])
            row.out.append(tok)
            row.step += 1
            row.pos += 1
            row.last = tok
            if tok == row.req.stop_token or \
                    row.step >= row.req.max_new_tokens:
                done = self._completion(row)
                self._finish(r, active, free_rows)
                yield done

    # -- ahead-of-time warmup ---------------------------------------------

    def _decode_widths(self) -> List[int]:
        """Every table width a decode tick can take, through the same
        ``_PagedSide.width_for`` the live tick buckets with."""
        np_max = self.t_side.np_max
        return sorted({_PagedSide.width_for(occ, np_max)
                       for occ in range(1, np_max + 1)})

    def _prefill_widths(self) -> List[int]:
        """Every padded prompt width admission can dispatch: multiples of
        ``prefill_bucket`` up to ``max_len``."""
        b = self.prefill_bucket
        return list(range(b, (self.max_len // b) * b + 1, b)) or [b]

    @torch.no_grad()
    def warmup(self, decode: bool = True,
               prefill: bool = True) -> Dict[str, Any]:
        """Prepare every shape the serve loop dispatches, before it runs:
        one eager prefill at each reachable prompt width (``prefill[w]``:
        the kernels' builds and one-time host work), and on the card the
        decode tick captured as a CUDA graph at each table width
        (``decode[w]``; without warmup a width is captured at its first
        tick).  Every write lands on the sink page (all-sink tables, zero
        tokens and positions), so a warmed batcher's streams are
        bit-identical to a cold one's.  Raises while the serve loop is
        active.  Returns ``{"compiled": [...], "seconds": float}``."""
        t0 = time.perf_counter()
        compiled: List[str] = []
        with self._loop_lock:
            if self._loop_active:
                raise RuntimeError(
                    "warmup() cannot run while the batcher's serve loop "
                    "is active — warm at boot, before serve()/run()")
            zero = torch.zeros((1,), dtype=torch.long, device=self.device)
            sink = self.t_side.sink
            for w in self._prefill_widths() if prefill else ():
                table = np.full((1, self.np_max), sink, np.int32)
                logits, _ = decode_step(
                    self.cfg, self.params,
                    dict(self.pool, pages=self._dev(table)),
                    torch.zeros((1, w), dtype=torch.long,
                                device=self.device), 0)
                self._sample(logits[0, :1], zero, zero).tolist()
                compiled.append(f"prefill[{w}]")
            for w in self._decode_widths() if decode else ():
                self._put_table(np.full((self.rows, w), sink, np.int32))
                self._tick_in.zero_()
                self._graphs.warm(w, functools.partial(self._tick, w))
                self._sync()
                compiled.append(f"decode[{w}]")
        return {"compiled": compiled, "seconds": time.perf_counter() - t0}

    # -- finish -----------------------------------------------------------

    @staticmethod
    def _completion(row: _Row) -> Completion:
        now = time.perf_counter()
        return Completion(rid=row.rid, request=row.req,
                          tokens=list(row.out),
                          ttft_s=row.t_first - row.t_admit,
                          total_s=now - row.t_admit)

    def _finish(self, row: int, active: Dict[int, _Row],
                free_rows: List[int]) -> None:
        active.pop(row, None)
        self.t_side.release(row)
        free_rows.append(row)


def _to_device(params: Params, device: torch.device,
               dtype: torch.dtype) -> Params:
    """Every leaf on ``device`` in ``dtype`` (an int8 :class:`QTensor`
    keeps its int8 values and casts its scales).  The model casts each
    weight and scale to the compute dtype at use, so params cast once
    give the same bits while skipping the per-call casts."""
    def leaf(v):
        if isinstance(v, QTensor):
            return QTensor(v.values.to(device),
                           v.scales.to(device=device, dtype=dtype))
        return v.to(device=device, dtype=dtype)

    return {k: (_to_device(v, device, dtype) if isinstance(v, dict)
                else leaf(v)) for k, v in params.items()}
