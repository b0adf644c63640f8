"""End-to-end request tracing for the serving fleet (port of ``tfmesos_tpu/fleet/tracing.py``).

Every generate request gets a ``trace_id`` minted at the gateway (or
supplied by the client) that rides the wire alongside ``deadline_ms``;
each component appends :class:`Span` records as the request moves —
gateway receipt, class resolution, WFQ queue wait, every router attempt
with its outcome taxonomy (picked replica, breaker skips, retry cause,
budget debits, deadline clips), prefill/decode phases, batcher-level
events (admission, preemption, suspend/export, import/resume, deadline
cancel), and migration hops.  Three disciplines keep it cheap and
correct at fleet scale:

* **Hop-local clocks.**  Absolute clock readings never cross the wire
  (the same rule end-to-end deadlines follow): a replica's spans are
  offsets from ITS OWN receipt of the request, piggybacked on the reply
  as plain dicts, and the router re-anchors them at the attempt's start
  on the gateway's clock (:meth:`TraceContext.absorb`).  The stitched
  waterfall is therefore exact within a hop and network-shifted across
  hops — durations are always true.
* **Tail-based sampling.**  Every request gets a cheap always-on
  SUMMARY record (id, status, total); full span detail is RETAINED for
  a sampled fraction plus every failed / shed / deadline-exceeded /
  slower-than-threshold request (:class:`TraceBook`) — the requests an
  operator actually asks about.  Replicas make the same decision
  hop-locally: spans piggyback when detail was requested, the hop
  failed, or the hop exceeded the threshold the gateway forwarded.
* **Bounded everything.**  Spans per trace, traces per book, and every
  per-component :class:`FlightRecorder` ring buffer are capped — a
  30-day soak holds the same memory as a 30-second one.

The ``current trace`` is thread-local (:func:`activate`): the router
activates a request's trace around its routing loop so deep helpers —
breaker filters, budget charges — attribute themselves without
plumbing.

Exposure: the gateway's authenticated ``trace`` op (``tfserve trace``
prints :func:`format_waterfall`), ``FleetMetrics.prometheus_text()``
behind ``tfserve --metrics-port``.  Everything here is stdlib-only.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

__all__ = ["FlightRecorder", "TraceContext", "TraceBook", "new_trace_id",
           "activate", "current", "cur_event", "cur_elapsed", "cur_span",
           "flight", "format_waterfall"]


def new_trace_id() -> str:
    """16 hex chars of OS randomness — unguessable enough that one
    tenant cannot fish another's trace out of the book by id."""
    return os.urandom(8).hex()


class FlightRecorder:
    """A bounded, lock-cheap ring buffer of recent span/event dicts —
    one per component, so "what did the batcher just do" survives even
    when no request-level trace was retained.  Appends are one lock
    acquire and one deque append; the ring drops oldest-first."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._total = 0

    def record(self, entry: Dict[str, Any]) -> None:
        with self._lock:
            self._total += 1
            self._ring.append(entry)

    @property
    def total(self) -> int:
        """Entries ever recorded (the ring holds the last
        ``capacity``)."""
        with self._lock:
            return self._total

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


# Process-global per-component recorders: components grab theirs by
# name (``flight("router")``) so recording never needs plumbing.
_FLIGHTS: Dict[str, FlightRecorder] = {}
_FLIGHTS_LOCK = threading.Lock()


def flight(component: str) -> FlightRecorder:
    """The process-global flight recorder for ``component``."""
    with _FLIGHTS_LOCK:
        rec = _FLIGHTS.get(component)
        if rec is None:
            rec = _FLIGHTS[component] = FlightRecorder()
        return rec


class TraceContext:
    """One request's in-flight trace: a bounded list of span dicts,
    each ``{"component", "name", "t0", "dur", ...attrs}`` with ``t0``
    milliseconds RELATIVE to this context's creation (hop receipt) —
    hop-local by construction, JSON-ready by construction.  Thread-safe
    (the batcher's serve thread and a router worker may both append)."""

    __slots__ = ("trace_id", "detailed", "slow_ms", "dropped", "spans",
                 "_t0", "_lock", "max_spans")

    def __init__(self, trace_id: Optional[str] = None,
                 detailed: bool = False,
                 slow_ms: Optional[float] = None,
                 max_spans: int = 200):
        self.trace_id = trace_id or new_trace_id()
        self.detailed = bool(detailed)
        #: hop-local slow threshold: a hop slower than this piggybacks
        #: its detail even unsampled (the tail-based rule, applied
        #: where the latency is actually known).
        self.slow_ms = slow_ms
        self.max_spans = int(max_spans)
        self.dropped = 0
        self.spans: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()

    # -- clocks ------------------------------------------------------------

    def elapsed_ms(self) -> float:
        """Milliseconds since this context (hop) began."""
        return (time.perf_counter() - self._t0) * 1000.0

    def rel_ms(self, perf_counter_s: float) -> float:
        """A ``time.perf_counter()`` reading as a hop-relative offset
        (same process, same clock base — never use across hosts)."""
        return (perf_counter_s - self._t0) * 1000.0

    # -- recording ---------------------------------------------------------

    def add(self, component: str, name: str, t0_ms: float,
            dur_ms: float, **attrs: Any) -> None:
        span = {"component": component, "name": name,
                "t0": round(float(t0_ms), 3),
                "dur": round(float(dur_ms), 3)}
        if attrs:
            span.update(attrs)
        with self._lock:
            if len(self.spans) >= self.max_spans:
                self.dropped += 1
                return
            self.spans.append(span)
        # The component's flight recorder sees every span too (with the
        # trace id, so a recorder entry leads back to its request).
        flight(component).record(dict(span, trace_id=self.trace_id))

    def event(self, component: str, name: str, **attrs: Any) -> None:
        """A zero-duration span at "now"."""
        self.add(component, name, self.elapsed_ms(), 0.0, **attrs)

    def span_between(self, component: str, name: str, t0_s: float,
                     t1_s: float, **attrs: Any) -> None:
        """A span from two ``time.perf_counter()`` readings taken in
        THIS process (the batcher's admit/first-token stamps)."""
        self.add(component, name, self.rel_ms(t0_s),
                 max(0.0, (t1_s - t0_s) * 1000.0), **attrs)

    def absorb(self, spans: Any, base_ms: float, **attrs: Any) -> None:
        """Graft another hop's piggybacked spans into this timeline,
        re-anchored at ``base_ms`` (the attempt's start offset on OUR
        clock) — the cross-host stitch.  Malformed entries cost
        themselves, never the trace; ``attrs`` (e.g. the replica addr)
        stamp every grafted span for attribution."""
        if not isinstance(spans, (list, tuple)):
            return
        for s in spans:
            if not isinstance(s, dict):
                continue
            try:
                t0 = base_ms + float(s.get("t0", 0.0))
                dur = float(s.get("dur", 0.0))
            except (TypeError, ValueError):
                continue
            extra = {k: v for k, v in s.items()
                     if k not in ("component", "name", "t0", "dur")}
            extra.update(attrs)
            self.add(str(s.get("component", "remote")),
                     str(s.get("name", "span")), t0, dur, **extra)

    # -- export ------------------------------------------------------------

    def export(self) -> List[Dict[str, Any]]:
        """The spans as JSON-ready dicts (hop-relative offsets) — what
        a replica piggybacks on its reply."""
        with self._lock:
            return [dict(s) for s in self.spans]

    def should_export(self, failed: bool = False) -> bool:
        """The replica-side tail rule: piggyback detail when it was
        asked for, the hop failed, or the hop ran slow."""
        return (self.detailed or failed
                or (self.slow_ms is not None
                    and self.elapsed_ms() >= self.slow_ms))


# -- thread-local current trace ---------------------------------------------

_CURRENT = threading.local()


class _Activation:
    """Context manager restoring the previous current trace on exit —
    nesting-safe (a rollout op routing inside a request's worker)."""

    __slots__ = ("_tr", "_prev")

    def __init__(self, tr: Optional[TraceContext]):
        self._tr = tr

    def __enter__(self) -> Optional[TraceContext]:
        self._prev = getattr(_CURRENT, "trace", None)
        _CURRENT.trace = self._tr
        return self._tr

    def __exit__(self, *exc) -> None:
        _CURRENT.trace = self._prev


def activate(tr: Optional[TraceContext]) -> _Activation:
    """``with activate(tr): ...`` — make ``tr`` the thread's current
    trace (``None`` deactivates; helpers then no-op)."""
    return _Activation(tr)


def current() -> Optional[TraceContext]:
    return getattr(_CURRENT, "trace", None)


def cur_event(component: str, name: str, **attrs: Any) -> None:
    """Record an event on the thread's current trace (no-op without
    one) — how deep helpers (breaker filter, budget, chaos) attribute
    themselves without plumbing."""
    tr = current()
    if tr is not None:
        tr.event(component, name, **attrs)


def cur_elapsed() -> Optional[float]:
    """The current trace's elapsed ms, or None — capture before a call
    to later :func:`cur_span` its duration."""
    tr = current()
    return tr.elapsed_ms() if tr is not None else None


def cur_span(component: str, name: str, t0_ms: Optional[float],
             **attrs: Any) -> None:
    """Close a span opened at :func:`cur_elapsed`'s reading (no-op when
    either side had no trace)."""
    tr = current()
    if tr is not None and t0_ms is not None:
        tr.add(component, name, t0_ms, tr.elapsed_ms() - t0_ms, **attrs)


# -- the gateway's trace store ----------------------------------------------


class TraceBook:
    """Finished-trace store with tail-based retention.

    Every request FINISHES into the book: a summary record always; the
    span detail is kept when the trace was head-sampled (``sample``
    fraction, or the client asked), FAILED (any non-completed status —
    sheds, deadline_exceeded, unavailable), or ran slower than
    ``slow_ms``.  ``capacity`` bounds the recent ring; detailed records
    evicted from it move to a second ``retain``-bounded ring so a flood
    of healthy traffic cannot flush the one trace that mattered."""

    def __init__(self, capacity: int = 256, retain: int = 256,
                 sample: float = 0.05, slow_ms: float = 1000.0,
                 max_spans: int = 200, rng=None):
        if not 0.0 <= sample <= 1.0:
            raise ValueError(f"sample must be in [0, 1], got {sample}")
        self.capacity = int(capacity)
        self.retain = int(retain)
        self.sample = float(sample)
        self.slow_ms = float(slow_ms)
        self.max_spans = int(max_spans)
        import random as _random
        self._rng = rng or _random.Random()
        self._lock = threading.Lock()
        self._recent: "OrderedDict[str, dict]" = OrderedDict()
        self._retained: "OrderedDict[str, dict]" = OrderedDict()
        self._finished = 0
        self._detailed = 0

    # -- lifecycle ---------------------------------------------------------

    def begin(self, trace_id: Optional[str] = None,
              want_detail: bool = False) -> TraceContext:
        """A new in-flight context: head-sampled here (client request
        for detail always wins); tail rules apply again at finish."""
        detailed = bool(want_detail) or \
            (self.sample > 0.0 and self._rng.random() < self.sample)
        return TraceContext(trace_id=trace_id, detailed=detailed,
                            slow_ms=self.slow_ms,
                            max_spans=self.max_spans)

    def finish(self, tr: TraceContext, status: str,
               **summary: Any) -> dict:
        """Close ``tr`` into a record.  ``status`` is ``"completed"``
        or the error/shed kind; anything non-completed retains full
        detail (tail-based), as does a slow or head-sampled trace."""
        total_ms = round(tr.elapsed_ms(), 3)
        keep = tr.detailed or status != "completed" \
            or total_ms >= self.slow_ms
        rec = {"trace_id": tr.trace_id, "status": status,
               "total_ms": total_ms, "detailed": keep,
               "ts": round(time.time(), 3)}
        if summary:
            rec["summary"] = dict(summary)
        if keep:
            rec["spans"] = tr.export()
            if tr.dropped:
                rec["spans_dropped"] = tr.dropped
        with self._lock:
            self._finished += 1
            if keep:
                self._detailed += 1
            # Re-finishing an id (a client-chosen id reused) keeps the
            # newest record; move-to-end keeps eviction order honest.
            self._recent.pop(tr.trace_id, None)
            self._recent[tr.trace_id] = rec
            while len(self._recent) > self.capacity:
                _, old = self._recent.popitem(last=False)
                if old.get("detailed"):
                    self._retained.pop(old["trace_id"], None)
                    self._retained[old["trace_id"]] = old
                    while len(self._retained) > self.retain:
                        self._retained.popitem(last=False)
        return rec

    # -- queries (all JSON-ready) ------------------------------------------

    def _all(self) -> List[dict]:
        with self._lock:
            return list(self._retained.values()) \
                + list(self._recent.values())

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            rec = self._recent.get(trace_id)
            if rec is None:
                rec = self._retained.get(trace_id)
            return rec

    def recent(self, n: int = 20) -> List[dict]:
        """The newest ``n`` SUMMARIES (spans stripped — the list view),
        newest first."""
        with self._lock:
            recs = list(self._recent.values())[-int(n):]
        return [{k: v for k, v in r.items() if k != "spans"}
                for r in reversed(recs)]

    def slowest(self, n: int = 5) -> List[dict]:
        """The ``n`` slowest known traces, full records, slowest
        first."""
        return sorted(self._all(), key=lambda r: -r["total_ms"])[:int(n)]

    def failed(self, n: int = 20) -> List[dict]:
        """The newest ``n`` non-completed traces, full records, newest
        first."""
        bad = [r for r in self._all() if r["status"] != "completed"]
        return sorted(bad, key=lambda r: -r["ts"])[:int(n)]

    def describe(self) -> Dict[str, int]:
        """The gateway's ``traces`` gauge: book occupancy + lifetime
        finish/detail counts."""
        with self._lock:
            return {"recent": len(self._recent),
                    "retained": len(self._retained),
                    "finished": self._finished,
                    "detailed": self._detailed}


# -- rendering ---------------------------------------------------------------


def format_waterfall(record: dict, width: int = 40) -> str:
    """One trace record as a human-readable waterfall (what ``tfserve
    trace`` prints): header, then each span in start order with its
    offset, duration, a proportional bar, and attributes."""
    tid = record.get("trace_id", "?")
    total = float(record.get("total_ms") or 0.0)
    head = (f"trace {tid}  status={record.get('status')}  "
            f"total={total:.1f}ms")
    summary = record.get("summary")
    if summary:
        head += "  " + " ".join(f"{k}={v}"
                                for k, v in sorted(summary.items()))
    spans = record.get("spans")
    if not spans:
        return head + "\n  (summary only — no span detail retained)"
    lines = [head]
    if record.get("spans_dropped"):
        lines.append(f"  ({record['spans_dropped']} spans dropped at "
                     f"the per-trace cap)")
    scale = max(total, max(float(s.get("t0", 0.0))
                           + float(s.get("dur", 0.0)) for s in spans
                           if isinstance(s, dict)), 1e-9)
    for s in sorted(spans, key=lambda s: (float(s.get("t0", 0.0)),
                                          float(s.get("dur", 0.0)))):
        t0 = float(s.get("t0", 0.0))
        dur = float(s.get("dur", 0.0))
        lo = int(round(max(0.0, t0) / scale * width))
        ln = max(1 if dur > 0 else 0,
                 int(round(dur / scale * width)))
        lo = min(lo, width - 1)
        bar = " " * lo + ("#" * ln if ln else "|")
        bar = bar[:width].ljust(width)
        attrs = {k: v for k, v in s.items()
                 if k not in ("component", "name", "t0", "dur")}
        attr_s = (" " + " ".join(f"{k}={v}"
                                 for k, v in sorted(attrs.items()))) \
            if attrs else ""
        lines.append(f"  [{bar}] {t0:9.1f}ms +{dur:8.1f}ms  "
                     f"{s.get('component', '?')}.{s.get('name', '?')}"
                     f"{attr_s}")
    return "\n".join(lines)
