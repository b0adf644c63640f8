"""Hop-local request tracing for the replica (port of
``tfmesos_tpu/fleet/tracing.py:56-219``: ``new_trace_id`` and
``TraceContext``; the gateway's trace book, the flight recorders and
the waterfall come with the port's gateway).

A request carrying a ``trace_id`` gets a :class:`TraceContext` at the
replica: its spans are offsets in milliseconds from the replica's own
receipt of the request, and they ride back on the reply as plain dicts
(absolute clocks never cross the wire).  The router re-anchors them on
its own clock.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["TraceContext", "new_trace_id"]


def new_trace_id() -> str:
    """16 hex chars of OS randomness."""
    return os.urandom(8).hex()


class TraceContext:
    """One request's spans on this hop: a bounded list of
    ``{"component", "name", "t0", "dur", ...attrs}`` dicts, ``t0``
    milliseconds from this context's creation.  Thread-safe (the
    handler's thread and the batcher's serve thread both record)."""

    __slots__ = ("trace_id", "detailed", "slow_ms", "dropped", "spans",
                 "_t0", "_lock", "max_spans")

    def __init__(self, trace_id: Optional[str] = None,
                 detailed: bool = False,
                 slow_ms: Optional[float] = None,
                 max_spans: int = 200):
        self.trace_id = trace_id or new_trace_id()
        self.detailed = bool(detailed)
        #: a hop slower than this exports its spans even when detail
        #: was not asked for (the tail rule, applied where the latency
        #: is known).
        self.slow_ms = slow_ms
        self.max_spans = int(max_spans)
        self.dropped = 0
        self.spans: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()

    def elapsed_ms(self) -> float:
        """Milliseconds since this hop began."""
        return (time.perf_counter() - self._t0) * 1000.0

    def rel_ms(self, perf_counter_s: float) -> float:
        """A ``time.perf_counter()`` reading of this process as an
        offset from the hop's start."""
        return (perf_counter_s - self._t0) * 1000.0

    def add(self, component: str, name: str, t0_ms: float,
            dur_ms: float, **attrs: Any) -> None:
        span = {"component": component, "name": name,
                "t0": round(float(t0_ms), 3),
                "dur": round(float(dur_ms), 3)}
        span.update(attrs)
        with self._lock:
            if len(self.spans) >= self.max_spans:
                self.dropped += 1
                return
            self.spans.append(span)

    def event(self, component: str, name: str, **attrs: Any) -> None:
        """A zero-duration span at "now"."""
        self.add(component, name, self.elapsed_ms(), 0.0, **attrs)

    def span_between(self, component: str, name: str, t0_s: float,
                     t1_s: float, **attrs: Any) -> None:
        """A span between two ``time.perf_counter()`` readings taken in
        this process (the batcher's admit and first-token stamps)."""
        self.add(component, name, self.rel_ms(t0_s),
                 max(0.0, (t1_s - t0_s) * 1000.0), **attrs)

    def export(self) -> List[Dict[str, Any]]:
        """The spans as JSON-ready dicts: what the reply carries."""
        with self._lock:
            return [dict(s) for s in self.spans]

    def should_export(self, failed: bool = False) -> bool:
        """The hop's tail rule: export when detail was asked for, the
        hop failed, or it ran slower than ``slow_ms``."""
        return (self.detailed or failed
                or (self.slow_ms is not None
                    and self.elapsed_ms() >= self.slow_ms))
