"""Fleet observability: thread-safe counters, latency histograms, gauges (port of ``tfmesos_tpu/fleet/metrics.py``).

One ``FleetMetrics`` instance is shared by the gateway, router, and
admission controller; everything it exports is a plain-JSON
``snapshot()`` (served over the wire by the gateway's ``metrics`` op and
recorded by ``bench.py`` as the ``fleet_*`` metrics) plus an optional
periodic one-line log report.  No external metrics dependency — the
control plane stays stdlib-only, like the rest of the framework.

Consistency contract (asserted by the end-to-end tests): after the
gateway drains, ``received == admitted + shed_queue + shed_rate_limited``
and ``admitted == completed + failed`` — deadline-carrying traffic adds
``shed_deadline`` (requests shed for an expired end-to-end deadline,
at admission or while queued; the queued ones were admitted and so
count under ``failed`` too) and ``deadline_exceeded`` (deadline errors
relayed from the router/replicas, a subset of ``failed``).

Prefix-affinity routing adds ``affinity_hits``/``affinity_misses``: one
of the two per routing decision over a prompt-bearing request —
``hits / (hits + misses)`` is the fleet's prefix-affinity hit rate
(``fleet_prefix_affinity_hit_rate`` in bench.py).
"""

from __future__ import annotations

import re as _re
import threading
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["Histogram", "FleetMetrics"]

# Prometheus metric names must match [a-zA-Z_:][a-zA-Z0-9_:]*; our
# counter/histogram names are lowercase identifiers already, but class
# labels are user input ("queue_wait_ms_<class>") — sanitize, never
# trust.
_PROM_BAD = _re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    out = "fleet_" + _PROM_BAD.sub("_", str(name))
    return out if not out[6:7].isdigit() else "fleet__" + out[6:]


def _prom_label(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _prom_num(v) -> str:
    f = float(v)
    if f != f:
        # Valid exposition literal — a NaN gauge must cost its sample's
        # accuracy, never the whole scrape (int(nan) would raise here).
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)

# Bucket upper bounds in milliseconds — wide enough for CPU dev replicas
# (seconds) and TPU serving (single-digit ms) alike.
DEFAULT_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                      500.0, 1000.0, 2000.0, 5000.0, 10000.0, 30000.0,
                      60000.0, float("inf"))


class Histogram:
    """Fixed-bucket latency histogram; percentiles report the upper edge
    of the bucket the rank falls in (the standard Prometheus-style
    estimate — cheap, monotone, and honest about its resolution)."""

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS_MS):
        self.buckets = tuple(sorted(buckets))
        if not self.buckets or self.buckets[-1] != float("inf"):
            # Every histogram needs the +inf terminator: the bisect in
            # observe() indexes the bucket for ANY sample, so a
            # caller-supplied bucket list without it would crash the
            # metrics path on the first out-of-range observation.
            self.buckets += (float("inf"),)
        self._counts = [0] * len(self.buckets)
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        if v != v:
            # NaN: it would increment _count while landing in NO bucket
            # (every `v <= edge` comparison is False), silently shifting
            # every percentile's rank — drop it, the same way
            # FleetMetrics.observe drops non-numerics.
            return
        with self._lock:
            self._count += 1
            self._sum += v
            if v > self._max:
                self._max = v
            # Buckets are sorted ascending (inf last): binary search
            # for the first edge >= v — this runs several times per
            # served request, so O(log buckets) matters at simulator
            # and fleet scale.
            self._counts[bisect_left(self.buckets, v)] += 1

    def _percentile(self, p: float) -> float:
        # One copy of the rank walk (delta_percentile); the lifetime
        # snapshot substitutes the tracked max for the +inf bucket.
        out = Histogram.delta_percentile(
            None, (self.buckets, tuple(self._counts), self._count), p,
            inf_value=self._max)
        return self._max if out is None else out

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            if not self._count:
                return {"count": 0}
            return {
                "count": self._count,
                "mean": round(self._sum / self._count, 3),
                "p50": self._percentile(0.50),
                "p90": self._percentile(0.90),
                "p99": self._percentile(0.99),
                "max": round(self._max, 3),
            }

    def cumulative(self) -> tuple:
        """``(buckets, counts, count)`` — the raw cumulative state, so
        a control loop can diff two samples and compute percentiles
        over JUST the interval between them (Prometheus-style windowed
        p99: a lifetime histogram would never decay and the autoscaler
        would chase load that ended minutes ago)."""
        with self._lock:
            return (self.buckets, tuple(self._counts), self._count)

    def state(self) -> tuple:
        """``(buckets, counts, count, sum)`` — :meth:`cumulative` plus
        the running sum, the full tuple Prometheus exposition needs
        (``cumulative``'s 3-tuple shape is an API the autoscaler
        diffs; this one carries the extra field instead of changing
        it)."""
        with self._lock:
            return (self.buckets, tuple(self._counts), self._count,
                    self._sum)

    def raw(self) -> Dict[str, object]:
        """JSON-safe raw state for cross-process aggregation: bucket
        edges (``None`` stands in for +inf so strict JSON round-trips),
        per-bucket counts, total count/sum, and the tracked max.  The
        inverse of :meth:`merge`."""
        with self._lock:
            return {
                "buckets": [None if e == float("inf") else e
                            for e in self.buckets],
                "counts": list(self._counts),
                "count": self._count,
                "sum": self._sum,
                "max": self._max,
            }

    def merge(self, state: Dict[str, object]) -> None:
        """Fold another histogram's :meth:`raw` state — typically from a
        different gateway process — into this one.  Matching bucket
        layouts add elementwise; a foreign layout re-buckets each count
        at its upper edge (conservative: samples can only move to a
        wider bucket, so merged percentiles never under-report)."""
        edges = tuple(float("inf") if e is None else float(e)
                      for e in state.get("buckets", ()))
        counts = [int(n) for n in state.get("counts", ())]
        with self._lock:
            if edges == self.buckets and len(counts) == len(self._counts):
                for i, n in enumerate(counts):
                    self._counts[i] += n
            else:
                for edge, n in zip(edges, counts):
                    if n:
                        self._counts[bisect_left(self.buckets, edge)] += n
            self._count += int(state.get("count", 0))
            self._sum += float(state.get("sum", 0.0))
            m = state.get("max", 0.0)
            if isinstance(m, (int, float)) and m > self._max:
                self._max = float(m)

    @staticmethod
    def delta_percentile(prev: Optional[tuple], cur: tuple, p: float,
                         inf_value: Optional[float] = None
                         ) -> Optional[float]:
        """Percentile of the samples observed BETWEEN two
        :meth:`cumulative` snapshots (``prev`` may be ``None`` for
        since-birth); ``None`` when the window holds no samples.  A
        rank landing in the +inf bucket reports ``inf_value`` when the
        caller tracks a true max (the lifetime snapshot), else the
        last finite bucket edge."""
        buckets, counts, total = cur
        if prev is not None:
            pbuckets, pcounts, ptotal = prev
            if pbuckets == buckets:
                counts = tuple(c - q for c, q in zip(counts, pcounts))
                total = total - ptotal
        if total <= 0:
            return None
        rank = p * total
        seen = 0
        last_finite = 0.0
        for edge, n in zip(buckets, counts):
            seen += n
            if edge != float("inf"):
                last_finite = edge
            if seen >= rank:
                if edge == float("inf"):
                    break
                return edge
        return last_finite if inf_value is None else inf_value


class FleetMetrics:
    """Named counters + histograms + pull-style gauges with one JSON
    ``snapshot()`` and an optional periodic log line."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._hists: Dict[str, Histogram] = {}
        self._gauges: Dict[str, Callable[[], float]] = {}
        self._gauge_acc: Dict[str, float] = {}
        #: optional scrape-time fan-in (docs/SERVING.md "Multi-process
        #: gateways"): a callable returning the OTHER processes'
        #: :meth:`raw_state` dicts.  When set, the HTTP exporter serves
        #: the fleet-level merge instead of this process alone.
        self.fanin: Optional[Callable[[], List[dict]]] = None
        self._reporter: Optional[threading.Thread] = None
        self._reporter_stop = threading.Event()

    # -- counters ----------------------------------------------------------

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    # -- histograms --------------------------------------------------------

    def observe(self, name: str, value) -> None:
        """Record one latency sample; non-numeric values are dropped (a
        replica may omit a timing field rather than lie about it)."""
        if not isinstance(value, (int, float)):
            return
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = Histogram()
        hist.observe(value)

    def hist(self, name: str) -> Histogram:
        """The named histogram itself (created on first use) — hot
        paths that observe the same series per request hold this
        handle instead of paying the registry lock + lookup each
        time."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
        return h

    def hist_cumulative(self, name: str) -> Optional[tuple]:
        """The named histogram's :meth:`Histogram.cumulative` state, or
        ``None`` before its first observation — the autoscaler samples
        this per tick to compute windowed percentiles."""
        with self._lock:
            hist = self._hists.get(name)
        return hist.cumulative() if hist is not None else None

    def percentile(self, name: str, p: float) -> Optional[float]:
        """Lifetime percentile of one histogram (``None`` when it has
        no samples yet)."""
        cur = self.hist_cumulative(name)
        if cur is None:
            return None
        return Histogram.delta_percentile(None, cur, p)

    # -- gauges ------------------------------------------------------------

    def register_gauge(self, name: str, fn: Callable[[], float]) -> None:
        """``fn`` is sampled at snapshot time (queue depth, replicas
        alive, ...); it must be cheap and never raise."""
        with self._lock:
            self._gauges[name] = fn

    # -- export ------------------------------------------------------------

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            counters = dict(self._counters)
            hists = dict(self._hists)
            gauges = dict(self._gauges)
        out = {
            "counters": counters,
            "gauges": {},
            "histograms": {name: h.snapshot() for name, h in hists.items()},
        }
        for name, fn in gauges.items():
            try:
                out["gauges"][name] = fn()
            except Exception:  # pragma: no cover - gauge must not break export
                out["gauges"][name] = None
        return out

    def raw_state(self) -> Dict[str, dict]:
        """Mergeable raw export: counters, sampled gauge values, and
        per-histogram :meth:`Histogram.raw` states.  This is what a
        gateway process ships over the wire (``metrics`` op with
        ``raw: true``) so the launcher-side scrape can fan N processes
        into one registry via :meth:`merge_raw` — ``snapshot()`` only
        carries percentile estimates, which cannot be aggregated."""
        with self._lock:
            counters = dict(self._counters)
            hists = dict(self._hists)
            gauges = dict(self._gauges)
        out: Dict[str, dict] = {"counters": counters, "gauges": {},
                                "histograms": {}}
        for name, fn in gauges.items():
            try:
                out["gauges"][name] = fn()
            except Exception:  # pragma: no cover - gauge must not break export
                out["gauges"][name] = None
        for name, h in hists.items():
            out["histograms"][name] = h.raw()
        return out

    def merge_raw(self, raw: Dict[str, dict]) -> None:
        """Fold one process's :meth:`raw_state` into this registry:
        counters add, histograms bucket-merge, and numeric gauges
        accumulate as SUMS across every merge (right for queue depths
        and inflight counts; per-process identity gauges like bound
        ports belong in the per-process scrape, not the fan-in)."""
        for name, n in (raw.get("counters") or {}).items():
            try:
                self.inc(name, int(n))
            except (TypeError, ValueError):
                continue
        for name, st in (raw.get("histograms") or {}).items():
            if isinstance(st, dict):
                self.hist(name).merge(st)
        for name, val in (raw.get("gauges") or {}).items():
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                continue
            with self._lock:
                self._gauge_acc[name] = self._gauge_acc.get(name, 0) + val
            self.register_gauge(
                name, lambda n=name: self._gauge_acc.get(n, 0))

    def merged(self) -> "FleetMetrics":
        """One fleet-level registry: this process's own raw state folded
        with whatever :attr:`fanin` returns (each entry a peer
        process's :meth:`raw_state`).  A peer that fails to scrape
        costs its contribution, never the merge."""
        out = FleetMetrics()
        out.merge_raw(self.raw_state())
        raws: List[dict] = []
        if self.fanin is not None:
            try:
                raws = list(self.fanin() or [])
            except Exception:  # pragma: no cover - scrape must not break export
                raws = []
        for raw in raws:
            if isinstance(raw, dict):
                out.merge_raw(raw)
        return out

    def prometheus_text(self) -> str:
        """The whole metrics surface in Prometheus exposition format
        (text/plain version 0.0.4): counters and numeric gauges as-is,
        dict-valued gauges flattened one level into ``{key="..."}``
        labels (numeric leaves only), histograms as CUMULATIVE
        ``_bucket{le="..."}`` series plus ``_sum``/``_count`` — served
        by the optional stdlib HTTP exporter (``tfserve
        --metrics-port``).  Names are prefixed ``fleet_`` and
        sanitized; a raising gauge costs its series, never the
        scrape."""
        with self._lock:
            counters = dict(self._counters)
            hists = dict(self._hists)
            gauges = dict(self._gauges)
        lines: List[str] = []

        def emit(name: str, kind: str, samples) -> None:
            lines.append(f"# TYPE {name} {kind}")
            for labels, value in samples:
                lines.append(f"{name}{labels} {_prom_num(value)}")

        for name in sorted(counters):
            emit(_prom_name(name) + "_total", "counter",
                 [("", counters[name])])
        for name in sorted(gauges):
            try:
                val = gauges[name]()
            except Exception:   # pragma: no cover - gauge must not break
                continue
            gname = _prom_name(name)
            if isinstance(val, bool):
                continue
            if isinstance(val, (int, float)):
                emit(gname, "gauge", [("", val)])
            elif isinstance(val, dict):
                samples = [(f'{{key="{_prom_label(k)}"}}', v)
                           for k, v in sorted(val.items())
                           if isinstance(v, (int, float))
                           and not isinstance(v, bool)]
                if samples:
                    emit(gname, "gauge", samples)
        for name in sorted(hists):
            buckets, counts, count, total = hists[name].state()
            hname = _prom_name(name)
            lines.append(f"# TYPE {hname} histogram")
            seen = 0
            for edge, n in zip(buckets, counts):
                seen += n
                le = "+Inf" if edge == float("inf") else _prom_num(edge)
                lines.append(f'{hname}_bucket{{le="{le}"}} {seen}')
            lines.append(f"{hname}_sum {_prom_num(total)}")
            lines.append(f"{hname}_count {count}")
        return "\n".join(lines) + "\n"

    def start_http_server(self, port: int, host: str = "127.0.0.1"):
        """Serve ``GET /metrics`` (Prometheus text) and ``GET
        /metrics.json`` (the snapshot) on a daemon thread — stdlib
        ``http.server`` only, like the rest of the control plane.
        Returns the server; call its ``shutdown()`` to stop.  Metrics
        are operational telemetry, not completions, so this read-only
        endpoint is unauthenticated by design — bind it to loopback
        (the default) or a scrape-only network."""
        import http.server
        import json

        metrics = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):         # noqa: N802 - stdlib casing
                # Fan-in happens at scrape time: with `fanin` set this
                # endpoint serves the fleet-level merge of every
                # gateway process, not this process alone.
                src = metrics.merged() if metrics.fanin is not None \
                    else metrics
                if self.path.split("?")[0] == "/metrics.json":
                    body = json.dumps(src.snapshot()).encode()
                    ctype = "application/json"
                elif self.path.split("?")[0] in ("/", "/metrics"):
                    body = src.prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:
                pass    # scrapes are not log events

        try:
            server = http.server.ThreadingHTTPServer((host, int(port)),
                                                     Handler)
        except OSError:
            if not port:
                raise
            # The requested port is taken — with N gateway processes on
            # one host only the first wins a fixed --metrics-port, and
            # silently dying here would leave N-1 processes unscraped.
            # Fall back to an OS-assigned port; the `metrics_http_port`
            # gauge below tells scrapers (and `tfserve metrics`) where
            # this process actually landed.
            server = http.server.ThreadingHTTPServer((host, 0), Handler)
        server.daemon_threads = True
        bound_port = int(server.server_address[1])
        self.register_gauge("metrics_http_port", lambda p=bound_port: p)
        t = threading.Thread(target=server.serve_forever,
                             name="fleet-metrics-http", daemon=True)
        t.start()
        return server

    def report_line(self) -> str:
        """One log-friendly line: every counter and gauge, plus the
        headline latency numbers."""
        snap = self.snapshot()
        parts: List[str] = []
        for name in sorted(snap["counters"]):
            parts.append(f"{name}={snap['counters'][name]}")
        for name in sorted(snap["gauges"]):
            parts.append(f"{name}={snap['gauges'][name]}")
        for name in sorted(snap["histograms"]):
            h = snap["histograms"][name]
            if h.get("count"):
                # p50 AND p99: the autoscaler keys off tail latency, so
                # the tail must be a first-class observable, not a
                # median that hides the very stalls scaling reacts to.
                parts.append(f"{name}_p50={h['p50']}")
                parts.append(f"{name}_p99={h['p99']}")
        return "fleet: " + " ".join(parts)

    def start_reporter(self, log, interval: float = 10.0) -> None:
        """Log ``report_line()`` every ``interval`` seconds until
        :meth:`stop_reporter` (daemon thread; idempotent)."""
        if self._reporter is not None:
            return
        self._reporter_stop.clear()

        def loop() -> None:
            while not self._reporter_stop.wait(interval):
                log.info("%s", self.report_line())

        self._reporter = threading.Thread(target=loop, name="fleet-metrics",
                                          daemon=True)
        self._reporter.start()

    def stop_reporter(self) -> None:
        if self._reporter is None:
            return
        self._reporter_stop.set()
        self._reporter.join(timeout=2.0)
        self._reporter = None
