"""Workloads for the fleet simulator: synthesized and trace-replayed
(port of ``tfmesos_tpu/fleet/workload.py``).

Two sources feed :mod:`tfmesos_tpu_torch.fleet.sim` (docs/SIMULATOR.md):

* :class:`SyntheticWorkload` — a seeded generator of request arrivals:
  a Poisson (or fixed-interval) arrival process, lognormal prompt and
  decode-length distributions, a weighted priority-class mix (tenant
  skew is just an uneven mix), and optional per-request deadlines.
  Same seed, same stream — byte-for-byte, which is what makes every
  simulator scenario a deterministic regression gate.

* :func:`replay_from_traces` — a recorded ``tfserve trace -g GW
  --json`` export replayed as a workload: each retained trace record
  becomes one request, re-arriving at its recorded wall-clock offset
  with its recorded class and token counts, and
  :func:`fit_replica_model` distills the records' per-hop timings
  (TTFT, decode tail) into the latency-model parameters the simulated
  replicas run on.  The replay is an arrival/shape replay, not a
  byte-level one — see docs/SIMULATOR.md "Fidelity contract" for what
  is and is not preserved.

Everything here is stdlib-only and jax-free, like the rest of the
control plane.
"""

from __future__ import annotations

import bisect
import json
import math
import random
from typing import Any, Dict, Iterable, Iterator, List, NamedTuple, Optional

__all__ = ["Request", "SyntheticWorkload", "DiurnalWorkload",
           "replay_from_traces", "fit_replica_model", "fit_diurnal",
           "load_trace_export"]


class Request(NamedTuple):
    """One simulated arrival.  ``at`` is the absolute virtual-clock
    arrival time in seconds (ignored by closed-loop load generators);
    ``cls`` is the priority-class label (None = the default class).
    ``session`` labels a multi-turn conversation — the sim's KV-tier
    model resumes a later turn from the parked coverage, like the real
    fleet's ``tfserve submit --session`` (docs/SERVING.md)."""

    at: float
    cls: Optional[str]
    prompt_len: int
    new_tokens: int
    deadline_ms: Optional[float] = None
    session: Optional[str] = None
    #: model-catalog label (docs/SERVING.md "Model catalog"): the
    #: sim's gateway analog stamps it onto the forward like the real
    #: one, so the router's per-model tier and the trader's per-model
    #: pressure signals run in simulation too.  None = the default.
    model: Optional[str] = None


def _clamped_lognormal(rng: random.Random, median: float, sigma: float,
                       lo: int, hi: int) -> int:
    if median <= 0:
        return lo
    v = rng.lognormvariate(0.0, sigma) * median if sigma > 0 else median
    return max(lo, min(hi, int(round(v))))


class SyntheticWorkload:
    """Seeded arrival stream (iterable of :class:`Request`).

    ``rate`` is mean arrivals/second of virtual time: Poisson
    (exponential gaps) by default, fixed-interval with
    ``deterministic=True``.  ``class_mix`` maps class label ->
    relative weight of TRAFFIC (distinct from the class's WFQ service
    weight — a background tenant may emit 10x the traffic of the
    interactive one precisely to test that WFQ holds); ``None`` labels
    ride the fleet's default class.
    """

    def __init__(self, n_requests: int, rate: float, seed: int = 0,
                 class_mix: Optional[Dict[Optional[str], float]] = None,
                 prompt_len: int = 64, prompt_sigma: float = 0.5,
                 new_tokens: int = 16, new_tokens_sigma: float = 0.5,
                 max_prompt_len: int = 2048, max_new_tokens: int = 512,
                 deadline_ms: Optional[float] = None,
                 deadline_exempt: Optional[Iterable[str]] = None,
                 deterministic: bool = False, start_at: float = 0.0,
                 model: Optional[str] = None):
        if n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got {n_requests}")
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.n_requests = int(n_requests)
        self.rate = float(rate)
        self.seed = int(seed)
        mix = class_mix or {None: 1.0}
        total = float(sum(mix.values()))
        if total <= 0:
            raise ValueError(f"class_mix weights must sum > 0: {mix}")
        self._labels = list(mix)
        self._weights = [mix[k] / total for k in self._labels]
        self.prompt_len = int(prompt_len)
        self.prompt_sigma = float(prompt_sigma)
        self.new_tokens = int(new_tokens)
        self.new_tokens_sigma = float(new_tokens_sigma)
        self.max_prompt_len = int(max_prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.deadline_ms = deadline_ms
        # Classes whose arrivals carry NO deadline even when
        # ``deadline_ms`` is set — the batch-class semantics (the
        # offline lane is deadline-less by convention; its work waits
        # out interactive bursts instead of being shed).
        self.deadline_exempt = frozenset(deadline_exempt or ())
        self.deterministic = bool(deterministic)
        self.start_at = float(start_at)
        self.model = model

    def __iter__(self) -> Iterator[Request]:
        rng = random.Random(self.seed)
        t = self.start_at
        gap = 1.0 / self.rate
        for _ in range(self.n_requests):
            t += gap if self.deterministic else rng.expovariate(self.rate)
            cls = rng.choices(self._labels, weights=self._weights)[0]
            yield Request(
                at=t, cls=cls,
                prompt_len=_clamped_lognormal(
                    rng, self.prompt_len, self.prompt_sigma, 1,
                    self.max_prompt_len),
                new_tokens=_clamped_lognormal(
                    rng, self.new_tokens, self.new_tokens_sigma, 1,
                    self.max_new_tokens),
                deadline_ms=(None if cls in self.deadline_exempt
                             else self.deadline_ms),
                model=self.model)


class DiurnalWorkload:
    """Seeded DIURNAL arrival stream (iterable of :class:`Request`):
    a non-homogeneous Poisson process whose instantaneous rate rides a
    sinusoidal day/night envelope plus optional seeded burst spikes —
    the traffic shape a planet-scale front door actually sees, where a
    steady-``rate`` stream would flatter every saturation number.

    The rate at virtual time ``t`` is::

        rate(t) = base_rate * envelope(t) * burst(t)
        envelope(t) = 1 + (peak_ratio - 1) *
                      (0.5 + 0.5 * sin(2*pi*t/period_s + phase))

    so traffic swings [base_rate, base_rate*peak_ratio] once per
    ``period_s``.  ``bursts`` seeded spikes each multiply the rate by
    ``burst_ratio`` for ``burst_duration_s`` (flash crowds riding on
    top of the diurnal swell).  Arrivals are drawn by Lewis-Shedler
    thinning, so the stream is exact and byte-for-byte deterministic
    per seed.

    ``class_mix`` is the tenant mix (label -> traffic weight);
    ``class_phases`` optionally phase-shifts each tenant's share of
    the envelope (an interactive tenant peaking at local noon while a
    batch tenant fills the trough), normalized per arrival.  Fit the
    envelope constants from a real ``tfserve trace --json`` export
    with :func:`fit_diurnal`.
    """

    def __init__(self, n_requests: int, base_rate: float, seed: int = 0,
                 period_s: float = 86400.0, peak_ratio: float = 4.0,
                 phase: float = 0.0,
                 bursts: int = 0, burst_ratio: float = 4.0,
                 burst_duration_s: float = 60.0,
                 class_mix: Optional[Dict[Optional[str], float]] = None,
                 class_phases: Optional[Dict[Optional[str], float]] = None,
                 prompt_len: int = 64, prompt_sigma: float = 0.5,
                 new_tokens: int = 16, new_tokens_sigma: float = 0.5,
                 max_prompt_len: int = 2048, max_new_tokens: int = 512,
                 deadline_ms: Optional[float] = None,
                 deadline_exempt: Optional[Iterable[str]] = None,
                 start_at: float = 0.0,
                 model: Optional[str] = None):
        if n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got {n_requests}")
        if base_rate <= 0:
            raise ValueError(f"base_rate must be > 0, got {base_rate}")
        if period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {period_s}")
        if peak_ratio < 1.0:
            raise ValueError(
                f"peak_ratio must be >= 1 (the envelope never dips "
                f"below base_rate), got {peak_ratio}")
        if bursts < 0:
            raise ValueError(f"bursts must be >= 0, got {bursts}")
        if bursts and (burst_ratio < 1.0 or burst_duration_s <= 0):
            raise ValueError(
                f"bursts need burst_ratio >= 1 and burst_duration_s "
                f"> 0, got {burst_ratio}/{burst_duration_s}")
        self.n_requests = int(n_requests)
        self.base_rate = float(base_rate)
        self.seed = int(seed)
        self.period_s = float(period_s)
        self.peak_ratio = float(peak_ratio)
        self.phase = float(phase)
        self.bursts = int(bursts)
        self.burst_ratio = float(burst_ratio)
        self.burst_duration_s = float(burst_duration_s)
        mix = class_mix or {None: 1.0}
        total = float(sum(mix.values()))
        if total <= 0:
            raise ValueError(f"class_mix weights must sum > 0: {mix}")
        self._labels = list(mix)
        self._weights = [mix[k] / total for k in self._labels]
        self._phases = dict(class_phases or {})
        # Hot-path class pick without phases: one rng.random + bisect
        # over precomputed cumulative weights (rng.choices rebuilds
        # its cumulative table per call — measurable at 1M arrivals).
        self._cum: List[float] = []
        acc = 0.0
        for w in self._weights:
            acc += w
            self._cum.append(acc)
        self.prompt_len = int(prompt_len)
        self.prompt_sigma = float(prompt_sigma)
        self.new_tokens = int(new_tokens)
        self.new_tokens_sigma = float(new_tokens_sigma)
        self.max_prompt_len = int(max_prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.deadline_ms = deadline_ms
        # Same batch-class exemption as SyntheticWorkload: listed
        # classes arrive deadline-less (the trough-filling offline
        # tenant in a phase-shifted mix).
        self.deadline_exempt = frozenset(deadline_exempt or ())
        self.start_at = float(start_at)
        self.model = model

    def envelope(self, t: float) -> float:
        """The diurnal multiplier at virtual time ``t`` (>= 1.0)."""
        s = math.sin(2.0 * math.pi * t / self.period_s + self.phase)
        return 1.0 + (self.peak_ratio - 1.0) * (0.5 + 0.5 * s)

    def _burst_windows(self, rng: random.Random,
                       horizon: float) -> List[tuple]:
        return sorted(
            (b, b + self.burst_duration_s)
            for b in (rng.uniform(0.0, horizon)
                      for _ in range(self.bursts)))

    def rate_at(self, t: float, windows: List[tuple]) -> float:
        r = self.base_rate * self.envelope(t)
        for lo, hi in windows:
            if lo <= t < hi:
                r *= self.burst_ratio
                break
        return r

    def _pick_class(self, rng: random.Random, t: float):
        if not self._phases or len(self._labels) == 1:
            if len(self._labels) == 1:
                return self._labels[0]
            i = bisect.bisect_right(self._cum, rng.random() * self._cum[-1])
            return self._labels[min(i, len(self._labels) - 1)]
        # Tenant phase shifts: each class's share rides its own
        # sinusoid (same period), renormalized at this instant.
        w = []
        for label, base_w in zip(self._labels, self._weights):
            ph = self._phases.get(label)
            if ph is None:
                w.append(base_w)
            else:
                s = math.sin(2.0 * math.pi * t / self.period_s
                             + self.phase + float(ph))
                w.append(base_w * (0.5 + 0.5 * s) + 1e-9)
        return rng.choices(self._labels, weights=w)[0]

    def __iter__(self) -> Iterator[Request]:
        rng = random.Random(self.seed)
        # Burst placement needs a horizon before arrivals exist: the
        # expected span of n_requests at the MEAN envelope rate.
        mean_rate = self.base_rate * (1.0 + (self.peak_ratio - 1.0) / 2)
        horizon = self.n_requests / mean_rate
        windows = self._burst_windows(rng, horizon) if self.bursts \
            else []
        # Lewis-Shedler thinning with a PIECEWISE-CONSTANT majorant:
        # outside burst windows the ceiling is base*peak, inside it is
        # base*peak*burst_ratio — a global ceiling would reject ~2/3
        # of candidates for the whole stream to cover windows spanning
        # a fraction of it.  Exactness holds by the exponential's
        # memorylessness: a step that would cross a majorant boundary
        # ADVANCES to the boundary and redraws at the new ceiling
        # (the standard non-homogeneous thinning refinement).  The
        # hot loop is inlined — this generator feeds million-request
        # sim runs where every per-arrival microsecond is wall time.
        bounds: List[float] = []
        for lo, hi in windows:         # merge overlaps into [lo, hi)
            if bounds and lo <= bounds[-1]:
                bounds[-1] = max(bounds[-1], hi)
            else:
                bounds.extend((lo, hi))
        plain_max = self.base_rate * self.peak_ratio
        burst_max = plain_max * self.burst_ratio
        amp = self.base_rate * (self.peak_ratio - 1.0) * 0.5
        mid = self.base_rate + amp
        omega = 2.0 * math.pi / self.period_s
        ph = self.phase
        burst_ratio = self.burst_ratio
        n, start_at = self.n_requests, self.start_at
        u, ev, sin, bis = (rng.random, rng.expovariate, math.sin,
                           bisect.bisect_right)
        p_med, p_sig = self.prompt_len, self.prompt_sigma
        o_med, o_sig = self.new_tokens, self.new_tokens_sigma
        rel = 0.0
        emitted = 0
        while emitted < n:
            i = bis(bounds, rel)
            in_burst = i & 1           # odd index = inside a window
            ceiling = burst_max if in_burst else plain_max
            step = ev(ceiling)
            if i < len(bounds) and rel + step >= bounds[i]:
                rel = bounds[i]        # crossed into the next segment:
                continue               # redraw at its ceiling (exact)
            rel += step
            rate = mid + amp * sin(omega * rel + ph)
            if in_burst:
                rate *= burst_ratio
            if u() * ceiling > rate:
                continue
            emitted += 1
            cls = self._pick_class(rng, rel)
            yield Request(
                at=start_at + rel, cls=cls,
                prompt_len=_clamped_lognormal(
                    rng, p_med, p_sig, 1, self.max_prompt_len),
                new_tokens=_clamped_lognormal(
                    rng, o_med, o_sig, 1, self.max_new_tokens),
                deadline_ms=(None if cls in self.deadline_exempt
                             else self.deadline_ms),
                model=self.model)


# -- trace replay ------------------------------------------------------------


def load_trace_export(path: str) -> List[dict]:
    """Parse a ``tfserve trace -g GW --json`` export file: either one
    JSON array or JSON-lines, each element a trace record dict."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read().strip()
    if not text:
        return []
    if text[0] == "[":
        records = json.loads(text)
    else:
        records = [json.loads(line) for line in text.splitlines() if line]
    return [r for r in records if isinstance(r, dict)]


def _num(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else None


def replay_from_traces(records: Iterable[dict],
                       speedup: float = 1.0,
                       deadline_ms: Optional[float] = None
                       ) -> List[Request]:
    """Turn trace records into a replayable arrival list: each record
    re-arrives at its recorded wall-clock offset (``ts``, compressed
    by ``speedup``) with its recorded class and token counts.  Records
    are replayed in timestamp order; the first arrival lands at t=0.
    Prompt length comes from the retained ``gateway.recv`` span when
    the record kept detail, else a small default — the export's
    summary records carry class/latency/tokens but not the prompt."""
    rows = []
    for rec in records:
        ts = _num(rec.get("ts"))
        if ts is None:
            continue
        summary = rec.get("summary") or {}
        cls = summary.get("cls")
        tokens = _num(summary.get("tokens"))
        prompt_len = None
        for span in rec.get("spans") or ():
            if isinstance(span, dict) and span.get("name") == "recv":
                prompt_len = _num(span.get("prompt_len"))
                break
        rows.append((ts, cls if isinstance(cls, str) else None,
                     int(prompt_len) if prompt_len else 16,
                     int(tokens) if tokens and tokens > 0 else 8))
    rows.sort(key=lambda r: r[0])
    if not rows:
        return []
    t0 = rows[0][0]
    scale = 1.0 / max(1e-9, float(speedup))
    return [Request(at=(ts - t0) * scale, cls=cls, prompt_len=pl,
                    new_tokens=nt, deadline_ms=deadline_ms)
            for ts, cls, pl, nt in rows]


def fit_replica_model(records: Iterable[dict]) -> Dict[str, Any]:
    """Distill recorded traces into latency-model parameters for the
    simulated replicas: median TTFT (the prefill estimate) and median
    per-token decode time, from completed records carrying ``ttft_ms``
    + ``total_ms`` + a token count.  Returns a possibly-empty dict of
    ``{"prefill_base_ms", "decode_ms_per_token"}`` — callers lay the
    fitted values over :class:`tfmesos_tpu_torch.fleet.sim.ReplicaModel`
    defaults and keep whatever the traces could not determine."""
    ttfts: List[float] = []
    per_tok: List[float] = []
    for rec in records:
        if not isinstance(rec, dict) or rec.get("status") != "completed":
            continue
        summary = rec.get("summary") or {}
        ttft = _num(summary.get("ttft_ms"))
        total = _num(rec.get("total_ms"))
        tokens = _num(summary.get("tokens"))
        if ttft is not None and ttft >= 0:
            ttfts.append(ttft)
        if total is not None and ttft is not None and tokens \
                and tokens > 0 and total > ttft:
            per_tok.append((total - ttft) / tokens)
    out: Dict[str, Any] = {}
    if ttfts:
        ttfts.sort()
        out["prefill_base_ms"] = round(ttfts[len(ttfts) // 2], 3)
    if per_tok:
        per_tok.sort()
        out["decode_ms_per_token"] = round(per_tok[len(per_tok) // 2], 3)
    return out


def fit_diurnal(records: Iterable[dict],
                period_s: Optional[float] = None,
                bins: int = 48) -> Dict[str, Any]:
    """Fit :class:`DiurnalWorkload` envelope constants from a
    ``tfserve trace --json`` export: arrival timestamps are bucketed
    into ``bins`` equal windows over the recorded span, the trough
    (10th-percentile bin rate) becomes ``base_rate``, the crest
    (90th) sets ``peak_ratio``, and the busiest bin's center sets
    ``phase`` so the fitted sinusoid peaks where the trace did.
    ``period_s`` defaults to the recorded span (assume the export
    caught one full cycle).  Returns a possibly-empty dict of
    ``{"base_rate", "peak_ratio", "period_s", "phase"}`` — lay it
    over :class:`DiurnalWorkload` defaults like
    :func:`fit_replica_model` does for :class:`ReplicaModel`."""
    ts = sorted(t for t in (_num(r.get("ts")) for r in records
                            if isinstance(r, dict)) if t is not None)
    if len(ts) < 2 or ts[-1] <= ts[0]:
        return {}
    span = ts[-1] - ts[0]
    period = float(period_s) if period_s else span
    if period <= 0:
        return {}
    bins = max(2, int(bins))
    width = span / bins
    counts = [0] * bins
    for t in ts:
        counts[min(bins - 1, int((t - ts[0]) / width))] += 1
    rates = sorted(c / width for c in counts)
    base = rates[int(0.10 * (bins - 1))]
    peak = rates[int(0.90 * (bins - 1))]
    if base <= 0:
        # A trace with dead-silent troughs: anchor the base on the
        # quietest NON-EMPTY bin so peak_ratio stays finite.
        nonzero = [r for r in rates if r > 0]
        if not nonzero:
            return {}
        base = nonzero[0]
    busiest = counts.index(max(counts))
    center = (busiest + 0.5) * width
    # envelope() peaks where sin(2*pi*t/period + phase) == 1.
    phase = math.pi / 2 - 2.0 * math.pi * center / period
    return {"base_rate": round(base, 6),
            "peak_ratio": round(max(1.0, peak / base), 4),
            "period_s": round(period, 3),
            "phase": round(phase, 6)}
