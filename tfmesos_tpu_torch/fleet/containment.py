"""Failure containment primitives: retry budgets and circuit breakers (port of ``tfmesos_tpu/fleet/containment.py``).

Two mechanisms the router composes into its retry loop, both jax-free
and stdlib-only like the rest of the control plane:

* :class:`RetryBudget` — a fleet-wide token-ratio budget in the gRPC
  throttling style: every retry debits one token, every delivered
  completion refills ``token_ratio`` of one, and retries are permitted
  only while the balance stays above half of ``max_tokens``.  Under a
  brown-out (most requests failing, few completing) the balance
  collapses and the fleet degrades to ~1 attempt per request instead of
  multiplying its own load ``max_retries``-fold — the retry-storm
  amplification that turns a brown-out into an outage.  Exhausted
  budget converts retryable errors into fast deterministic failures the
  client can back off on.

* :class:`CircuitBreaker` / :class:`BreakerBoard` — per-replica
  breakers with TWO trip conditions: ``failures`` consecutive failures
  (the classic crash/flap detector), and a latency outlier — the
  replica's success-latency EWMA exceeding ``latency_factor`` times the
  median EWMA of its peers.  The second is the first mechanism in the
  fleet that catches a GRAY failure: a replica that answers every
  heartbeat on time (so the registry reports it alive) but serves 100x
  slow.  An open breaker excludes the replica from every router pick;
  after ``cooldown_s`` it goes half-open and admits exactly ONE probe
  request — success closes it, failure re-opens with exponential
  backoff (capped at ``max_cooldown_s``).  Breakers mark nothing dead:
  the registry keeps its own liveness truth, and a recovered replica
  re-enters routing through its probe, not through operator action.

Both are exported through the gateway's metrics snapshot (the
``breakers`` and ``retry_budget`` gauges plus the router's counters) —
during a brown-out they are the on-call's first questions.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

__all__ = ["RetryBudget", "BreakerConfig", "CircuitBreaker",
           "BreakerBoard", "CLOSED", "OPEN", "HALF_OPEN",
           "DEFAULT_MAX_TOKENS", "DEFAULT_TOKEN_RATIO"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: Retry-budget defaults (sweepable as ``budget.max_tokens`` /
#: ``budget.token_ratio`` in ``tfserve simulate``).  10 tokens of
#: runway absorbs a short failure burst without throttling; a 0.1
#: refill per delivered completion means sustained retries above ~10%
#: of throughput drain the budget and failovers stop — the simulator's
#: ``soak-replay`` scenario holds retry amplification under 1.5
#: through a replica death at these values, and a brown-out sweep
#: (``budget.token_ratio=0.05,0.1,0.5``) shows 0.5 re-arming the storm
#: while 0.05 starves legitimate failovers.
DEFAULT_MAX_TOKENS = 10.0
DEFAULT_TOKEN_RATIO = 0.1


class RetryBudget:
    """Fleet-wide retry budget (gRPC-throttling style token ratio).

    ``try_retry()`` is consulted before every failover: it debits one
    token and answers whether the balance (pre-debit) was above half of
    ``max_tokens`` — so sustained failures drain the budget even while
    it still says yes, and the cutoff arrives deterministically.
    ``on_success()`` refills ``token_ratio`` tokens per delivered
    completion, so a healthy fleet recovers its budget at a rate
    proportional to real throughput, never by wall clock (a wall-clock
    refill would re-arm the storm on a schedule).
    """

    def __init__(self, max_tokens: float = DEFAULT_MAX_TOKENS,
                 token_ratio: float = DEFAULT_TOKEN_RATIO):
        if max_tokens <= 0 or token_ratio <= 0:
            raise ValueError(
                f"max_tokens and token_ratio must be > 0, got "
                f"{max_tokens} / {token_ratio}")
        self.max_tokens = float(max_tokens)
        self.token_ratio = float(token_ratio)
        self._tokens = self.max_tokens
        self._lock = threading.Lock()

    def try_retry(self) -> bool:
        with self._lock:
            allowed = self._tokens > self.max_tokens / 2.0
            self._tokens = max(0.0, self._tokens - 1.0)
            return allowed

    def on_success(self) -> None:
        with self._lock:
            self._tokens = min(self.max_tokens,
                               self._tokens + self.token_ratio)

    def level(self) -> float:
        """Remaining budget as a 0..1 fraction (the gateway's
        ``retry_budget`` gauge; retries stop below 0.5)."""
        with self._lock:
            return self._tokens / self.max_tokens


@dataclasses.dataclass
class BreakerConfig:
    """Per-replica circuit-breaker thresholds (docs/SERVING.md
    "Deadlines & failure containment").

    ``failures`` consecutive failures trip; a success-latency EWMA above
    ``latency_factor`` times the median of the peers' EWMAs (with at
    least ``min_samples`` observations on each side and an absolute
    ``latency_floor_ms`` so microsecond-scale jitter can never trip)
    trips too — the gray-failure detector.  An open breaker waits
    ``cooldown_s`` before its single half-open probe; every failed probe
    doubles the wait up to ``max_cooldown_s``.

    Every threshold here is sweepable by path in the fleet simulator
    (``tfserve simulate soak-replay --sweep breaker.latency_factor=
    2,4,8`` — docs/SIMULATOR.md): ``latency_factor=4`` is the value at
    which the ``soak-replay`` scenario isolates a 20x-slow gray replica
    within its traffic warmup while a healthy fleet's natural p99/p50
    spread (~2-3x under bursty arrivals) never trips; 2 flaps on load
    skew, 8 lets the gray replica serve for multiples of the detection
    window.  ``failures=3`` / ``cooldown_s=2`` come from the same
    scenario's SIGKILL phase: the dead replica is out of every
    candidate set before the heartbeat sweeper even marks it."""

    failures: int = 3
    cooldown_s: float = 2.0
    max_cooldown_s: float = 30.0
    latency_factor: float = 4.0
    latency_floor_ms: float = 50.0
    min_samples: int = 5
    ewma_alpha: float = 0.3

    def __post_init__(self):
        if self.failures < 1:
            raise ValueError(f"failures must be >= 1, got {self.failures}")
        if self.cooldown_s <= 0 or self.max_cooldown_s < self.cooldown_s:
            raise ValueError(
                f"need 0 < cooldown_s <= max_cooldown_s, got "
                f"{self.cooldown_s} / {self.max_cooldown_s}")
        if self.latency_factor <= 1.0:
            raise ValueError(f"latency_factor must be > 1, got "
                             f"{self.latency_factor}")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got "
                             f"{self.ewma_alpha}")


class CircuitBreaker:
    """One replica's breaker state (owned by a :class:`BreakerBoard`,
    which holds the lock and the peer context for the latency check)."""

    __slots__ = ("addr", "state", "consecutive_failures", "ewma_ms",
                 "samples", "trips", "open_until", "cooldown",
                 "probing_since", "reason")

    def __init__(self, addr: str):
        self.addr = addr
        self.state = CLOSED
        self.consecutive_failures = 0
        self.ewma_ms = 0.0
        self.samples = 0
        self.trips = 0
        self.open_until = 0.0
        self.cooldown = 0.0          # current backoff (set at first trip)
        self.probing_since = 0.0
        self.reason = ""

    def describe(self) -> Dict[str, object]:
        return {"state": self.state,
                "ewma_ms": round(self.ewma_ms, 3),
                "consecutive_failures": self.consecutive_failures,
                "trips": self.trips,
                "reason": self.reason}


class BreakerBoard:
    """All replica breakers plus the cross-replica latency context.

    The router consults :meth:`eligible` when building candidate sets
    (side-effect-free — a filtered-out candidate must not consume the
    half-open probe slot), calls :meth:`on_dispatch` for the ONE replica
    it actually picked (which is what claims the probe), and reports
    every outcome through :meth:`record_success` /
    :meth:`record_failure`.  Trips are evaluated inside the records, so
    there is no sweeper thread to race.
    """

    def __init__(self, config: Optional[BreakerConfig] = None,
                 clock=time.monotonic):
        self.config = config or BreakerConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}
        self.trips = 0
        self.latency_trips = 0
        self.recoveries = 0
        # Count of breakers NOT in CLOSED state: the router's per-pick
        # filter short-circuits to "everyone eligible" while this is 0
        # (the overwhelmingly common state) instead of querying every
        # candidate — O(1) instead of O(replicas) per request.
        self._nonclosed = 0

    def all_closed(self) -> bool:
        """True while every breaker is CLOSED — read lock-free (a
        single int; a stale read costs one pick a full filter pass,
        never a wrong routing decision, since the filter re-checks
        every candidate under the lock)."""
        return self._nonclosed == 0

    def _get(self, addr: str) -> CircuitBreaker:
        b = self._breakers.get(addr)
        if b is None:
            b = self._breakers[addr] = CircuitBreaker(addr)
        return b

    # -- routing-side queries ----------------------------------------------

    def eligible(self, addr: str) -> bool:
        """Whether the router may CANDIDATE this replica right now.
        Closed: yes.  Open: only once the cooldown has elapsed (the
        pick that follows becomes the probe).  Half-open: only while no
        probe is in flight — one request at a time tests a suspect
        replica, never a thundering herd (a stale probe older than the
        max cooldown is presumed lost and releases the slot)."""
        now = self._clock()
        with self._lock:
            b = self._breakers.get(addr)
            if b is None or b.state == CLOSED:
                return True
            if b.state == OPEN:
                return now >= b.open_until
            # HALF_OPEN
            return (not b.probing_since
                    or now - b.probing_since > self.config.max_cooldown_s)

    def on_dispatch(self, addr: str) -> bool:
        """The router picked ``addr``: if its breaker was waiting for a
        probe, THIS request claims it — returns True for exactly one
        caller (the probe), False for everyone else.  The caller
        threads the flag back into :meth:`record_success` /
        :meth:`record_failure` so only the sanctioned probe's outcome
        can close or re-open the breaker; a pre-trip straggler (or a
        request that raced the eligible()->pick window) merely feeds
        the statistics.  That race window — several workers passing
        ``eligible`` before the first reaches here — can leak a couple
        of extra requests onto a suspect replica, but it is pick-to-
        dispatch small and none of the leakers can flip the state."""
        now = self._clock()
        with self._lock:
            b = self._breakers.get(addr)
            if b is None or b.state == CLOSED:
                return False
            if b.state == OPEN and now >= b.open_until:
                b.state = HALF_OPEN
                b.probing_since = 0.0
            if b.state == HALF_OPEN and (
                    not b.probing_since
                    or now - b.probing_since > self.config.max_cooldown_s):
                b.probing_since = now
                return True
            return False

    # -- outcome records ---------------------------------------------------

    def _trip(self, b: CircuitBreaker, now: float, reason: str) -> None:
        if b.state == CLOSED:
            self._nonclosed += 1
        b.state = OPEN
        b.cooldown = (self.config.cooldown_s if not b.cooldown
                      else min(2.0 * b.cooldown,
                               self.config.max_cooldown_s))
        b.open_until = now + b.cooldown
        b.probing_since = 0.0
        b.trips += 1
        b.reason = reason
        self.trips += 1
        if reason == "latency_outlier":
            self.latency_trips += 1

    def record_success(self, addr: str, latency_ms: float,
                       probe: bool = False) -> None:
        """One completed call: closes a half-open breaker when it was
        THE probe (the ``on_dispatch`` claim rides back in ``probe`` —
        a pre-trip straggler landing mid-probe must not close the gate
        the probe is still testing), resets the consecutive-failure
        count, folds the latency into the EWMA, and evaluates the
        latency-outlier trip against the peer median — the check runs
        on SUCCESSES because a gray-slow replica fails nothing; its
        requests all complete, just 100x late."""
        now = self._clock()
        cfg = self.config
        with self._lock:
            b = self._get(addr)
            if b.state == HALF_OPEN and probe:
                # The probe came back: the replica serves again.  The
                # cooldown is NOT reset — a flapping replica re-trips
                # onto its grown backoff.  A LATENCY trip additionally
                # resets the EWMA history: the stale high average must
                # not re-trip the breaker off one fast probe (a
                # transient spike — e.g. a cold compile — would
                # otherwise lock a healthy replica out for many grown
                # cooldowns); a replica that is STILL slow re-earns its
                # trip over min_samples fresh observations.
                if b.reason == "latency_outlier":
                    b.ewma_ms = 0.0
                    b.samples = 0
                b.state = CLOSED
                self._nonclosed -= 1
                b.probing_since = 0.0
                b.reason = ""
                self.recoveries += 1
            b.consecutive_failures = 0
            if b.samples == 0:
                b.ewma_ms = float(latency_ms)
            else:
                b.ewma_ms += cfg.ewma_alpha * (float(latency_ms)
                                               - b.ewma_ms)
            b.samples += 1
            if b.state != CLOSED:
                # A straggler of a pre-trip dispatch while OPEN: its
                # latency still feeds the EWMA, but only the cooldown-
                # gated probe may close (or re-trip) the breaker.
                return
            if b.samples < cfg.min_samples \
                    or b.ewma_ms < cfg.latency_floor_ms:
                return
            peers = [p.ewma_ms for p in self._breakers.values()
                     if p is not b and p.samples >= cfg.min_samples]
            if not peers:
                return          # no baseline: an outlier needs peers
            peers.sort()
            median = peers[len(peers) // 2]
            if median > 0 and b.ewma_ms > cfg.latency_factor * median:
                self._trip(b, now, "latency_outlier")

    def record_failure(self, addr: str, probe: bool = False) -> None:
        """One failed call (timeout, connection loss, replica internal
        error — never a deterministic bad_request): a failed half-open
        PROBE re-opens immediately with doubled cooldown (a straggler
        failing mid-probe only advances the statistics — the probe in
        flight still decides); otherwise the consecutive-failure count
        advances toward its trip."""
        now = self._clock()
        with self._lock:
            b = self._get(addr)
            b.consecutive_failures += 1
            if b.state == HALF_OPEN:
                if probe:
                    self._trip(b, now, "probe_failed")
                return
            if b.state == CLOSED \
                    and b.consecutive_failures >= self.config.failures:
                self._trip(b, now, "consecutive_failures")

    # -- observability -----------------------------------------------------

    def state_of(self, addr: str) -> str:
        with self._lock:
            b = self._breakers.get(addr)
            return b.state if b is not None else CLOSED

    def open_addrs(self) -> List[str]:
        now = self._clock()
        with self._lock:
            return [a for a, b in self._breakers.items()
                    if b.state == OPEN and now < b.open_until]

    def summary(self) -> Dict[str, object]:
        """The small dict the gateway exports as its ``breakers`` gauge
        (the report line prints it verbatim)."""
        with self._lock:
            return {
                "open": sorted(a for a, b in self._breakers.items()
                               if b.state == OPEN),
                "half_open": sorted(a for a, b in self._breakers.items()
                                    if b.state == HALF_OPEN),
                "trips": self.trips,
                "latency_trips": self.latency_trips,
                "recoveries": self.recoveries,
            }

    def describe(self) -> Dict[str, dict]:
        """Per-replica breaker detail (state, EWMA, failure streak,
        trip count and reason)."""
        with self._lock:
            return {a: b.describe() for a, b in self._breakers.items()}
