"""Load-aware request routing across the replica fleet (port of
``tfmesos_tpu/fleet/router.py``).

Replica choice is **prefix-affinity first, then
least-outstanding-requests with power-of-two-choices sampling**:

* Affinity: replicas running a cross-request prefix cache advertise
  their resident chunk digests on registry heartbeats; the router
  hashes the incoming prompt's leading page-aligned chunks
  (:mod:`tfmesos_tpu_torch.prefixhash` — the same chain both sides compute)
  and prefers the replica with the LONGEST match, so requests sharing
  a system/few-shot prefix concentrate where the prefix's KV pages
  already live and prefill only their tails.  A saturated favorite
  (outstanding >= its advertised capacity) is skipped — affinity must
  never turn into a hot-spot pile-up.
* Fallback (no summaries, no match, favorite saturated): p2c — with
  many alive replicas, sampling two uniformly and taking the
  less-loaded one gets within a constant of full least-loaded routing
  at O(1) cost and — crucially — without the herd behavior of everyone
  chasing the single globally-least-loaded replica between load
  updates.

The load signal is the router's OWN outstanding count per replica link
(what we have in hand is exact and instantaneous; the registry's
self-reported count lags a heartbeat).

Failure handling is **bounded retry-with-backoff onto a DIFFERENT
replica**: a connection failure (dial refused, mid-request EOF, bad
frame) marks the replica dead in the registry, drops its link, and the
request is retried elsewhere — safe for generation because replica
outputs are deterministic functions of the request (greedy streams are
bit-identical across replicas; the dead replica never delivered a
completion, so nothing double-counts).  After ``max_retries`` failovers
the request fails with :class:`RoutingError` and the gateway reports it
to the client explicitly — never a silent hang.

**Disaggregated (role-aware) routing**: replicas advertise
``role: prefill|decode|unified`` on heartbeats.  When BOTH a prefill
tier and a decode tier are alive, a generate request takes the
two-phase path: (1) pick a prefill replica — prefix-affinity first
(shared system prompts concentrate where their KV pages live), then
least-outstanding p2c — and call its ``prefill`` op; (2) forward the
returned KV artifact (one raw binary frame, never re-encoded) to a
decode replica picked by KV-page headroom (p2c over heartbeat-
advertised free pages, saturated replicas skipped), which imports the
pages and decodes.  Each phase retries onto a different replica within
the shared ``max_retries`` budget; when a tier is empty — or the
disaggregated path exhausts its retries — the request FALLS BACK to
the unified tier, so an all-unified fleet (every existing deployment)
routes exactly as before.  Plain generates never land on a
prefill-role replica.

**Drain migration (suspended replies)**: a replica being drained away
(autoscaler scale-down, blue-green reap — ``tfserve``'s
drain-migrate-kill) answers its in-flight generates with ``suspended``
instead of a completion: a raw HMAC frame carrying the row's resumable
KV artifact (pages + mid-stream sampler state), or a plain requeue
marker when the request held no exportable state.  The router
RE-PLACES either form transparently: an artifact resumes on a replica
advertising the SAME ``weights_version`` (resuming old-weights KV
under new weights would be a silently wrong stream — the one failure
mode this path must never have) whose launch generation passes the
registry fence (a reaped-rollout zombie's export can never land);
anything else — requeue, fence rejection, version mismatch, artifact
rejection — falls back to RE-RUNNING the whole request on another
replica, which is equally lossless because nothing was delivered and
completions are deterministic.  The client sees one completion, never
the move; ``migration_*`` counters make each path observable.

**Failure containment** (docs/SERVING.md "Deadlines & failure
containment"): three mechanisms bound every failure's blast radius:

* **End-to-end deadlines**: a request forwarded with a ``deadline``
  (absolute, gateway-stamped) fails FAST with ``deadline_exceeded``
  the moment its budget runs out — at the loop head, never mid-retry —
  and every wire call's timeout is a SLICE of the remaining budget
  (non-final attempts keep half back for a retry, the disagg prefill
  phase keeps three quarters back for decode) instead of the flat
  ``request_timeout``, so one hung replica can never consume the whole
  budget.  The remaining budget is re-stamped onto the wire as
  ``deadline_ms`` per attempt, so the replica's own in-batcher cancel
  works from the same (shrinking) clock.
* **Fleet retry budget** (:class:`~tfmesos_tpu_torch.fleet.containment.
  RetryBudget`): every failover debits a token-ratio budget refilled by
  delivered completions — under a brown-out the fleet degrades to ~1
  attempt per request instead of multiplying its own load, and an
  exhausted budget converts retryable errors into fast deterministic
  failures (``retry_budget_exhausted`` counter).
* **Per-replica circuit breakers** (:class:`~tfmesos_tpu_torch.fleet.
  containment.BreakerBoard`): consecutive failures OR a success-latency
  EWMA far above the peer median trip a replica out of every candidate
  set — the latter is the first mechanism that catches a GRAY failure,
  a replica the heartbeat registry still reports alive but that serves
  100x slow.  Half-open single-probe recovery; state exported through
  ``describe()`` and the gateway's ``breakers`` gauge.

**Warming replicas** (registered with ``status: warming`` while
``ContinuousBatcher.warmup`` compiles their entry points) are excluded
by EVERY pick — ``pick``/``pick_prefill``/``pick_decode`` all candidate
through ``registry.alive()``, which a warming replica is not in.  A
tier whose only members are warming behaves exactly like an empty
tier: the unified path raises :class:`RoutingError`'s "no alive
replicas" (or retries another tier member), and the disaggregated path
falls back to unified — the same fallback semantics as above, so a
re-warming relaunch is indistinguishable from a not-yet-launched
replica to routing.
"""

from __future__ import annotations

import itertools
import os
import random
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

from tfmesos_tpu_torch import prefixhash, wire
from tfmesos_tpu_torch.fleet import tracing
from tfmesos_tpu_torch.fleet.client import (CallTimeout, ConnectionLost,
                                            MuxConnection)
from tfmesos_tpu_torch.fleet.containment import (BreakerBoard, BreakerConfig,
                                                 RetryBudget)
from tfmesos_tpu_torch.fleet.metrics import FleetMetrics
from tfmesos_tpu_torch.fleet.registry import (DECODE, PREFILL, UNIFIED,
                                              ReplicaInfo, ReplicaRegistry)
from tfmesos_tpu_torch.utils.logging import get_logger

__all__ = ["RoutingError", "Router"]

#: process-wide transfer-id stream for direct peer-to-peer KV pushes
#: (the pid prefix keeps two gateway processes' ids from colliding in
#: one decode replica's staging area).
_XFER_SEQ = itertools.count(1)


def _new_xfer_id() -> str:
    return f"xf-{os.getpid()}-{next(_XFER_SEQ)}"


class RoutingError(RuntimeError):
    """No replica could serve the request within the retry budget."""


class Router:
    """Routes one request dict to one replica and returns its reply."""

    def __init__(self, registry: ReplicaRegistry, metrics: FleetMetrics,
                 token: str = "", max_retries: int = 2,
                 backoff_s: float = 0.05, request_timeout: float = 120.0,
                 connect_timeout: float = 10.0,
                 rng: Optional[random.Random] = None,
                 breakers: bool = True,
                 breaker_config: Optional[BreakerConfig] = None,
                 retry_budget: Optional[RetryBudget] = None,
                 clock=time.monotonic, sleep=time.sleep,
                 link_factory=None):
        self.registry = registry
        self.metrics = metrics
        self.token = token
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.request_timeout = float(request_timeout)
        self.connect_timeout = float(connect_timeout)
        self.log = get_logger("tfmesos_tpu_torch.fleet.router")
        self._rng = rng or random.Random()
        self._links: Dict[str, MuxConnection] = {}
        self._lock = threading.Lock()
        # Injectable time base: EVERY clock reading on the routing path
        # (deadline checks, timeout slices, breaker latency samples,
        # retry backoff) goes through these two, so the same code runs
        # on time.monotonic in production and on the fleet simulator's
        # virtual clock with no real sleeping.
        self._clock = clock
        self._sleep = sleep
        # link_factory(addr) -> MuxConnection-shaped transport: the
        # simulator substitutes virtual links; production dials TCP.
        self._link_factory = link_factory or (
            lambda addr: MuxConnection(
                addr, self.token, connect_timeout=self.connect_timeout))
        # Failure containment (module docstring): per-replica circuit
        # breakers (None = disabled — the bench's control arm) and the
        # fleet-wide retry budget.
        self.breakers: Optional[BreakerBoard] = \
            BreakerBoard(breaker_config, clock=clock) if breakers else None
        self.budget = retry_budget or RetryBudget()
        # Blue-green rollout: when set, every tier's candidate set is
        # narrowed to replicas advertising THIS weights_version whenever
        # at least one such replica is routable — the shift point of
        # FleetServer.rollout().  Replicas of other versions remain the
        # FALLBACK (the old tier keeps serving through the bake window
        # if the new tier empties), so the shift itself can never cause
        # an outage.  One attribute write = the atomic shift.
        self._preferred_version: Optional[str] = None
        # Model catalog: when a model has NO routable replica (scaled to
        # zero), this hook asks the control plane to cold-start it
        # (warm-pool adoption or a launch) and the request WAITS —
        # bounded by its deadline and ``model_wait_s`` — instead of
        # failing, so scale-to-zero is an economy measure, not an
        # availability hole.
        self.on_model_demand = None
        self.model_wait_s = 30.0

    # -- load signal -------------------------------------------------------

    def outstanding(self, addr: str) -> int:
        # Lock-free read: dict.get is atomic under the GIL and a
        # racing link swap costs at worst one stale load sample on one
        # pick — this runs twice per p2c choice, so it must be cheap.
        link = self._links.get(addr)
        return link.outstanding if link is not None and not link.closed else 0

    # -- replica choice ----------------------------------------------------

    @staticmethod
    def _summary_depth(summ, prompt, digests: Dict[tuple, list]) -> int:
        """Leading-chunk match depth of ``prompt`` against one
        prefix-cache-shaped summary ({page, first, seed, hashes});
        0 on no match or a malformed summary.  ``digests`` memoizes
        one hash pass per chunk geometry across candidates."""
        if not isinstance(summ, dict) or not summ.get("hashes"):
            return 0
        try:
            key = (int(summ.get("page") or 0),
                   int(summ.get("first") or 0),
                   str(summ.get("seed") or ""))
            if key[0] < 1:
                return 0
            if key not in digests:
                digests[key] = prefixhash.prompt_digests(
                    prompt, key[0], key[1], bytes.fromhex(key[2]))
            return prefixhash.match_depth(digests[key], summ["hashes"])
        except (ValueError, TypeError):
            return 0            # malformed summary: ignore, p2c covers

    def _affinity_pick(self, cands, prompt) -> Optional[str]:
        """The unsaturated replica whose advertised prefix digests
        match the most leading chunks of ``prompt`` — DEVICE-resident
        pages (the heartbeat prefix-cache summary) first, then
        TIER-resident ones (the KV tier's spilled-page summary: the
        pages promote back into the pool on admission, so steering the
        prompt there still skips the prefill).  Ties: device beats
        tier, then least outstanding; ``None`` when nothing matches."""
        best = None
        digests: Dict[tuple, list] = {}     # one hash pass per geometry
        for r in cands:
            dev = self._summary_depth(r.prefix, prompt, digests)
            tier = 0
            if isinstance(r.kv_tier, dict):
                tier = self._summary_depth(r.kv_tier.get("prefix"),
                                           prompt, digests)
            depth = max(dev, tier)
            if not depth:
                continue
            out = self.outstanding(r.addr)
            if r.capacity > 0 and out >= r.capacity:
                continue        # saturated favorite: fall back, don't pile
            score = (depth, 1 if dev >= tier else 0, -out)
            if best is None or score > best[0]:
                best = (score, r.addr)
        return best[1] if best is not None else None

    def _session_pick(self, cands, session: str) -> Optional[str]:
        """The unsaturated replica advertising ``session`` in its KV
        tier's parked-session list (ties: least outstanding) — a
        resumed turn lands where the conversation's KV is parked and
        prefills only the new tail.  ``None`` sends the request down
        the normal affinity/p2c path (a shared disk tier may still
        serve the resume there; a full miss re-prefills cold — always
        correct)."""
        best = None
        for r in cands:
            kt = r.kv_tier
            if not isinstance(kt, dict):
                continue
            sess = kt.get("sessions")
            if not isinstance(sess, (list, tuple)) or session not in sess:
                continue
            out = self.outstanding(r.addr)
            if r.capacity > 0 and out >= r.capacity:
                continue        # saturated: don't pile onto the parker
            if best is None or out < best[0]:
                best = (out, r.addr)
        return best[1] if best is not None else None

    def set_preferred_version(self, version: Optional[str]) -> None:
        """Shift routing to prefer replicas serving ``version`` (the
        blue-green cutover); ``None`` restores version-blind routing.
        Takes effect on the next pick — no in-flight request moves."""
        self._preferred_version = version
        self.log.info("router weights_version preference -> %r", version)

    def _alive_by_role(self, roles, exclude=(),
                       model: Optional[str] = None) -> List[ReplicaInfo]:
        """Alive candidates of the given tiers, the model tier and
        version-preference applied on top: a ``model``-carrying
        request narrows to replicas advertising exactly that
        ``model_id`` (no fallback — wrong weights are worse than
        unavailable); model-less requests exclude warm-pool members
        (undedicated replicas must never take traffic).  With a
        preferred weights_version set, replicas advertising it crowd
        out every other version whenever at least one is routable;
        otherwise (new tier empty or draining away) the full candidate
        set remains the fallback.

        The no-exclusions common case reads the registry's CACHED
        per-tier view (``alive_view`` — O(1) amortized, the change
        that makes 1000-replica routing feasible); retries (non-empty
        ``exclude``) filter it, and registries without the cache (test
        stubs) fall back to the original full scan."""
        view = getattr(self.registry, "alive_view", None)
        if view is not None:
            cands = view(tuple(roles))
            if exclude:
                exclude = set(exclude)
                cands = [r for r in cands if r.addr not in exclude]
        else:
            exclude = set(exclude)
            cands = [r for r in self.registry.alive()
                     if r.addr not in exclude
                     and (r.role or UNIFIED) in roles]
        if model:
            cands = [r for r in cands
                     if getattr(r, "model_id", "") == model]
        else:
            # Warm-pool members are invisible to model-less picks too;
            # the registry's O(1) count gates the scan so fleets
            # without a pool (every deployment of old) pay nothing.
            has_pool = getattr(self.registry, "has_pool", None)
            if has_pool is not None and has_pool():
                cands = [r for r in cands
                         if not getattr(r, "warm_pool", False)]
        pref = self._preferred_version
        if pref:
            preferred = [r for r in cands if r.weights_version == pref]
            if preferred:
                return self._breaker_filter(preferred)
            if cands:
                # Served by the non-preferred fallback: visible in the
                # counters so a stuck rollout (bake window over, old
                # version still serving) cannot hide.
                self.metrics.inc("version_fallbacks")
        return self._breaker_filter(cands)

    def _breaker_filter(self, cands: List[ReplicaInfo]
                        ) -> List[ReplicaInfo]:
        """Drop candidates whose circuit breaker is open (a half-open
        breaker with no probe in flight stays eligible — the next pick
        of it IS the probe).  When EVERY candidate is tripped the full
        set comes back: an all-open tier means the breakers have no
        healthy alternative to offer, and failing every request fast
        would turn a brown-out into a self-inflicted outage — the
        ``breaker_saturated`` counter makes that state visible."""
        if self.breakers is None or not cands \
                or self.breakers.all_closed():
            return cands
        allowed = [r for r in cands if self.breakers.eligible(r.addr)]
        if allowed:
            if len(allowed) < len(cands):
                skipped = len(cands) - len(allowed)
                self.metrics.inc("breaker_skips", skipped)
                tracing.cur_event(
                    "router", "breaker_skip", skipped=skipped,
                    addrs=",".join(sorted(
                        r.addr for r in cands if r not in allowed)))
            return allowed
        self.metrics.inc("breaker_saturated")
        tracing.cur_event("router", "breaker_saturated",
                          candidates=len(cands))
        return cands

    # -- containment hooks (breakers + budget + deadlines) -----------------

    def _breaker_dispatch(self, addr: str) -> bool:
        """True when THIS dispatch claimed the breaker's half-open
        probe — threaded back into the outcome records so only the
        sanctioned probe can close or re-open the breaker."""
        if self.breakers is not None:
            return self.breakers.on_dispatch(addr)
        return False

    def _breaker_ok(self, addr: str, t0: float,
                    probe: bool = False) -> None:
        if self.breakers is not None:
            self.breakers.record_success(
                addr, (self._clock() - t0) * 1000.0, probe=probe)

    def _breaker_fail(self, addr: str, probe: bool = False) -> None:
        if self.breakers is not None:
            self.breakers.record_failure(addr, probe=probe)

    def _charge_retry(self) -> bool:
        """Debit the fleet retry budget for one failover; False means
        the budget is exhausted — the caller fails fast instead of
        retrying (brown-out containment: the fleet must not multiply
        its own load when most requests are already failing)."""
        if self.budget.try_retry():
            tracing.cur_event("router", "budget_debit",
                              level=round(self.budget.level(), 3))
            return True
        self.metrics.inc("retry_budget_exhausted")
        tracing.cur_event("router", "budget_exhausted")
        self.log.warning("retry budget exhausted; failing fast instead "
                         "of retrying")
        return False

    def breaker_summary(self):
        """The gateway's ``breakers`` gauge (None = breakers off)."""
        return self.breakers.summary() if self.breakers is not None \
            else None

    def retry_budget_level(self) -> float:
        """The gateway's ``retry_budget`` gauge: 0..1 of budget left."""
        return round(self.budget.level(), 3)

    def describe(self) -> Dict[str, Any]:
        """Containment state: per-replica breaker detail plus the
        retry-budget level — the on-call's brown-out snapshot."""
        return {
            "breakers": (self.breakers.describe()
                         if self.breakers is not None else {}),
            "retry_budget": self.budget.level(),
        }

    @staticmethod
    def _trace_attempt(name: str, att0: Optional[float], addr: str,
                       outcome: str, reply=None, **attrs) -> None:
        """Close one attempt span on the current trace: duration from
        ``att0`` (captured before the wire call), the replica picked,
        and the outcome taxonomy.  When the reply piggybacked the
        replica's hop spans they are POPPED off it (the client must not
        receive span payloads) and stitched in re-anchored at the
        attempt's start — hop-local durations on our timeline."""
        tr = tracing.current()
        if tr is None or att0 is None:
            return
        spans = None
        if isinstance(reply, dict):
            spans = reply.pop("trace", None)
        elif isinstance(reply, wire.RawFrame) \
                and isinstance(reply.meta, dict):
            spans = reply.meta.pop("trace", None)
        if spans:
            tr.absorb(spans, att0, addr=addr)
        tr.add("router", name, att0, tr.elapsed_ms() - att0,
               addr=addr, outcome=outcome, **attrs)

    @staticmethod
    def _deadline_of(msg) -> Optional[float]:
        """The gateway-stamped ABSOLUTE deadline riding the forward
        dict (``time.monotonic`` base — same process as the gateway;
        it never crosses the wire, see :meth:`_wire_msg`)."""
        if not isinstance(msg, dict):
            return None
        dl = msg.get("deadline")
        return float(dl) if isinstance(dl, (int, float)) \
            and not isinstance(dl, bool) else None

    def _expired_reply(self, what: str) -> Dict[str, Any]:
        self.metrics.inc("deadline_expired_route")
        tracing.cur_event("router", "deadline_expired", what=what)
        return {"op": "error", "kind": "deadline_exceeded",
                "error": f"request deadline expired {what}"}

    def _wire_msg(self, msg: Dict[str, Any],
                  deadline: Optional[float]) -> Dict[str, Any]:
        """The dict that actually goes on the wire: the internal
        absolute ``deadline`` stripped (a monotonic reading means
        nothing on another host's clock) and the REMAINING budget
        re-stamped as ``deadline_ms`` — recomputed per attempt, so a
        retry hands the replica only what is actually left.  The
        internal ``_trace`` CONTEXT is stripped the same way (it is a
        live object, not wire data); what crosses instead is the
        ``trace_id`` plus the detail/slow-threshold knobs, so the
        replica's hop spans come back attributable — hop-LOCAL offsets
        only, absolute clocks never cross the wire."""
        tr = tracing.current()
        if deadline is None and tr is None \
                and "deadline" not in msg and "_trace" not in msg \
                and "_emit" not in msg and "_model" not in msg \
                and "_background" not in msg:
            return msg
        out = {k: v for k, v in msg.items()
               if k not in ("deadline", "_trace", "_emit", "_model",
                            "_background")}
        if "_model" in msg:
            # The resolved model id DOES cross the wire (as ``model``):
            # the replica cross-checks it against the model it serves,
            # so a pick racing a warm-pool adoption can never silently
            # answer with another model's weights.
            out["model"] = msg["_model"]
        if deadline is not None:
            out["deadline_ms"] = round(
                max(1.0, (deadline - self._clock()) * 1000.0), 3)
        if tr is not None:
            out["trace_id"] = tr.trace_id
            if tr.detailed:
                out["trace_detail"] = True
            if tr.slow_ms is not None:
                out["trace_slow_ms"] = tr.slow_ms
        return out

    def _call_timeout(self, deadline: Optional[float],
                      final_attempt: bool = True,
                      share: float = 1.0) -> float:
        """The per-call wire timeout a phase may spend: the flat
        ``request_timeout`` without a deadline; with one, a slice of
        the remaining budget — non-final attempts keep half back for a
        retry, and the disagg prefill phase passes ``share`` to keep
        most of the budget for its decode phase."""
        if deadline is None:
            return self.request_timeout
        rem = (deadline - self._clock()) * share
        if not final_attempt:
            rem *= 0.5
        return min(self.request_timeout, max(0.05, rem))

    def _load_pick(self, cands) -> Optional[str]:
        """Least-outstanding with p2c sampling over ``cands`` — O(1)
        regardless of tier size (two index draws, never a full-list
        materialization: at 1000 replicas an O(n) pick would dominate
        every request)."""
        n = len(cands)
        if not n:
            return None
        if n <= 2:
            return min((r.addr for r in cands), key=self.outstanding)
        # Two distinct uniform indices without rng.sample's setup cost.
        rr = self._rng.randrange
        i = rr(n)
        j = rr(n - 1)
        if j >= i:
            j += 1
        a, b = cands[i].addr, cands[j].addr
        return a if self.outstanding(a) <= self.outstanding(b) else b

    def _pick_role(self, roles, exclude, prompt,
                   session: Optional[str] = None,
                   model: Optional[str] = None,
                   background: bool = False) -> Optional[str]:
        """One choice policy for both prompt-bearing tiers:
        session-affinity first (the replica holding the conversation's
        parked KV), then prefix-affinity when ``prompt`` is given and
        some candidate advertises a matching cache summary, else
        least-outstanding p2c; ``None`` when no eligible replica
        exists.  ``model`` nests the model tier ABOVE everything:
        affinity, p2c, and version preference all operate inside it.
        ``background`` (batch-lane work) narrows to replicas with FREE
        slots when any exist: p2c alone can draw two saturated
        replicas while an idle one sits empty, queueing deadline-less
        work exactly where interactive load is hot."""
        cands = self._alive_by_role(roles, exclude, model=model)
        if not cands:
            return None
        if background:
            idle = [r for r in cands
                    if not (r.capacity > 0
                            and self.outstanding(r.addr) >= r.capacity)]
            cands = idle or cands
        if session:
            fav = self._session_pick(cands, session)
            self.metrics.inc("session_affinity_hits" if fav is not None
                             else "session_affinity_misses")
            if fav is not None:
                return fav
        if prompt is not None and len(prompt):
            # The O(candidates) affinity scan runs only when some
            # replica actually advertises a prefix-cache summary
            # (registry-counted, O(1)); otherwise the request counts a
            # miss straight away — a no-prefix-cache fleet must not pay
            # the scan per prompt-bearing request at 1000 replicas.
            have = getattr(self.registry, "has_prefix_summaries", None)
            if have is None or have():
                fav = self._affinity_pick(cands, prompt)
                self.metrics.inc("affinity_hits" if fav is not None
                                 else "affinity_misses")
                if fav is not None:
                    return fav
            else:
                self.metrics.inc("affinity_misses")
        return self._load_pick(cands)

    def pick(self, exclude: Iterable[str] = (),
             prompt=None, session: Optional[str] = None,
             model: Optional[str] = None,
             background: bool = False) -> Optional[str]:
        """The UNIFIED-path choice over alive unified replicas not in
        ``exclude``.  Prefill-role replicas never appear here (they
        refuse generate); decode-role replicas are reserved for
        imported prefills, so the role split cannot silently turn a
        decode tier back into a unified one.  ``session`` steers a
        multi-turn conversation at the replica advertising its parked
        KV (session affinity); ``model`` narrows to that model's
        replicas (the model tier)."""
        return self._pick_role((UNIFIED,), exclude, prompt, session,
                               model, background=background)

    def pick_prefill(self, exclude: Iterable[str] = (),
                     prompt=None,
                     model: Optional[str] = None) -> Optional[str]:
        """The prefill-tier choice: prefix-affinity first (a prompt
        whose leading chunks are resident on some prefill replica
        prefills only its tail there), then least-outstanding p2c —
        the load signal is what spreads long prompts."""
        return self._pick_role((PREFILL,), exclude, prompt,
                               model=model)

    def pick_decode(self, exclude: Iterable[str] = (),
                    weights_version: Optional[str] = None,
                    model: Optional[str] = None
                    ) -> Optional[str]:
        """The decode-tier choice: p2c by advertised KV-page headroom
        (the imported pages must FIT — load alone would happily pick a
        replica whose pool is full of long-lived rows), saturated
        replicas (outstanding >= capacity) skipped, ties broken by the
        router's own outstanding count.  ``weights_version`` narrows
        the tier to replicas serving those exact weights — a suspended
        mid-stream artifact must never resume under different weights
        (same rule as :meth:`_pick_resume`)."""
        cands = self._alive_by_role((DECODE,), exclude, model=model)
        if weights_version:
            cands = [r for r in cands
                     if r.weights_version == weights_version]
        if not cands:
            return None
        unsat = [r for r in cands
                 if not (r.capacity > 0
                         and self.outstanding(r.addr) >= r.capacity)]
        cands = unsat or cands

        def score(r: ReplicaInfo):
            return (r.kv_headroom, -self.outstanding(r.addr))

        if len(cands) > 2:
            cands = self._rng.sample(cands, 2)
        return max(cands, key=score).addr

    # -- link management ---------------------------------------------------

    def control(self, addr: str, msg: Dict[str, Any],
                timeout: float = 30.0) -> Any:
        """One control call straight to a known replica over the shared
        mux link (the fleet's ``migrate`` request rides this) — no
        pick, no retry: control targets a SPECIFIC replica by
        design."""
        return self._link(addr).call(msg, timeout=timeout)

    def control_raw(self, addr: str, meta: Dict[str, Any], body,
                    timeout: float = 30.0) -> Any:
        """One RAW-frame control call straight to a known replica (the
        adapter hot-swap's delta ships this way — HMAC-tagged bytes on
        the existing mux link, never re-encoded)."""
        return self._link(addr).call_raw(meta, body, timeout=timeout)

    def _link(self, addr: str) -> MuxConnection:
        with self._lock:
            link = self._links.get(addr)
            if link is not None and not link.closed:
                return link
        # Dial OUTSIDE the lock: a black-holed endpoint blocks the dial
        # for up to connect_timeout, and holding the router-wide lock
        # through that would stall every worker's pick()/route() on the
        # healthy replicas too.  A dial race just keeps the first link
        # registered and closes the loser.
        link = self._link_factory(addr)
        with self._lock:
            existing = self._links.get(addr)
            if existing is not None and not existing.closed:
                pass    # lost the race
            else:
                self._links[addr] = link
                return link
        link.close()
        return existing

    def _drop_link(self, addr: str) -> None:
        with self._lock:
            link = self._links.pop(addr, None)
        if link is not None:
            link.close()

    # -- failure classification (ONE copy of the retry policy) -------------
    #
    # Every phase loop (unified route, disagg prefill, disagg decode)
    # shares the same taxonomy:
    #   * CallTimeout — the CONNECTION is still up (per CallTimeout's
    #     contract), only this request is slow.  Retry it elsewhere, but
    #     do NOT collapse the shared link (that would abort every other
    #     in-flight request on this replica) and do NOT mark the replica
    #     dead.  The eventual late reply finds its slot gone and is
    #     dropped; deterministic generation makes the duplicate work
    #     harmless.
    #   * ConnectionLost / OSError — the transport failed: drop the
    #     link, mark the replica dead, back off, retry elsewhere.
    #   * wire.WireError from call()/call_raw() is NEITHER: it is an
    #     encode-time rejection of the PAYLOAD (oversized raw meta or
    #     frame), raised before any bytes hit the socket — receive-side
    #     wire corruption surfaces as ConnectionLost instead.  Each
    #     phase handles it as deterministic for that payload: never
    #     drop the (healthy, shared) link, never mark the replica dead,
    #     never re-ship the identical doomed bytes to another replica.

    def _note_timeout(self, addr: str, tried: set, attempt: int,
                      what: str, clipped: bool = False,
                      probe: bool = False) -> bool:
        """Returns whether the caller may retry (the fleet retry budget
        gates every failover — see module docstring).  ``clipped=True``
        for timeouts on a DEADLINE-CLIPPED slice: a call cut short by
        the request's own budget says nothing about the replica's
        health (charging the breaker would let short-deadline traffic
        trip healthy replicas), and the retries it permits are bounded
        by the DEADLINE — the loop-head expiry check ends them — not by
        the fleet budget, which must keep its runway for real
        failures."""
        tried.add(addr)
        if not clipped:
            self._breaker_fail(addr, probe)
            if not self._charge_retry():
                return False
        self.metrics.inc("retries")
        tracing.cur_event("router", "retry", cause="timeout", addr=addr,
                          what=what, clipped=clipped)
        self.log.warning("%s timed out on %s; retrying on "
                         "another replica (attempt %d/%d)", what, addr,
                         attempt + 1, self.max_retries + 1)
        return True

    def _note_link_failure(self, e: BaseException, addr: str, tried: set,
                           attempt: int, what: str,
                           probe: bool = False) -> bool:
        """Like :meth:`_note_timeout` for transport failures: the link
        drops and the replica is marked dead REGARDLESS of the budget's
        answer (the death is a fact either way); only the retry itself
        is budget-gated."""
        tried.add(addr)
        self._drop_link(addr)
        self._breaker_fail(addr, probe)
        self.registry.mark_dead(addr, why=f"{type(e).__name__}: {e}")
        if not self._charge_retry():
            return False
        self.metrics.inc("retries")
        tracing.cur_event("router", "retry", cause="link_failure",
                          addr=addr, what=what,
                          error=f"{type(e).__name__}")
        self.log.warning("%s replica %s failed (%s); retrying on "
                         "another replica (attempt %d/%d)", what, addr, e,
                         attempt + 1, self.max_retries + 1)
        self._sleep(self.backoff_s * (2 ** attempt))
        return True

    def _note_replica_error(self, addr: str, tried: set,
                            err: "RoutingError",
                            probe: bool = False) -> bool:
        """One transient replica-side error reply (internal failure,
        pool exhaustion): breaker + budget bookkeeping shared by every
        phase loop.  Returns whether the caller may retry."""
        tried.add(addr)
        self._breaker_fail(addr, probe)
        if not self._charge_retry():
            return False
        self.metrics.inc("retries")
        tracing.cur_event("router", "retry", cause="replica_error",
                          addr=addr, error=str(err)[:200])
        return True

    # -- drain migration: suspended replies re-place elsewhere -------------

    @staticmethod
    def _suspended_of(reply) -> Optional[tuple]:
        """``(meta, body_or_None)`` when ``reply`` is a drained
        replica's ``suspended`` answer (raw frame = resumable artifact,
        dict = requeue marker); ``None`` for every normal reply."""
        if isinstance(reply, wire.RawFrame) \
                and isinstance(reply.meta, dict) \
                and reply.meta.get("op") == "suspended":
            return reply.meta, reply.body
        if isinstance(reply, dict) and reply.get("op") == "suspended":
            return reply, None
        return None

    def _pick_resume(self, tried, weights_version,
                     model: Optional[str] = None,
                     adapter: Optional[str] = None) -> Optional[str]:
        """A unified-tier replica a suspended artifact may RESUME on:
        same advertised weights_version — and, when the export stamped
        them, same model_id and adapter_version — because KV pages
        computed under one set of weights must never feed a decode
        under another (resume onto a mismatch would be a silently
        wrong stream), not already tried.  ``None`` = no eligible
        target; the caller re-runs the request instead."""
        cands = self._alive_by_role((UNIFIED,), exclude=tried,
                                    model=model)
        if weights_version:
            cands = [r for r in cands
                     if r.weights_version == weights_version]
        if adapter is not None:
            cands = [r for r in cands
                     if getattr(r, "adapter_version", "") == adapter]
        return self._load_pick(cands)

    def _resume_elsewhere(self, msg: Dict[str, Any], meta: dict,
                          body, tried: set) -> Optional[Any]:
        """Re-place one suspended export: retry the artifact onto
        eligible replicas within the shared budget; ``None`` means the
        caller should fall back to re-running the plain request (the
        equally-lossless path — nothing was delivered).  A resume
        target that is itself being drained can answer suspended again;
        the freshest artifact keeps moving until the budget runs out."""
        if body is None:
            # Either a plain requeue marker (just re-run) or a DIRECT-
            # PUSHED export: the victim already streamed its artifact
            # peer-to-peer to the brokered survivor, and only the small
            # reference rides the control plane.
            return self._resume_pushed(msg, meta, tried)
        gen = meta.get("gen")
        if not self.registry.gen_allowed(gen):
            # The victim belongs to a reaped (fenced) generation: its
            # KV pages are stale-weights state and must never land.
            self.metrics.inc("migration_fenced")
            self.log.warning("dropping suspended export from a fenced "
                             "generation (%r); re-running the request",
                             gen)
            return None
        wv = meta.get("weights_version")
        wv = wv if isinstance(wv, str) and wv else ""
        art_model = meta.get("model_id")
        art_model = art_model if isinstance(art_model, str) \
            and art_model else None
        art_adapter = meta.get("adapter_version")
        art_adapter = art_adapter if isinstance(art_adapter, str) \
            else None
        deadline = self._deadline_of(msg)

        emit = msg.get("_emit")

        def build_call(m):
            out = {k: v for k, v in m.items()
                   if k not in ("op", "id", "gen", "weights_version",
                                "trace")}
            out.update(op="generate", prompt=msg.get("prompt"),
                       max_new_tokens=msg.get("max_new_tokens"),
                       stop_token=msg.get("stop_token"),
                       priority=msg.get("priority"))
            if msg.get("stream"):
                # The resume target re-streams from offset 0 (its
                # imported row carries the already-emitted prefix);
                # the gateway's offset de-dup keeps the client stream
                # exactly-once.
                out["stream"] = True
            return out

        call = build_call(meta)
        for attempt in range(self.max_retries + 1):
            if deadline is not None and self._clock() >= deadline:
                return self._expired_reply("while resuming its "
                                           "migrated state")
            addr = self._pick_resume(tried, wv, model=art_model,
                                     adapter=art_adapter)
            if addr is None:
                break
            rprobe = self._breaker_dispatch(addr)
            att0 = tracing.cur_elapsed()
            t0 = self._clock()
            timeout = self._call_timeout(deadline,
                                         attempt >= self.max_retries)
            try:
                if emit is not None:
                    rlink = self._link(addr)
                    reply = rlink.call_raw(
                        self._wire_msg(call, deadline), body,
                        timeout=timeout,
                        on_partial=self._cancel_on_disconnect(emit,
                                                              rlink))
                else:
                    reply = self._link(addr).call_raw(
                        self._wire_msg(call, deadline), body,
                        timeout=timeout)
            except CallTimeout:
                self._trace_attempt("resume", att0, addr, "timeout",
                                    clipped=timeout < self.request_timeout)
                if not self._note_timeout(
                        addr, tried, attempt, "resume",
                        clipped=timeout < self.request_timeout,
                        probe=rprobe):
                    return None
                continue
            except wire.WireError:
                # The artifact cannot even be encoded for the wire:
                # deterministic for the PAYLOAD — re-run instead.
                return None
            except (ConnectionLost, OSError) as e:
                self._trace_attempt("resume", att0, addr,
                                    "link_failure")
                if not self._note_link_failure(e, addr, tried, attempt,
                                               "resume", probe=rprobe):
                    return None
                continue
            s = self._suspended_of(reply)
            if s is not None:
                # The resume target is being drained too: carry the
                # FRESHEST artifact onward (it holds more tokens).
                # Healthy outcome for the breaker (see route()).
                self._trace_attempt("resume", att0, addr, "suspended",
                                    reply=reply)
                self._breaker_ok(addr, t0, rprobe)
                tried.add(addr)
                self.metrics.inc("migration_exports")
                meta2, body2 = s
                if body2 is None or not self.registry.gen_allowed(
                        meta2.get("gen")):
                    return None
                call = build_call(meta2)
                body = body2
                continue
            if isinstance(reply, dict) and reply.get("op") == "error":
                self._trace_attempt("resume", att0, addr, "error_reply",
                                    reply=reply,
                                    kind=str(reply.get("kind")))
                if reply.get("kind") == "deadline_exceeded":
                    # The replica's own in-batcher cancel fired: final
                    # for the request, not a resume failure.
                    return reply
                if reply.get("kind") == "bad_request":
                    # Deterministic for THIS artifact (geometry/config
                    # mismatch): re-running the request still works.
                    self.metrics.inc("migration_rejected")
                    tracing.cur_event("router", "migration_rejected",
                                      addr=addr)
                    return None
                if not self._note_replica_error(
                        addr, tried, RoutingError(
                            f"resume failed on {addr}: "
                            f"{reply.get('error')}"),
                        probe=rprobe):
                    return None
                continue
            self._trace_attempt("resume", att0, addr, "ok", reply=reply)
            self._breaker_ok(addr, t0, rprobe)
            self.metrics.inc("migration_resumes")
            tracing.cur_event("router", "migration_resume", addr=addr)
            return reply
        return None

    def _resume_pushed(self, msg: Dict[str, Any], meta: dict,
                       tried: set) -> Optional[Any]:
        """Resume a DIRECT-PUSHED migration export: the victim already
        landed its artifact on the brokered survivor as a ``kv_stage``
        frame, so the resume is one small ``generate`` call carrying
        only the ``kv_ref``.  Single bounded attempt — the stage lives
        on exactly one host; any failure returns ``None`` and the
        caller re-runs the request from scratch (equally lossless, the
        stage just expires)."""
        addr = meta.get("push_to")
        xfer = meta.get("xfer")
        if not meta.get("pushed") or not isinstance(addr, str) \
                or not addr or not isinstance(xfer, str) or not xfer:
            return None                     # requeue marker: just re-run
        if not self.registry.gen_allowed(meta.get("gen")):
            self.metrics.inc("migration_fenced")
            self.log.warning("dropping pushed export from a fenced "
                             "generation (%r); re-running the request",
                             meta.get("gen"))
            return None
        deadline = self._deadline_of(msg)
        if deadline is not None and self._clock() >= deadline:
            return self._expired_reply("while resuming its migrated "
                                       "state")
        emit = msg.get("_emit")
        call = {"op": "generate", "kv_ref": xfer,
                "prompt": msg.get("prompt"),
                "max_new_tokens": msg.get("max_new_tokens"),
                "stop_token": msg.get("stop_token"),
                "priority": msg.get("priority")}
        if msg.get("stream"):
            call["stream"] = True
        rprobe = self._breaker_dispatch(addr)
        t0 = self._clock()
        timeout = self._call_timeout(deadline, True)
        try:
            if emit is not None:
                plink = self._link(addr)
                reply = plink.call(
                    self._wire_msg(call, deadline), timeout=timeout,
                    on_partial=self._cancel_on_disconnect(emit, plink))
            else:
                reply = self._link(addr).call(
                    self._wire_msg(call, deadline), timeout=timeout)
        except CallTimeout:
            self.metrics.inc("migration_push_failed")
            return None
        except wire.WireError:
            return None
        except (ConnectionLost, OSError):
            self._drop_link(addr)
            self.metrics.inc("migration_push_failed")
            return None
        s = self._suspended_of(reply)
        if s is not None:
            # The survivor is itself being drained: carry the freshest
            # artifact onward through the standard resume machinery.
            self._breaker_ok(addr, t0, rprobe)
            tried.add(addr)
            self.metrics.inc("migration_exports")
            meta2, body2 = s
            if body2 is not None:
                if not self.registry.gen_allowed(meta2.get("gen")):
                    return None
                return self._resume_elsewhere(msg, meta2, body2, tried)
            return self._resume_pushed(msg, meta2, tried)
        if isinstance(reply, dict) and reply.get("op") == "error":
            if reply.get("kind") == "deadline_exceeded":
                return reply
            # unknown kv_ref (stage expired), wrong model, anything
            # else: deterministic for the PUSH, not the request.
            self.metrics.inc("migration_rejected")
            return None
        self._breaker_ok(addr, t0, rprobe)
        self.metrics.inc("migration_resumes")
        self.metrics.inc("migration_direct")
        tracing.cur_event("router", "migration_resume", addr=addr,
                          direct=True)
        return reply

    def migration_target(self, victim_addr: str) -> Optional[str]:
        """The survivor a drain-migration victim should DIRECT-PUSH its
        suspended artifacts to: same model / weights_version / adapter
        as the victim (the fencing rules a relay resume enforces apply
        identically), picked by load.  ``None`` when no eligible
        survivor exists — the migrate op then runs without a push
        target and every artifact relays through the router exactly as
        before."""
        rep = None
        for r in self.registry.members():
            if r.addr == victim_addr:
                rep = r
                break
        if rep is None:
            return None
        return self._pick_resume(
            {victim_addr}, rep.weights_version or "",
            model=rep.model_id or None,
            adapter=getattr(rep, "adapter_version", "") or None)

    # -- client-disconnect cancel propagation ------------------------------

    def _cancel_on_disconnect(self, emit, link):
        """Wrap a streaming partial emitter so a client that vanished
        mid-stream releases its replica row instead of decoding to the
        bitter end.  The gateway's relay exposes an ``emit.cancelled``
        probe (true once the client connection is closed); on the first
        partial frame that finds it true, send ONE fire-and-forget
        ``cancel`` op back down the same link (the frame's ``id`` is
        the replica-side call id) and swallow all further frames.
        Best-effort by design: an emitter without the probe, or a link
        without :meth:`notify` (sim/test stubs), passes through
        unchanged, and a lost cancel merely costs the tokens the
        request would have decoded anyway."""
        if emit is None:
            return emit
        cancelled = getattr(emit, "cancelled", None)
        notify = getattr(link, "notify", None)
        if cancelled is None or notify is None:
            return emit
        state = {"sent": False}

        def wrapped(frame):
            if cancelled():
                if not state["sent"]:
                    state["sent"] = True
                    head = frame.meta \
                        if isinstance(getattr(frame, "meta", None), dict) \
                        else frame
                    target = head.get("id") \
                        if isinstance(head, dict) else None
                    if target is not None:
                        try:
                            notify({"op": "cancel", "target": target})
                        except Exception:
                            pass    # advisory: never disturb the stream
                self.metrics.inc("stream_cancelled_frames")
                return              # the client is gone; drop the frame
            emit(frame)

        return wrapped

    # -- the routing loop --------------------------------------------------

    def route(self, msg: Dict[str, Any]) -> Any:
        """Send ``msg`` to a replica; on connection failure, retry on a
        different one (up to ``max_retries`` failovers, exponential
        backoff).  When both a prefill and a decode tier are alive, a
        generate request takes the DISAGGREGATED prefill→transfer→
        decode path first and falls back to the unified tier only when
        that path cannot serve it.  A ``suspended`` reply (the replica
        is being drain-migrated away) re-places the request — resuming
        its exported KV artifact on a same-version survivor, or
        re-running it from scratch — before the retry budget is ever
        charged a failure.

        A ``_trace`` context riding ``msg`` (the gateway attaches one
        per request) is ACTIVATED thread-locally for the whole routing
        loop: every attempt records a span with its outcome taxonomy,
        deep helpers (breaker filter, budget charges, chaos firings)
        attribute themselves to it, and replica-piggybacked hop spans
        are stitched back in at each attempt's start offset."""
        tr = msg.get("_trace") if isinstance(msg, dict) else None
        if tr is None and tracing.current() is None:
            # Nothing to activate and nothing to restore: skip the
            # context manager on the untraced hot path.
            return self._route(msg)
        with tracing.activate(tr):
            return self._route(msg)

    def _route(self, msg: Dict[str, Any]) -> Any:
        last: Optional[BaseException] = None
        deadline = self._deadline_of(msg)
        if isinstance(msg, dict) and msg.get("op") == "generate":
            out, last = self._route_disagg(msg)
            if out is not None:
                return out
        tried = set()
        deadline_cut = False
        prompt = msg.get("prompt") if isinstance(msg, dict) else None
        session = msg.get("session") if isinstance(msg, dict) else None
        session = session if isinstance(session, str) and session else None
        model = msg.get("_model") if isinstance(msg, dict) else None
        model = model if isinstance(model, str) and model else None
        background = bool(msg.get("_background")) \
            if isinstance(msg, dict) else False
        demanded = False
        # Streaming: the gateway's partial-frame emitter rides the
        # forward as the internal `_emit` (stripped by _wire_msg); each
        # attempt's partial token frames pass straight through to it,
        # and the gateway's offset de-dup makes retries exactly-once.
        # Passed only when streaming, at every call site: substituted
        # links (the simulator's, test stubs) do not take on_partial,
        # and unstreamed routing must not require them to.
        emit = msg.get("_emit") if isinstance(msg, dict) else None
        for attempt in range(self.max_retries + 1):
            if deadline is not None and self._clock() >= deadline:
                # Fail fast, at the loop head: the client has given up,
                # and every further attempt (including the first) would
                # be pure waste — this is what keeps retries from
                # burning TPU time on expired work.
                return self._expired_reply("before a replica could "
                                           "serve it")
            addr = self.pick(exclude=tried, prompt=prompt,
                             session=session, model=model,
                             background=background)
            if addr is None and model is not None and not demanded \
                    and not tried and self.on_model_demand is not None:
                # Scale-to-zero cold start: no replica serves this
                # model RIGHT NOW.  Ask the control plane to assign
                # one (warm-pool adoption, or a launch) and WAIT for
                # it to become routable — bounded by the request's own
                # deadline and model_wait_s, so a model the trader
                # cannot place still fails explicitly, never hangs.
                demanded = True
                addr = self._await_model(model, deadline, prompt,
                                         session)
            if addr is None:
                break       # nothing (left) to try
            probe = self._breaker_dispatch(addr)
            att0 = tracing.cur_elapsed()
            t0 = self._clock()
            timeout = self._call_timeout(deadline,
                                         attempt >= self.max_retries)
            try:
                link = self._link(addr)
                if emit is not None:
                    reply = link.call(
                        self._wire_msg(msg, deadline), timeout=timeout,
                        on_partial=self._cancel_on_disconnect(emit,
                                                              link))
                else:
                    reply = link.call(self._wire_msg(msg, deadline),
                                      timeout=timeout)
            except CallTimeout as e:
                last = e
                self._trace_attempt("attempt", att0, addr, "timeout",
                                    clipped=timeout < self.request_timeout)
                if timeout < self.request_timeout:
                    # The call was cut short by the DEADLINE slice, not
                    # the flat timeout: if the loop ends here, the
                    # deadline — not replica availability — is the root
                    # cause, and the client error must say so.
                    deadline_cut = True
                if not self._note_timeout(
                        addr, tried, attempt, "request",
                        clipped=timeout < self.request_timeout,
                        probe=probe):
                    break
                continue
            except wire.WireError as e:
                # Deterministic for this request (it could not even be
                # encoded): no replica can serve it.
                raise RoutingError(
                    f"request not encodable for {addr}: {e}") from e
            except (ConnectionLost, OSError) as e:
                last = e
                self._trace_attempt("attempt", att0, addr,
                                    "link_failure")
                if not self._note_link_failure(e, addr, tried, attempt,
                                               "generate", probe=probe):
                    break
                continue
            s = self._suspended_of(reply)
            if s is None:
                if isinstance(reply, dict) \
                        and reply.get("op") == "error":
                    self._trace_attempt(
                        "attempt", att0, addr, "error_reply",
                        reply=reply, kind=str(reply.get("kind")))
                    if reply.get("kind") in ("bad_request",
                                             "deadline_exceeded"):
                        # Deterministic rejection: FINAL for the
                        # request, but not a success — it must neither
                        # refill the retry budget (which refills on
                        # delivered completions only, or a brown-out
                        # failing fast would keep re-arming its own
                        # retries) nor feed the breaker's success EWMA
                        # (a fast rejection would dilute a gray-slow
                        # replica's average and delay its isolation).
                        return reply
                    # Transient replica-side failure: breaker food, and
                    # another replica may still serve it.
                    err = RoutingError(
                        f"request failed on {addr}: "
                        f"{reply.get('error')}")
                    last = err
                    if not self._note_replica_error(addr, tried, err,
                                                    probe=probe):
                        break
                    continue
                self._trace_attempt("attempt", att0, addr, "ok",
                                    reply=reply)
                self._breaker_ok(addr, t0, probe)
                self.budget.on_success()
                return reply
            # Drain migration: the replica gave the request back.  The
            # victim is excluded (it is leaving), the artifact resumes
            # elsewhere — or the loop continues and re-runs the plain
            # request on a survivor, losing nothing either way.  The
            # prompt reply is a HEALTHY outcome for the breaker (a
            # drain is control-plane intent, not a failure — and a
            # half-open probe answered with `suspended` must not wedge).
            self._trace_attempt("attempt", att0, addr, "suspended",
                                reply=reply)
            self._breaker_ok(addr, t0, probe)
            tried.add(addr)
            self.metrics.inc("migration_exports")
            out = self._resume_elsewhere(msg, s[0], s[1], tried)
            if out is not None:
                return out
            self.metrics.inc("migration_reruns")
            tracing.cur_event("router", "migration_rerun", addr=addr)
            last = RoutingError(
                f"replica {addr} suspended the request mid-stream")
        if deadline_cut and isinstance(last, CallTimeout):
            return self._expired_reply(
                "in flight (every budget slice timed out)")
        if last is not None:
            raise RoutingError(
                f"no replica could serve the request after trying "
                f"{sorted(tried)}: {last}") from last
        raise RoutingError(
            f"no alive replicas serving model {model!r}" if model
            else "no alive replicas")

    def _await_model(self, model: str, deadline: Optional[float],
                     prompt, session) -> Optional[str]:
        """Fire the cold-start demand hook once and poll for a
        routable replica of ``model``.  Returns the first pick, or
        ``None`` when the wait budget (the request deadline, capped at
        ``model_wait_s``) runs out."""
        t0 = self._clock()
        self.metrics.inc("model_cold_waits")
        tracing.cur_event("router", "model_cold_start", model=model)
        try:
            if not self.on_model_demand(model):
                return None     # unknown model / nothing to free
        except Exception:
            self.log.exception("model demand hook failed for %r", model)
            return None
        limit = t0 + self.model_wait_s
        if deadline is not None:
            limit = min(limit, deadline)
        while self._clock() < limit:
            addr = self.pick(prompt=prompt, session=session, model=model)
            if addr is not None:
                self.metrics.observe("model_cold_wait_ms",
                                     (self._clock() - t0) * 1000.0)
                return addr
            self._sleep(0.05)
        return None

    # -- the disaggregated prefill -> transfer -> decode path --------------

    def _route_disagg(self, msg: Dict[str, Any]) -> tuple:
        """Try the two-phase path; returns ``(reply, last_error)`` —
        ``reply`` is ``None`` when the caller should fall back to the
        unified tier (a tier is empty, or the bounded retries ran out;
        every such path counts ``disagg_fallback``).  Only an answer
        DETERMINISTIC for the REQUEST (a completion, or a prefill-phase
        bad_request — the request itself is invalid) short-circuits the
        fallback: transient failures (internal errors, timeouts, dead
        connections) retry onto a different replica and then fall back,
        and a decode-phase bad_request (the tiers disagree about the
        artifact, not the request) falls back too — a healthy unified
        tier must still get its chance."""
        prompt = msg.get("prompt")
        model = msg.get("_model")
        model = model if isinstance(model, str) and model else None
        if isinstance(msg.get("session"), str) and msg["session"] \
                and self._alive_by_role((UNIFIED,), model=model):
            # Sessions ride the unified tier: their parked KV lives in
            # a unified replica's tier, and the disaggregated handoff
            # has no park/resume surface — only a PURE disagg fleet
            # serves a session-labeled request through it (cold).
            return None, None
        if (prompt is None or not len(prompt)) \
                and self._alive_by_role((UNIFIED,), model=model):
            # An invalid prompt gets its bad_request from a unified
            # replica's own validation when one exists; in a PURE
            # disagg fleet the request stays on this path so the
            # prefill replica rejects it loudly — never an
            # "unavailable: no alive replicas" for a malformed request.
            return None, None
        # Both tiers must be alive BEFORE phase 1 runs: with no decode
        # replica the prefill compute (and its KV export) would be pure
        # waste on the way to the unified fallback.  An all-unified
        # fleet (neither tier exists) is not a "fallback" — it is the
        # normal path; a LONE tier is one, and counts.
        has_prefill = bool(self._alive_by_role((PREFILL,), model=model))
        has_decode = bool(self._alive_by_role((DECODE,), model=model))
        if not (has_prefill and has_decode):
            if has_prefill or has_decode:
                self.metrics.inc("disagg_fallback")
            return None, None
        last: Optional[BaseException] = None
        deadline = self._deadline_of(msg)
        ptried: set = set()
        t0 = self._clock()
        for attempt in range(self.max_retries + 1):
            if deadline is not None and self._clock() >= deadline:
                return self._expired_reply("before prefill could "
                                           "run"), None
            paddr = self.pick_prefill(exclude=ptried, prompt=prompt,
                                      model=model)
            if paddr is None:
                break               # prefill tier exhausted
            call = {"op": "prefill", "prompt": msg.get("prompt"),
                    "max_new_tokens": msg.get("max_new_tokens"),
                    "stop_token": msg.get("stop_token"),
                    "priority": msg.get("priority")}
            # Direct peer streaming (docs/SERVING.md "Cross-host KV
            # fabric"): broker the decode address UP FRONT so the
            # prefill replica can push its KV straight there — bytes
            # never transit the router.  A saturated/empty pick just
            # omits the broker fields and the reply relays as before.
            xfer = daddr0 = None
            daddr0 = self.pick_decode(model=model)
            if daddr0 is not None:
                xfer = _new_xfer_id()
                call["push_to"] = daddr0
                call["xfer"] = xfer
            pprobe = self._breaker_dispatch(paddr)
            patt0 = tracing.cur_elapsed()
            tp = self._clock()
            # The prefill phase spends at most a quarter of the
            # remaining budget: decode is the long phase, and a hung
            # prefill replica must leave it a real slice.
            timeout = self._call_timeout(
                deadline, attempt >= self.max_retries, share=0.25)
            try:
                praw = self._link(paddr).call(
                    self._wire_msg(call, deadline), timeout=timeout)
            except CallTimeout as e:
                last = e
                self._trace_attempt("prefill", patt0, paddr, "timeout",
                                    clipped=timeout < self.request_timeout)
                if not self._note_timeout(
                        paddr, ptried, attempt, "prefill",
                        clipped=timeout < self.request_timeout,
                        probe=pprobe):
                    break
                continue
            except wire.WireError as e:
                # The prefill call is the same small JSON dict the
                # unified path would send — if it cannot encode, no
                # tier can serve it.
                raise RoutingError(
                    f"request not encodable for {paddr}: {e}") from e
            except (ConnectionLost, OSError) as e:
                last = e
                self._trace_attempt("prefill", patt0, paddr,
                                    "link_failure")
                if not self._note_link_failure(e, paddr, ptried,
                                               attempt, "prefill",
                                               probe=pprobe):
                    break
                continue
            pushed = (isinstance(praw, dict)
                      and praw.get("op") == "prefilled"
                      and praw.get("pushed") and xfer is not None)
            if isinstance(praw, dict) and not pushed:
                self._trace_attempt("prefill", patt0, paddr,
                                    "error_reply", reply=praw,
                                    kind=str(praw.get("kind")))
                if praw.get("kind") in ("bad_request",
                                        "deadline_exceeded"):
                    # Deterministic rejection: retrying elsewhere (or
                    # on the unified tier) cannot change the answer.
                    return praw, None
                # Transient replica-side failure (internal error, pool
                # exhaustion): another prefill replica may serve it.
                err = RoutingError(
                    f"prefill failed on {paddr}: {praw.get('error')}")
                last = err
                if not self._note_replica_error(paddr, ptried, err,
                                                probe=pprobe):
                    break
                continue
            if not pushed and (not isinstance(praw, wire.RawFrame)
                               or not isinstance(praw.meta, dict)):
                last = RoutingError(
                    f"malformed prefill reply from {paddr}")
                ptried.add(paddr)
                continue
            self._trace_attempt("prefill", patt0, paddr, "ok",
                                reply=praw)
            self._breaker_ok(paddr, tp, pprobe)
            ttft_ms = (self._clock() - t0) * 1000.0
            self.metrics.inc("disagg_prefills")
            if pushed:
                out, derr = self._disagg_decode_pushed(msg, praw,
                                                       daddr0)
            else:
                out, derr = self._disagg_decode(msg, praw)
            if out is not None:
                if isinstance(out, dict) and out.get("op") == "completion":
                    # The first token exists the moment the prefill
                    # reply lands; the decode replica's own ttft is the
                    # import turnaround, not the user-visible one.
                    dec_total = out.get("total_ms")
                    dec_ttft = out.get("ttft_ms")
                    if isinstance(dec_total, (int, float)) and \
                            isinstance(dec_ttft, (int, float)):
                        out["decode_ms"] = round(dec_total - dec_ttft, 3)
                    out["ttft_ms"] = round(ttft_ms, 3)
                    out["total_ms"] = round(
                        (self._clock() - t0) * 1000.0, 3)
                    self.metrics.inc("disagg_requests")
                    self.budget.on_success()
                return out, None
            # The decode tier could not take this VALID artifact within
            # its retry budget: re-running the whole prefill elsewhere
            # cannot revive a decode replica — fall back without
            # wasting another prompt's worth of compute.
            last = derr or last
            break
        self.metrics.inc("disagg_fallback")
        tracing.cur_event("router", "disagg_fallback")
        return None, last

    def _disagg_decode(self, msg: Dict[str, Any],
                       praw: "wire.RawFrame",
                       art_wv: Optional[str] = None) -> tuple:
        """Phase 2: forward the KV artifact to a decode replica as one
        raw frame; bounded retry onto a different decode replica
        (transient failures — connection loss, timeout, internal
        errors — retry; a bad_request rejection is deterministic and
        returns).  Returns ``(reply, last_error)`` with ``reply`` None
        when the tier is exhausted.  ``art_wv`` pre-pins the artifact's
        weights_version (a suspended mid-stream export adopted by the
        pushed path arrives already pinned)."""
        meta = {k: v for k, v in praw.meta.items()
                if k not in ("op", "id", "prefill_ms", "trace", "gen",
                             "weights_version")}
        meta.update(op="generate", prompt=msg.get("prompt"),
                    max_new_tokens=msg.get("max_new_tokens"),
                    stop_token=msg.get("stop_token"),
                    priority=msg.get("priority"))
        if msg.get("stream"):
            meta["stream"] = True
        emit = msg.get("_emit")
        deadline = self._deadline_of(msg)
        model = msg.get("_model")
        model = model if isinstance(model, str) and model else None
        last: Optional[BaseException] = None
        dtried: set = set()
        # A mid-stream artifact adopted from a drained decode replica
        # pins its weights_version: pages decoded under one set of
        # weights must only continue under the same (fresh prefill
        # artifacts carry no pin — the tier shares the fleet version).
        for attempt in range(self.max_retries + 1):
            if deadline is not None and self._clock() >= deadline:
                return self._expired_reply("before decode could "
                                           "run"), None
            daddr = self.pick_decode(exclude=dtried,
                                     weights_version=art_wv,
                                     model=model)
            if daddr is None:
                return None, last
            dprobe = self._breaker_dispatch(daddr)
            datt0 = tracing.cur_elapsed()
            timeout = self._call_timeout(deadline,
                                         attempt >= self.max_retries)
            try:
                tm = t0 = self._clock()
                if emit is not None:
                    dlink = self._link(daddr)
                    reply = dlink.call_raw(
                        self._wire_msg(meta, deadline), praw.body,
                        timeout=timeout,
                        on_partial=self._cancel_on_disconnect(emit,
                                                              dlink))
                else:
                    reply = self._link(daddr).call_raw(
                        self._wire_msg(meta, deadline), praw.body,
                        timeout=timeout)
                self.metrics.observe(
                    "kv_decode_turnaround_ms",
                    (self._clock() - t0) * 1000.0)
                # Counted only on a delivered transfer: a retried or
                # failed send must not inflate the bench's KV-transfer
                # throughput.
                self.metrics.inc("kv_transfer_bytes", len(praw.body))
            except CallTimeout as e:
                last = e
                self._trace_attempt("decode", datt0, daddr, "timeout",
                                    clipped=timeout < self.request_timeout)
                if not self._note_timeout(
                        daddr, dtried, attempt, "disagg decode",
                        clipped=timeout < self.request_timeout,
                        probe=dprobe):
                    return None, last
                continue
            except wire.WireError as e:
                # Deterministic for this ARTIFACT (its meta — prompt +
                # manifest — or the frame overflows the raw bounds),
                # not for the request: every decode replica would
                # reject the identical bytes, but a unified replica
                # serves the plain generate without them.  Fall back
                # without touching the healthy link.
                return None, RoutingError(
                    f"KV transfer to {daddr} not encodable: {e}")
            except (ConnectionLost, OSError) as e:
                last = e
                self._trace_attempt("decode", datt0, daddr,
                                    "link_failure")
                if not self._note_link_failure(e, daddr, dtried,
                                               attempt, "disagg decode",
                                               probe=dprobe):
                    return None, last
                continue
            s = self._suspended_of(reply)
            if s is not None:
                # The decode replica is being drain-migrated: adopt its
                # fresher suspended artifact (it holds the tokens
                # decoded so far) and retry on another decode replica —
                # or, on a requeue/fenced export, retry the ORIGINAL
                # prefill artifact, which re-decodes deterministically.
                # Healthy outcome for the breaker (see route()).
                self._trace_attempt("decode", datt0, daddr, "suspended",
                                    reply=reply)
                self._breaker_ok(daddr, tm, dprobe)
                dtried.add(daddr)
                self.metrics.inc("migration_exports")
                meta2, body2 = s
                if body2 is not None \
                        and self.registry.gen_allowed(meta2.get("gen")):
                    meta = {k: v for k, v in meta2.items()
                            if k not in ("op", "id", "gen",
                                         "weights_version", "trace")}
                    meta.update(op="generate", prompt=msg.get("prompt"),
                                max_new_tokens=msg.get("max_new_tokens"),
                                stop_token=msg.get("stop_token"),
                                priority=msg.get("priority"))
                    praw = wire.RawFrame(meta2, body2)
                    wv2 = meta2.get("weights_version")
                    art_wv = wv2 if isinstance(wv2, str) and wv2 else None
                last = RoutingError(
                    f"decode replica {daddr} suspended the request")
                continue
            if isinstance(reply, dict) and reply.get("op") == "error":
                self._trace_attempt("decode", datt0, daddr,
                                    "error_reply", reply=reply,
                                    kind=str(reply.get("kind")))
                if reply.get("kind") == "deadline_exceeded":
                    # The decode replica's in-batcher cancel fired:
                    # final for the request — falling back to unified
                    # would only burn more time on expired work.
                    return reply, None
                if reply.get("kind") == "bad_request":
                    # Deterministic for THIS artifact (a config
                    # mismatch between the tiers), not for the
                    # request: a unified replica can still serve the
                    # plain generate, so fall back instead of failing
                    # the client outright.  No retry within the tier —
                    # a homogeneous decode tier rejects everywhere,
                    # and each retry re-ships a multi-MB body.
                    return None, RoutingError(
                        f"decode replica {daddr} rejected the KV "
                        f"artifact: {reply.get('error')}")
                # Transient decode-side failure: another decode replica
                # (or the unified fallback) may still serve it.
                err = RoutingError(
                    f"decode failed on {daddr}: {reply.get('error')}")
                last = err
                if not self._note_replica_error(daddr, dtried, err,
                                                probe=dprobe):
                    return None, last
                continue
            self._trace_attempt("decode", datt0, daddr, "ok",
                                reply=reply)
            self._breaker_ok(daddr, tm, dprobe)
            self.metrics.inc("disagg_decodes")
            return reply, None
        return None, last

    def _disagg_decode_pushed(self, msg: Dict[str, Any],
                              pref: Dict[str, Any],
                              daddr: str) -> tuple:
        """Phase 2 after a DIRECT peer push: the KV artifact already
        sits staged on ``daddr`` (the prefill replica streamed it there
        and acked ``pushed``), so the decode call is one small dict
        naming the ``kv_ref``.  Single bounded attempt — the stage
        lives on exactly one host; any failure returns ``(None, err)``
        and the caller falls back to the unified tier, the stage just
        expires."""
        xfer = pref.get("xfer")
        nbytes = pref.get("bytes")
        emit = msg.get("_emit")
        deadline = self._deadline_of(msg)
        if deadline is not None and self._clock() >= deadline:
            return self._expired_reply("before decode could run"), None
        call = {"op": "generate", "kv_ref": xfer,
                "prompt": msg.get("prompt"),
                "max_new_tokens": msg.get("max_new_tokens"),
                "stop_token": msg.get("stop_token"),
                "priority": msg.get("priority")}
        if msg.get("stream"):
            call["stream"] = True
        dprobe = self._breaker_dispatch(daddr)
        datt0 = tracing.cur_elapsed()
        timeout = self._call_timeout(deadline, True)
        try:
            tm = t0 = self._clock()
            if emit is not None:
                dlink = self._link(daddr)
                reply = dlink.call(
                    self._wire_msg(call, deadline), timeout=timeout,
                    on_partial=self._cancel_on_disconnect(emit, dlink))
            else:
                reply = self._link(daddr).call(
                    self._wire_msg(call, deadline), timeout=timeout)
            self.metrics.observe("kv_decode_turnaround_ms",
                                 (self._clock() - t0) * 1000.0)
            # The bytes moved peer-to-peer (the prefill replica's ack
            # counted them); recorded only once the referencing decode
            # call DELIVERED, mirroring the relay path's discipline.
            if isinstance(nbytes, int) and nbytes > 0:
                self.metrics.inc("kv_transfer_bytes", nbytes)
                self.metrics.inc("kv_direct_bytes", nbytes)
            self.metrics.inc("kv_direct_transfers")
        except CallTimeout as e:
            self._trace_attempt("decode", datt0, daddr, "timeout",
                                clipped=timeout < self.request_timeout)
            return None, e
        except wire.WireError as e:
            return None, RoutingError(
                f"pushed decode call to {daddr} not encodable: {e}")
        except (ConnectionLost, OSError) as e:
            self._trace_attempt("decode", datt0, daddr, "link_failure")
            self._drop_link(daddr)
            self.registry.mark_dead(daddr, why="pushed decode link "
                                               "failure")
            return None, e
        s = self._suspended_of(reply)
        if s is not None:
            # The decode replica is being drained: adopt its fresher
            # suspended artifact through the standard relay machinery
            # (it carries the tokens decoded so far).
            self._trace_attempt("decode", datt0, daddr, "suspended",
                                reply=reply)
            self._breaker_ok(daddr, tm, dprobe)
            self.metrics.inc("migration_exports")
            meta2, body2 = s
            if body2 is not None \
                    and self.registry.gen_allowed(meta2.get("gen")):
                wv2 = meta2.get("weights_version")
                wv2 = wv2 if isinstance(wv2, str) and wv2 else None
                return self._disagg_decode(
                    msg, wire.RawFrame(meta2, body2), art_wv=wv2)
            return None, RoutingError(
                f"decode replica {daddr} suspended the pushed request")
        if isinstance(reply, dict) and reply.get("op") == "error":
            self._trace_attempt("decode", datt0, daddr, "error_reply",
                                reply=reply,
                                kind=str(reply.get("kind")))
            if reply.get("kind") == "deadline_exceeded":
                return reply, None
            # unknown kv_ref (stage expired/evicted), artifact
            # mismatch, transient failure: the stage is single-homed,
            # so every path falls back to the unified tier.
            return None, RoutingError(
                f"pushed decode on {daddr} failed: "
                f"{reply.get('error')}")
        self._trace_attempt("decode", datt0, daddr, "ok", reply=reply)
        self._breaker_ok(daddr, tm, dprobe)
        self.metrics.inc("disagg_decodes")
        return reply, None

    def close(self) -> None:
        with self._lock:
            links = list(self._links.values())
            self._links.clear()
        for link in links:
            link.close()
