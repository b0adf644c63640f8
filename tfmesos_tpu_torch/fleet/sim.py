"""Trace-driven fleet simulator: the control plane on a virtual clock
(port of ``tfmesos_tpu/fleet/sim.py``; the same scenarios give the same
results at the same seed).

A discrete-event harness that runs the REAL serving control plane —
:class:`~tfmesos_tpu_torch.fleet.admission.AdmissionController` WFQ queues,
:class:`~tfmesos_tpu_torch.fleet.router.Router` (picks, retries, breakers,
budget, deadlines, disagg orchestration, migration re-placement),
:class:`~tfmesos_tpu_torch.fleet.containment.BreakerBoard` /
:class:`~tfmesos_tpu_torch.fleet.containment.RetryBudget`,
:class:`~tfmesos_tpu_torch.fleet.registry.ReplicaRegistry` (the actual table,
fences and sweeps included), and the real
:class:`~tfmesos_tpu_torch.fleet.autoscaler.FleetAutoscaler` feedback loop —
against SIMULATED replicas: per-replica state machines parameterized by
a latency model, capacity, KV headroom, and a failure script, instead
of processes.  TF-Replicator's separate-policy-from-mechanism argument
(PAPERS.md) is the design warrant: the mechanisms are jax-free and
clock-injectable, so their policies can be evaluated against recorded
or synthesized workloads in seconds of CPU — 1000-replica fleets,
millions of requests — instead of minutes of live wall-clock.

How time works (the whole trick):

* One :class:`VirtualClock` is injected as the ``clock`` of the
  registry, admission controller, router (and its breaker board), and
  autoscaler — the same parameter production binds to
  ``time.monotonic``.  Nothing on the control plane reads real time.
* A single event heap orders the future: request arrivals, call
  completions, heartbeats, registry sweeps, autoscaler ticks.  The
  engine pops events in time order and advances the clock to each.
* The control-plane code is SYNCHRONOUS (the router blocks in
  ``link.call``), so blocking points run on cooperative worker fibers:
  real threads scheduled strictly one-at-a-time by the engine.  A
  fiber entering a virtual wait (a call in flight, a retry backoff)
  parks; the engine wakes it at the event that resolves the wait.  At
  most one thread runs at any instant — execution is deterministic,
  seeded, and involves ZERO real sleeping (the router's ``sleep`` is
  the engine's virtual one; tier-1 asserts no ``time.sleep`` fires).
* When a call's completion would be the next event anyway, the engine
  advances the clock directly and returns in-line (the classic DES
  no-intervening-event shortcut) — no thread handoff on the fast path.

Workloads come from :mod:`tfmesos_tpu_torch.fleet.workload`: a seeded
synthesizer, or replay of a recorded ``tfserve trace --json`` export.
Scenarios (``SCENARIOS``) package fleet + workload + timeline;
``tfserve simulate`` runs them by name, and ``--sweep
breaker.latency_factor=2,4,8`` runs one per value for policy tuning
(:func:`apply_override` addresses every promoted policy constant by
path).  The ``soak-replay`` scenario is the FIDELITY GATE: it replays
the seeded chaos timeline of ``bench_fleet_soak`` (gray-slow replica,
hard kill + autoscaler self-heal, link sever, blue-green rollout) and
must reproduce its qualitative outcomes — breaker isolation of the
slow replica while heartbeat-alive, zero lost requests, retry
amplification <= 1.5 — asserted in tier-1 so policy regressions fail
CI deterministically (docs/SIMULATOR.md).
"""

from __future__ import annotations

import dataclasses
import heapq
import logging
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from tfmesos_tpu_torch import wire
from tfmesos_tpu_torch.fleet.admission import (AdmissionController,
                                         DEFAULT_MAX_QUEUE,
                                         DeadlineExceeded, Overloaded,
                                         PriorityClass, RateLimited)
from tfmesos_tpu_torch.fleet.autoscaler import AutoscalerConfig, FleetAutoscaler
from tfmesos_tpu_torch.fleet.catalog import (POOL, ModelCatalog, ModelSpec,
                                       ModelTrader, TraderConfig,
                                       model_key, split_key)
from tfmesos_tpu_torch.fleet.client import CallTimeout, ConnectionLost
from tfmesos_tpu_torch.fleet.containment import BreakerConfig, RetryBudget
from tfmesos_tpu_torch.fleet.kvtier import rendezvous_order
from tfmesos_tpu_torch.fleet.metrics import FleetMetrics
from tfmesos_tpu_torch.fleet.registry import (DECODE, PREFILL, UNIFIED, WARMING,
                                        ReplicaRegistry)
from tfmesos_tpu_torch.fleet.router import Router
from tfmesos_tpu_torch.fleet.workload import (DiurnalWorkload, Request,
                                        SyntheticWorkload)
from tfmesos_tpu_torch.utils.logging import get_logger

__all__ = ["VirtualClock", "SimEngine", "ReplicaModel", "SimReplica",
           "SimConfig", "FleetSim", "apply_override", "parse_sweep",
           "run_scenario", "run_sweep", "SCENARIOS"]


# -- the virtual clock & engine ----------------------------------------------


class VirtualClock:
    """Callable monotone virtual time in seconds — drop-in for the
    ``clock=time.monotonic`` parameter everywhere it exists."""

    __slots__ = ("now",)

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now


class _FiberStop(BaseException):
    """Raised inside a parked fiber at teardown; BaseException so no
    control-plane except-clause can swallow it."""


class _Baton:
    """A binary handoff built on a raw ``threading.Lock`` (a C futex —
    several times cheaper per handoff than ``threading.Event``, whose
    wait path is a Python-level Condition).  Strict baton-passing
    guarantees at most one ``signal`` precedes each ``wait``."""

    __slots__ = ("_lk",)

    def __init__(self):
        self._lk = threading.Lock()
        self._lk.acquire()

    def wait(self) -> None:
        self._lk.acquire()

    def signal(self) -> None:
        self._lk.release()


class _Fiber:
    """One cooperative worker: a real thread that runs only when the
    engine hands it the baton and parks at every virtual wait."""

    __slots__ = ("name", "baton", "payload", "exc", "done", "thread",
                 "body")

    def __init__(self, engine: "SimEngine", body: Callable[[], None],
                 name: str):
        self.name = name
        self.baton = _Baton()
        self.payload: Any = None
        self.exc: Optional[BaseException] = None
        self.done = False
        self.body = body
        self.thread = threading.Thread(target=self._main, args=(engine,),
                                       name=name, daemon=True)

    def _main(self, engine: "SimEngine") -> None:
        self.baton.wait()
        try:
            if self.exc is None:
                self.body()
        except _FiberStop:
            pass
        except BaseException as e:  # noqa: BLE001 - surfaced to engine
            engine._crash = e
        finally:
            self.done = True
            engine._engine_baton.signal()


class SimEngine:
    """Event heap + virtual clock + cooperative fiber scheduler.

    Strict baton-passing: the engine thread and at most ONE fiber are
    ever runnable, and only one of them at a time — the handoff is two
    Event signals, so simulation is deterministic (seeded rng, ordered
    heap) and costs ~10us per virtual block, zero on the fast path.
    """

    def __init__(self, seed: int = 0):
        self.clock = VirtualClock()
        self.rng = random.Random(seed)
        self.events = 0
        self._heap: List[tuple] = []
        self._seq = 0
        self._engine_baton = _Baton()
        self._current: Optional[_Fiber] = None
        self._crash: Optional[BaseException] = None
        self._fibers: List[_Fiber] = []

    # -- scheduling (single-threaded by protocol) --------------------------

    def at(self, t: float, fn: Callable[[], None]) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, fn))

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self.at(self.clock.now + dt, fn)

    # -- engine-context primitives -----------------------------------------

    def spawn(self, body: Callable[[], None],
              name: str = "sim-fiber") -> _Fiber:
        """Create a fiber and run it until its first park (so a worker
        reaches its idle wait before any event fires)."""
        f = _Fiber(self, body, name)
        self._fibers.append(f)
        f.thread.start()
        self._resume(f)
        return f

    def _resume(self, fiber: _Fiber, payload: Any = None,
                exc: Optional[BaseException] = None) -> None:
        """Hand the baton to ``fiber`` (delivering ``payload`` or
        raising ``exc`` from its park) and block until it parks again
        or finishes."""
        prev = self._current
        fiber.payload, fiber.exc = payload, exc
        self._current = fiber
        fiber.baton.signal()
        self._engine_baton.wait()
        self._current = prev
        if self._crash is not None:
            crash, self._crash = self._crash, None
            raise crash

    def run(self, until: Optional[float] = None,
            stop: Optional[Callable[[], bool]] = None) -> None:
        """Pop events in time order until the heap empties, ``until``
        virtual seconds pass, or ``stop()`` answers True (checked
        between events)."""
        heap = self._heap
        clock = self.clock
        while heap:
            if stop is not None and stop():
                return
            t = heap[0][0]
            if until is not None and t > until:
                break
            _, _, fn = heapq.heappop(heap)
            if t > clock.now:
                clock.now = t
            self.events += 1
            fn()
        if until is not None and clock.now < until:
            clock.now = until

    def stop_fibers(self) -> None:
        """Unwind every parked fiber with :class:`_FiberStop`."""
        for f in self._fibers:
            if not f.done:
                self._resume(f, exc=_FiberStop())
        for f in self._fibers:
            f.thread.join(timeout=2.0)
        self._fibers = []

    # -- fiber-context primitives ------------------------------------------

    def park(self) -> Any:
        """Block the current fiber until the engine resumes it; returns
        the resume payload or raises the resume exception."""
        me = self._current
        self._engine_baton.signal()
        me.baton.wait()
        if me.exc is not None:
            exc, me.exc = me.exc, None
            raise exc
        return me.payload

    def sleep(self, dt: float) -> None:
        """Virtual sleep — what the router's injected ``sleep`` binds
        to; no real time passes."""
        if dt <= 0:
            return
        me = self._current
        fired = [False]

        def wake() -> None:
            if not fired[0]:
                fired[0] = True
                self._resume(me)

        self.at(self.clock.now + dt, wake)
        self.park()

    def fast_forward(self, t: float) -> bool:
        """If nothing is scheduled before ``t``, jump the clock there
        and return True — the caller may resolve its wait in-line
        without a park/resume round trip.  Correct because the strict
        baton protocol guarantees no other fiber is runnable."""
        if self._heap and self._heap[0][0] < t:
            return False
        if t > self.clock.now:
            self.clock.now = t
        self.events += 1
        return True


# -- simulated replicas ------------------------------------------------------


@dataclasses.dataclass
class ReplicaModel:
    """A replica's latency model: TTFT is ``prefill_base_ms +
    prefill_ms_per_token * prompt_len``, the decode tail adds
    ``decode_ms_per_token * new_tokens``; ``jitter`` is a lognormal
    sigma applied multiplicatively (0 = deterministic).  Replay fits
    these from recorded traces (:func:`~tfmesos_tpu_torch.fleet.workload.
    fit_replica_model`).  ``kv_bytes_per_token`` sizes the raw-frame
    KV artifacts the sim's drain migration and session park/resume
    carry (per cached position; the tiny CI model's pages work out to
    ~0.5 KB/token, flagship configs far more)."""

    prefill_base_ms: float = 4.0
    prefill_ms_per_token: float = 0.05
    decode_ms_per_token: float = 2.0
    jitter: float = 0.0
    kv_bytes_per_token: float = 512.0

    def service_s(self, prompt_len: int, new_tokens: int,
                  rng: random.Random) -> Tuple[float, float]:
        """``(ttft_s, total_s)`` for one request."""
        ttft = self.prefill_base_ms + self.prefill_ms_per_token * prompt_len
        total = ttft + self.decode_ms_per_token * new_tokens
        if self.jitter > 0:
            m = rng.lognormvariate(0.0, self.jitter)
            ttft *= m
            total *= m
        return ttft / 1000.0, total / 1000.0


def gang_model(base: ReplicaModel, size: int,
               efficiency: float) -> ReplicaModel:
    """The latency model of a GANG replica: N members SPMD-execute
    each batch, so per-token compute divides by the slice's effective
    speedup (``size × efficiency`` — collectives eat the rest); the
    per-request base overhead and the whole-artifact KV bytes do not
    shrink (the gang's sharded export parks as one artifact)."""
    if size <= 1:
        return base
    speed = max(1.0, size * efficiency)
    return dataclasses.replace(
        base,
        prefill_ms_per_token=base.prefill_ms_per_token / speed,
        decode_ms_per_token=base.decode_ms_per_token / speed)


class SimReplica:
    """One simulated replica: a ``capacity``-server FIFO queue over a
    latency model, plus the failure-script knobs the scenarios twist
    (``slow_factor`` = the gray failure, ``error_rate`` = transient
    internal errors, ``sever_next`` = one-shot link severs,
    ``down`` = a hard kill: beats stop, pending calls fail)."""

    __slots__ = ("addr", "role", "capacity", "model", "weights_version",
                 "gen", "node", "warm_until", "down", "removed",
                 "migrating", "slow_factor", "error_rate", "sever_next",
                 "drop_beats", "kv_pages", "served", "busy_s",
                 "model_id", "pool", "gang_size", "gang_live",
                 "_servers", "_inflight", "_pending")

    def __init__(self, addr: str, role: str = UNIFIED, capacity: int = 4,
                 model: Optional[ReplicaModel] = None,
                 weights_version: str = "v1", gen: int = 0,
                 node: str = "", warm_until: float = 0.0,
                 kv_pages: int = 64, model_id: str = "",
                 pool: bool = False, gang_size: int = 1):
        self.addr = addr
        self.role = role
        self.capacity = int(capacity)
        self.model = model or ReplicaModel()
        self.weights_version = weights_version
        self.gen = int(gen)
        self.node = node
        self.warm_until = float(warm_until)
        self.down = False
        self.removed = False
        self.migrating = False
        self.slow_factor = 1.0
        self.error_rate = 0.0
        self.sever_next = 0
        self.drop_beats = False
        self.kv_pages = int(kv_pages)
        self.served = 0
        # Slot-seconds actually spent serving (the utilization gauge's
        # numerator; deadline cancels shrink it via release_to).
        self.busy_s = 0.0
        # Model catalog: the catalog model this replica serves, and
        # warm-pool membership (undedicated; adoption flips both).
        self.model_id = model_id
        self.pool = bool(pool)
        # Gang replicas: >1 means this sim replica stands for a whole
        # N-member pod-slice gang (one routable leader); its beats
        # carry the gang field the real registry parses.
        self.gang_size = max(1, int(gang_size))
        self.gang_live = self.gang_size
        self._servers = [0.0] * self.capacity     # per-slot free-at
        self._inflight: List[float] = []          # finish times
        self._pending: List[list] = []            # live call records

    def outstanding(self, now: float) -> int:
        fl = self._inflight
        while fl and fl[0] <= now:
            heapq.heappop(fl)
        return len(fl)

    def occupy(self, now: float, service_s: float) -> Tuple[float, float]:
        """FIFO ``capacity``-server queueing: the request starts when
        the earliest slot frees, finishes ``service_s`` later.
        Returns ``(start, finish)``."""
        free = heapq.heappop(self._servers)
        start = max(now, free)
        finish = start + service_s
        heapq.heappush(self._servers, finish)
        heapq.heappush(self._inflight, finish)
        self.busy_s += service_s
        return start, finish

    def release_to(self, finish: float, t: float) -> None:
        """Shrink the occupation that ends at ``finish`` (the value
        :meth:`occupy` just returned) to end at ``t`` instead — an
        in-batcher deadline cancel frees THAT row early, never some
        other in-flight request's slot."""
        shrunk = False
        for heap in (self._servers, self._inflight):
            try:
                heap.remove(finish)
            except ValueError:
                continue
            heapq.heapify(heap)
            heapq.heappush(heap, t)
            shrunk = True
        if shrunk:
            self.busy_s -= max(0.0, finish - t)


# -- the virtual transport ---------------------------------------------------


class _SimLink:
    """MuxConnection-shaped handle the router holds per replica: the
    ``outstanding`` property is its p2c load signal, ``call`` /
    ``call_raw`` resolve through the transport's event heap."""

    __slots__ = ("_hub", "addr", "closed", "_outstanding")

    def __init__(self, hub: "SimTransport", addr: str):
        self._hub = hub
        self.addr = addr
        self.closed = False
        self._outstanding = 0

    @property
    def outstanding(self) -> int:
        return self._outstanding

    def call(self, msg: Dict[str, Any],
             timeout: Optional[float] = None) -> Any:
        return self._hub.call(self, msg, timeout)

    def call_raw(self, meta: Dict[str, Any], body,
                 timeout: Optional[float] = None) -> Any:
        return self._hub.call(self, meta, timeout)

    def close(self) -> None:
        self.closed = True


_EMPTY_TOKENS: tuple = ()


class SimTransport:
    """The fleet's virtual data plane: the router's ``link_factory``.
    Calls compute their reply time from the target replica's queueing
    model + failure script, then either fast-forward (no earlier
    event) or park the calling fiber until the reply event."""

    def __init__(self, engine: SimEngine):
        self.engine = engine
        self.replicas: Dict[str, SimReplica] = {}
        # The sim's KV-tier model (docs/SERVING.md "KV tiering &
        # sessions"): one HOST-SHARED session tier (the disk-dir
        # deployment — replicas of the host resume each other's parked
        # sessions, and a replica death does not lose it), mapping
        # session id -> (covered tokens, weights_version).  A resume
        # only counts when the versions match — the rollout fence.
        self.session_tier: Dict[str, Tuple[int, str, Any]] = {}
        self.session_stats = {"hits": 0, "misses": 0, "park": 0,
                              "resume": 0, "version_miss": 0,
                              "cross_host_miss": 0,
                              "host_loss_miss": 0, "forwarded": 0,
                              "ttft_hit_ms": 0.0, "ttft_cold_ms": 0.0}
        # Cross-host placement knob (gang-parked sharded sessions):
        # the probability a parked artifact resumes on a replica OTHER
        # than its parker — 1.0 is the host-shared disk tier (today's
        # behavior, everything resumable), lower models fleets whose
        # gang artifacts live host-local and a cross-host landing
        # re-prefills cold.
        self.cross_host_resume = 1.0
        # Cross-host KV fabric placement (docs/SERVING.md "Cross-host
        # KV fabric"): 0 keeps the host-shared tier above (a kill
        # loses nothing), K >= 1 switches to per-host tiers with
        # K-way rendezvous-placed parking — an artifact lives on
        # exactly K copy hosts (the real fabric's placement function,
        # so the sim prices the same copy sets the fleet would pick),
        # a resume landing off every copy host forwards the bytes for
        # ``kv_forward_ms`` of TTFT, and a kill loses only sessions
        # whose EVERY copy host died (``host_loss_miss``).
        self.kv_replication = 0
        self.kv_forward_ms = 2.0
        # Copy-placement policy for K-way parking: "rendezvous" is the
        # pure hash ranking, "loaded" stable-sorts that ranking by each
        # candidate's coarse tier occupancy (copies held / kv_pages,
        # quantized to 5 buckets — KVFabric._order's exact rule) so hot
        # tiers shed new copies while near-empty ones keep their hash
        # affinity.
        self.kv_placement = "rendezvous"
        self._tier_load: Dict[str, int] = {}

    def _place(self, sid: str, parker: str) -> Tuple[str, ...]:
        """Pick the K-way copy set for a parked session: the parker
        plus the first K-1 peers under the configured placement."""
        peers = [a for a, h in sorted(self.replicas.items())
                 if not h.down and not h.removed and a != parker]
        ranked = rendezvous_order(sid, peers)
        if self.kv_placement == "loaded":
            load = self._tier_load
            ranked = sorted(
                ranked,
                key=lambda a: min(4, int(
                    4 * load.get(a, 0)
                    / max(1, self.replicas[a].kv_pages))))
        return (parker,) + tuple(
            ranked[:max(0, self.kv_replication - 1)])

    def link(self, addr: str) -> _SimLink:
        rep = self.replicas.get(addr)
        if rep is None or rep.down:
            raise ConnectionLost(f"dial refused: {addr}")
        return _SimLink(self, addr)

    def fail_pending(self, rep: SimReplica,
                     exc_factory=ConnectionLost) -> None:
        """A dying replica fails every in-flight call NOW (the mux
        link's EOF behavior)."""
        pending, rep._pending = rep._pending, []
        for rec in pending:
            if not rec[0]:
                rec[0] = True
                self.engine._resume(rec[1], None,
                                    exc_factory(f"{rep.addr} died "
                                                f"mid-request"))

    def suspend_pending(self, rep: SimReplica) -> None:
        """Drain migration: every in-flight generate answers
        ``suspended`` carrying a RAW-FRAME KV artifact sized from the
        replica model (``kv_bytes_per_token`` × the positions decoded
        so far) — the router re-places it on a same-version survivor
        through its real ``_resume_elsewhere`` path, exactly like a
        live replica's export.  Calls with no generate shape (control ops)
        still answer the plain requeue marker.  The replica's rows
        free immediately either way."""
        now = self.engine.clock.now
        rep._servers = [now] * rep.capacity
        rep._inflight = []
        pending, rep._pending = rep._pending, []
        for rec in pending:
            if rec[0]:
                continue
            rec[0] = True
            msg = rec[2] if len(rec) > 2 else None
            if isinstance(msg, dict) and msg.get("op") == "generate":
                prompt = msg.get("prompt")
                plen = len(prompt) if prompt is not None else 0
                want = int(msg.get("max_new_tokens") or 1)
                done = max(1, want // 2)    # suspended mid-stream
                body = bytes(min(64 << 20, int(
                    (plen + done) * rep.model.kv_bytes_per_token)))
                meta = {"op": "suspended", "gen": rep.gen,
                        "weights_version": rep.weights_version,
                        "resumed_tokens": done}
                self.engine._resume(rec[1], wire.RawFrame(meta, body),
                                    None)
            else:
                self.engine._resume(rec[1], {"op": "suspended"}, None)

    def call(self, link: _SimLink, msg: Dict[str, Any],
             timeout: Optional[float]) -> Any:
        eng = self.engine
        now = eng.clock.now
        rep = self.replicas.get(link.addr)
        if link.closed or rep is None or rep.down or rep.removed:
            raise ConnectionLost(f"{link.addr} unreachable")
        if rep.sever_next > 0:
            rep.sever_next -= 1
            raise ConnectionLost(f"{link.addr} link severed (scripted)")
        if rep.migrating:
            return {"op": "suspended"}      # requeue marker: re-run
        op = msg.get("op")
        prompt = msg.get("prompt")
        prompt_len = len(prompt) if prompt is not None else 0
        new_tokens = int(msg.get("max_new_tokens") or 1)
        rng = eng.rng
        # Session tier (KV tiering & sessions): a session-labeled
        # generate whose conversation is parked in the host tier
        # prefills only the new TAIL — the parked coverage's positions
        # import instead of recomputing.  Version mismatch (a parked
        # v1 artifact after a v2 rollout) is a counted miss: the turn
        # re-prefills cold, never stale KV.
        sid = msg.get("session")
        sid = sid if isinstance(sid, str) and sid else None
        session_hit = False
        session_forward = False
        eff_prompt = prompt_len
        if sid is not None and op == "generate":
            st = self.session_stats
            ent = self.session_tier.get(sid)
            if ent is not None and 0 < ent[0] < prompt_len:
                holders = ent[2] if len(ent) > 2 else ()
                if isinstance(holders, str):
                    holders = (holders,) if holders else ()
                alive = tuple(
                    a for a in holders
                    if a in self.replicas and not self.replicas[a].down
                    and not self.replicas[a].removed)
                if self.kv_replication >= 1 and not alive:
                    # Fabric placement model: every copy host died
                    # with the artifact — K-way parking was the only
                    # defense, and K was too small.
                    st["host_loss_miss"] += 1
                    st["misses"] += 1
                elif self.kv_replication < 1 and holders \
                        and rep.addr not in holders \
                        and self.cross_host_resume < 1.0 \
                        and rng.random() >= self.cross_host_resume:
                    # Landed off the parker's host and the artifact
                    # did not travel: a counted cold re-prefill.
                    st["cross_host_miss"] += 1
                    st["misses"] += 1
                elif ent[1] == rep.weights_version:
                    session_hit = True
                    session_forward = (self.kv_replication >= 1
                                       and rep.addr not in alive)
                    eff_prompt = prompt_len - ent[0]
                    st["hits"] += 1
                    st["resume"] += 1
                    if session_forward:
                        st["forwarded"] += 1
                else:
                    st["version_miss"] += 1
                    st["misses"] += 1
            else:
                st["misses"] += 1
        ttft_s, total_s = rep.model.service_s(eff_prompt, new_tokens, rng)
        if session_forward:
            # The artifact streams over from a surviving copy host
            # before the tail prefill: a wire cost, not a recompute.
            fwd = self.kv_forward_ms / 1000.0
            ttft_s += fwd
            total_s += fwd
        resumed = msg.get("resumed_tokens")
        if op == "prefill":
            total_s = ttft_s            # prefill tier: no decode tail
        elif isinstance(resumed, int) and resumed > 0:
            # A drain-migration artifact re-imported mid-stream: the
            # survivor decodes only the REMAINING tokens — no prefill
            # re-run (that is the whole point of carrying the bytes).
            remaining = max(1, new_tokens - resumed)
            total_s = rep.model.decode_ms_per_token * remaining / 1000.0
            ttft_s = min(ttft_s, total_s)
        elif rep.role == DECODE:
            total_s = max(0.0, total_s - ttft_s)    # imported prefill
            ttft_s = 0.0
        if rep.slow_factor != 1.0:
            ttft_s *= rep.slow_factor
            total_s *= rep.slow_factor
        reply: Any
        if rep.error_rate and rng.random() < rep.error_rate:
            start, finish = rep.occupy(now, min(total_s, 0.001))
            reply = {"op": "error", "kind": "internal",
                     "error": "scripted transient failure"}
        else:
            start, finish = rep.occupy(now, total_s)
            dl = msg.get("deadline_ms")
            if isinstance(dl, (int, float)) and not isinstance(dl, bool) \
                    and dl > 0 and finish > now + dl / 1000.0:
                # The in-batcher deadline cancel: explicit error at the
                # deadline, THIS row's slot freed early.
                cut = now + dl / 1000.0
                rep.release_to(finish, cut)
                finish = cut
                reply = {"op": "error", "kind": "deadline_exceeded",
                         "error": "deadline expired in the batcher"}
            elif op == "prefill":
                reply = wire.RawFrame(
                    {"op": "prefill", "id": 0,
                     "weights_version": rep.weights_version,
                     "gen": rep.gen,
                     "prefill_ms": round((finish - now) * 1000.0, 3)},
                    b"")
            else:
                reply = {"op": "completion", "tokens": _EMPTY_TOKENS,
                         "n_tokens": new_tokens,
                         "ttft_ms": round(
                             (start + ttft_s - now) * 1000.0, 3),
                         "total_ms": round((finish - now) * 1000.0, 3)}
                if sid is not None and op == "generate":
                    # Park the finished conversation's coverage (the
                    # last emitted token is the next turn's tail
                    # input, like the real artifact's history).
                    holders: Any = rep.addr
                    if self.kv_replication >= 1:
                        holders = self._place(sid, rep.addr)
                        load = self._tier_load
                        prev = self.session_tier.get(sid)
                        if prev is not None and len(prev) > 2 \
                                and not isinstance(prev[2], str):
                            for a in prev[2]:   # re-park replaces copies
                                if load.get(a, 0) > 0:
                                    load[a] -= 1
                        for a in holders:
                            load[a] = load.get(a, 0) + 1
                    self.session_tier[sid] = (
                        prompt_len + new_tokens - 1,
                        rep.weights_version, holders)
                    st = self.session_stats
                    st["park"] += 1
                    st["ttft_hit_ms" if session_hit
                       else "ttft_cold_ms"] += reply["ttft_ms"]
        rep.served += 1
        t_wake = finish
        exc: Optional[BaseException] = None
        if timeout is not None and finish > now + timeout:
            t_wake = now + timeout
            exc = CallTimeout(f"no reply from {link.addr} within "
                              f"{timeout}s (sim)")
        if not rep._pending and eng.fast_forward(t_wake):
            # No intervening event: resolve in-line, no thread handoff.
            if exc is not None:
                raise exc
            return reply
        me = eng._current
        rec = [False, me, msg]
        rep._pending.append(rec)

        def wake() -> None:
            if not rec[0]:
                rec[0] = True
                eng._resume(me, reply, exc)

        eng.at(t_wake, wake)
        link._outstanding += 1
        try:
            return eng.park()
        finally:
            link._outstanding -= 1
            rec[0] = True
            try:
                rep._pending.remove(rec)
            except ValueError:
                pass


# -- configuration -----------------------------------------------------------


@dataclasses.dataclass
class SimConfig:
    """One simulation's fleet + policy configuration.  Every policy
    constant the control plane guesses at is addressable here by sweep
    path (``breaker.*``, ``autoscaler.*``, ``admission.*``,
    ``budget.*``, ``router.*``, ``model.*``, or a top-level field) —
    see :func:`apply_override`."""

    seed: int = 0
    replicas: int = 3
    prefill_replicas: int = 0
    decode_replicas: int = 0
    capacity: int = 4
    kv_pages: int = 64
    # Model catalog (the multi-model scenario): (model_id, boot
    # replicas) entries, a warm pool of undedicated replicas, the
    # fleet-wide budget the trader reallocates within (None = boot
    # footprint), and the trader's knobs — all sweepable
    # (``catalog.warm_pool``, ``catalog.budget``, ``trader.*``).
    models: Tuple[Tuple[str, int], ...] = ()
    warm_pool: int = 0
    model_budget: Optional[int] = None
    trader: "TraderConfig" = dataclasses.field(
        default_factory=lambda: TraderConfig())
    # N stateless gateway "fibers" over the ONE registry/router view —
    # the sim analog of `tfserve --gateways N` (each front door gets
    # its own AdmissionController + dispatch-worker fibers; arrivals
    # round-robin across live fronts like clients spreading
    # connections).  1 = the classic single-gateway topology, exactly.
    gateways: int = 1
    # Gang replicas (the ``gang`` scenario; sweep ``gang_size=2,4,8``):
    # each unified replica stands for an N-member pod-slice gang —
    # per-token compute divides by size × gang_efficiency, a member's
    # death is the gang's death, and the fleet re-forms it whole after
    # gang_reform_s (launch + rendezvous + re-warm).
    gang_size: int = 1
    gang_efficiency: float = 0.85
    gang_reform_s: float = 2.0
    # Cross-host resume probability for parked sessions (the sessions
    # scenario's gang-parked-shard knob; sweep ``cross_host_resume=
    # 1.0,0.5,0.0``).  1.0 = the host-shared tier, exactly.
    cross_host_resume: float = 1.0
    # Cross-host KV fabric placement policy (the sessions scenario;
    # sweep ``kv_replication=1,2,3`` and ``kv_forward_ms`` to tune the
    # replication factor and forwarding constant on the virtual
    # clock): 0 = the host-shared disk tier above, exactly.  K >= 1
    # switches to per-host tiers with K-way rendezvous-placed parking
    # — a kill loses only sessions whose every copy host died.
    kv_replication: int = 0
    kv_forward_ms: float = 2.0
    # Copy-placement policy when K >= 1 (sweep ``kv_placement=
    # rendezvous,loaded``): "loaded" stable-sorts the rendezvous
    # ranking by tier occupancy before truncating to K-1 copies —
    # KVFabric's ``placement=loaded`` knob priced on the virtual clock.
    kv_placement: str = "rendezvous"
    workers: int = 8
    max_queue: int = DEFAULT_MAX_QUEUE
    rate_limit: Optional[float] = None
    # (name, weight, rank) entries, optionally (name, weight, rank,
    # batch): a truthy 4th element marks the deadline-less BATCH class
    # (dispatches only when every non-batch queue is empty — the
    # offline lane, docs/SERVING.md).
    classes: Tuple[Tuple[str, float, int], ...] = (
        ("interactive", 8.0, 1), ("background", 1.0, 0))
    # The offline lane (`tfserve --batch-lane`): True appends a
    # deadline-less 'batch' class below every listed class.
    batch_lane: bool = False
    # Interactive-vs-batch budget split (sweep ``batch_slot_frac=
    # 0.25,0.5,0.75,1.0``): the fraction of the fleet's aggregate
    # decode slots batch-lane work may occupy at once — the sim analog
    # of batch rows taking only idle slots and leftover tick budget,
    # yielding the rest to interactive arrivals.  1.0 = no reserve.
    batch_slot_frac: float = 0.5
    model: ReplicaModel = dataclasses.field(default_factory=ReplicaModel)
    breaker: BreakerConfig = dataclasses.field(
        default_factory=BreakerConfig)
    breakers: bool = True
    autoscaler: AutoscalerConfig = dataclasses.field(
        default_factory=AutoscalerConfig)
    autoscale: bool = False
    min_replicas: int = 1
    max_replicas: int = 64
    budget_max_tokens: float = 10.0
    budget_token_ratio: float = 0.1
    max_retries: int = 2
    backoff_s: float = 0.05
    request_timeout: float = 60.0
    hb_interval: float = 0.5
    # Heartbeat sharding (the diurnal 10k-replica scenario): 0 keeps
    # one timer event per replica per beat — the classic behavior,
    # exactly.  N > 0 batches replicas into N self-rescheduling shard
    # beats, collapsing the event heap's dominant term at 10k replicas
    # (10k events/sim-second -> N) without changing what the registry
    # observes.  Opt-in because it quantizes beat phases per shard.
    hb_shards: int = 0
    suspect_after: float = 1.5
    dead_after: float = 3.0
    evict_after: float = 10.0
    sweep_interval: float = 0.2
    warmup_s: float = 1.0
    weights_version: str = "v1"


_OVERRIDE_ROOTS = {
    "breaker": lambda cfg: cfg.breaker,
    "autoscaler": lambda cfg: cfg.autoscaler,
    "model": lambda cfg: cfg.model,
    "trader": lambda cfg: cfg.trader,
}
_OVERRIDE_ALIASES = {
    "admission.max_queue": "max_queue",
    "admission.rate": "rate_limit",
    "budget.max_tokens": "budget_max_tokens",
    "budget.token_ratio": "budget_token_ratio",
    "router.max_retries": "max_retries",
    "router.backoff_s": "backoff_s",
    "router.request_timeout": "request_timeout",
    "catalog.warm_pool": "warm_pool",
    "catalog.budget": "model_budget",
}


def _coerce(old: Any, value: str) -> Any:
    if isinstance(old, bool):
        return value.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(old, int) and not isinstance(old, bool):
        return int(float(value))
    if isinstance(old, float) or old is None:
        return float(value)
    return value


def apply_override(cfg: SimConfig, path: str, value) -> None:
    """Set one policy constant by dotted path (``breaker.
    latency_factor``, ``autoscaler.queue_wait_hi_ms``,
    ``admission.max_queue``, ``budget.token_ratio``,
    ``router.max_retries``, ``model.decode_ms_per_token``, or a
    top-level ``SimConfig`` field like ``replicas``).  String values
    are coerced to the field's current type."""
    alias = _OVERRIDE_ALIASES.get(path)
    if alias is not None:
        target, field = cfg, alias
    elif "." in path:
        root, field = path.split(".", 1)
        getter = _OVERRIDE_ROOTS.get(root)
        if getter is None or "." in field:
            raise ValueError(f"unknown sweep path {path!r}")
        target = getter(cfg)
    else:
        target, field = cfg, path
    if not hasattr(target, field):
        raise ValueError(f"unknown sweep path {path!r}")
    old = getattr(target, field)
    setattr(target, field,
            _coerce(old, value) if isinstance(value, str) else value)


def swept(overrides, field: str) -> bool:
    """True when any override path targets ``field``, ALIASES RESOLVED
    (``admission.max_queue`` targets ``max_queue``) — scenarios use
    this to lay in scale defaults without clobbering a sweep's
    explicit choice of the same constant."""
    for p, _ in (overrides or ()):
        if p == field or _OVERRIDE_ALIASES.get(p) == field:
            return True
    return False


def parse_sweep(spec: str) -> Tuple[str, List[str]]:
    """``"breaker.latency_factor=2,4,8"`` -> ``("breaker.
    latency_factor", ["2", "4", "8"])``."""
    if "=" not in spec:
        raise ValueError(f"sweep spec needs PATH=V1,V2,...: {spec!r}")
    path, _, values = spec.partition("=")
    vals = [v for v in values.split(",") if v != ""]
    if not path or not vals:
        raise ValueError(f"sweep spec needs PATH=V1,V2,...: {spec!r}")
    return path.strip(), vals


# -- the simulation harness --------------------------------------------------


class _SimFront:
    """One simulated gateway front door: its own WFQ admission
    controller + idle dispatch-worker deque + alive flag.  Stateless
    beyond its queues — any front serves any request, which is what
    makes killing one a pure re-queue event."""

    __slots__ = ("idx", "admission", "idle", "dead")

    def __init__(self, idx: int, admission: AdmissionController):
        self.idx = idx
        self.admission = admission
        self.idle: deque = deque()
        self.dead = False


class FleetSim:
    """One simulated fleet: the real control plane wired to virtual
    replicas.  Also implements the dynamic-fleet surface
    (``targets`` / ``bounds`` / ``launch_replica`` / ``kill_replica``
    / ``tier_actual`` / ``scale_lock`` / ``request_migration``) so the
    REAL :class:`FleetAutoscaler` actuates simulated capacity."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.log = get_logger("tfmesos_tpu_torch.fleet.sim")
        eng = self.engine = SimEngine(cfg.seed)
        self.metrics = FleetMetrics()
        self.registry = ReplicaRegistry(
            clock=eng.clock, suspect_after=cfg.suspect_after,
            dead_after=cfg.dead_after, evict_after=cfg.evict_after,
            sweep_interval=cfg.sweep_interval, metrics=self.metrics)
        self.transport = SimTransport(eng)
        specs = [PriorityClass(c[0], weight=c[1], rank=c[2],
                               batch=bool(c[3]) if len(c) > 3 else False)
                 for c in cfg.classes]
        if cfg.batch_lane and not any(s.batch for s in specs):
            # The offline lane (mirrors FleetServer's --batch-lane):
            # a deadline-less batch class ranked below everything.
            floor = min(s.rank for s in specs) if specs else 0
            specs.append(PriorityClass("batch", weight=1.0,
                                       rank=floor - 1, batch=True))
        self._batch_cls = {s.name for s in specs if s.batch}
        self._batch_busy = 0
        # Front doors: N stateless gateways over the one registry/
        # router view (`tfserve --gateways N`).  Each gets its own
        # AdmissionController (its WFQ queues) + idle-worker deque;
        # specs are immutable and shared (WFQ state lives in the
        # controller).  ``self.admission`` stays the FIRST front's
        # controller — the single-gateway back-compat alias every
        # existing scenario and test drives.
        self.fronts: List[_SimFront] = []
        for i in range(max(1, int(cfg.gateways))):
            adm = AdmissionController(
                max_queue=cfg.max_queue, rate=cfg.rate_limit,
                classes=specs, clock=eng.clock)
            adm.on_expired = self._queue_expired
            self.fronts.append(_SimFront(i, adm))
        self.admission = self.fronts[0].admission
        self._rr = 0                # round-robin arrival spread
        self.gateway_failovers = 0  # items replayed off a killed front
        self.budget = RetryBudget(cfg.budget_max_tokens,
                                  cfg.budget_token_ratio)
        self.router = Router(
            self.registry, self.metrics, max_retries=cfg.max_retries,
            backoff_s=cfg.backoff_s, request_timeout=cfg.request_timeout,
            rng=random.Random(cfg.seed + 1), breakers=cfg.breakers,
            breaker_config=cfg.breaker, retry_budget=self.budget,
            clock=eng.clock, sleep=eng.sleep,
            link_factory=self.transport.link)
        # Dynamic-fleet surface for the real autoscaler / trader.
        self.targets: Dict[str, int] = {}
        self.scale_lock = threading.RLock()
        self.autoscaler: Optional[FleetAutoscaler] = None
        self.replica_budget: Optional[int] = None
        self.trajectory: List[dict] = []
        # Bookkeeping.  ``planned`` is the number of requests the
        # scenario intends to submit — the completion predicate
        # (``drained``) compares against it, never against ``injected``
        # (a closed-loop feeder between iterations would otherwise
        # read as "all done" and end the run early).
        self.planned = 0
        self.injected = 0
        self.finished = 0
        self.completed = 0
        self.shed = 0
        self.deadline_errors = 0
        self.expired_in_queue = 0
        self.conformance_violations = 0
        self.lost: List[BaseException] = []
        self._eps_s = 0.005
        self._next_rid = 0
        self._stopped = False
        # Hot-path histogram handles (one dict lookup per request
        # instead of name formatting + registry locks at 1M-request
        # scale); results() still reads them by name.
        self._h_queue_wait = self.metrics.hist("queue_wait_ms")
        self._h_ttft = self.metrics.hist("ttft_ms")
        self._h_latency = self.metrics.hist("latency_ms")
        self._cls_hist = {
            s.name: (self.metrics.hist(f"queue_wait_ms_{s.name}"),
                     self.metrics.hist(f"latency_ms_{s.name}"),
                     f"latency_ms_{s.name}")
            for s in specs}
        self._prompts: Dict[int, tuple] = {}
        # Heartbeat sharding (cfg.hb_shards): None = one timer event
        # per replica per beat; else N shard lists, each driven by one
        # self-rescheduling event that beats every live member.
        n_sh = max(0, int(cfg.hb_shards))
        self._hb_shards: Optional[List[List[SimReplica]]] = (
            [[] for _ in range(n_sh)] if n_sh else None)
        self._hb_live = [False] * n_sh
        # The liveness sweep is always on; heartbeats are per-replica.
        self._schedule_sweep()

    # -- replica lifecycle -------------------------------------------------

    def add_replica(self, role: str = UNIFIED,
                    capacity: Optional[int] = None,
                    model: Optional[ReplicaModel] = None,
                    weights_version: Optional[str] = None,
                    warm_s: float = 0.0, model_id: str = "",
                    pool: bool = False,
                    gang_size: Optional[int] = None) -> SimReplica:
        self._next_rid += 1
        i = self._next_rid
        size = self.cfg.gang_size if gang_size is None else int(gang_size)
        base = model or self.cfg.model
        if size > 1:
            base = gang_model(base, size, self.cfg.gang_efficiency)
        rep = SimReplica(
            addr=f"sim-{role[:3]}-{i}", role=role,
            capacity=capacity if capacity is not None else self.cfg.capacity,
            model=base,
            weights_version=weights_version or self.cfg.weights_version,
            node=f"sim:{i}", kv_pages=self.cfg.kv_pages,
            warm_until=self.engine.clock.now + warm_s,
            model_id=model_id, pool=pool, gang_size=size)
        self.transport.replicas[rep.addr] = rep
        if self._hb_shards is not None:
            # Sharded beats: register NOW (scenarios wait on the
            # registry seeing the replica), then join a shard whose
            # one event beats every member each interval.
            if not rep.drop_beats:
                self._send_beat(rep)
            idx = i % len(self._hb_shards)
            self._hb_shards[idx].append(rep)
            if not self._hb_live[idx]:
                self._hb_live[idx] = True
                self.engine.after(self.cfg.hb_interval,
                                  lambda: self._shard_beat(idx))
        else:
            self._beat(rep)
        return rep

    def _beat(self, rep: SimReplica) -> None:
        if rep.removed or rep.down or self._stopped:
            return      # a dead replica stops beating; the sweep notices
        if not rep.drop_beats:
            self._send_beat(rep)
        self.engine.after(self.cfg.hb_interval, lambda: self._beat(rep))

    def _shard_beat(self, idx: int) -> None:
        if self._stopped:
            return
        shard = [r for r in self._hb_shards[idx]
                 if not r.removed and not r.down]
        self._hb_shards[idx] = shard
        if not shard:
            self._hb_live[idx] = False
            return      # re-armed when the shard gains a replica
        for rep in shard:
            if not rep.drop_beats:
                self._send_beat(rep)
        # Logical-event accounting: this ONE heap pop carried
        # len(shard) beats that per-replica mode pops individually —
        # credit them so ``sim_events_per_sec`` means the same thing
        # at every ``hb_shards`` setting.
        self.engine.events += len(shard) - 1
        self.engine.after(self.cfg.hb_interval,
                          lambda: self._shard_beat(idx))

    def _send_beat(self, rep: SimReplica) -> None:
        now = self.engine.clock.now
        msg: Dict[str, Any] = {
            "op": "heartbeat", "addr": rep.addr,
            "capacity": rep.capacity,
            "outstanding": rep.outstanding(now), "role": rep.role,
            "node": rep.node,
            "weights_version": rep.weights_version, "gen": rep.gen}
        if rep.model_id:
            msg["model_id"] = rep.model_id
        if rep.pool or rep.model_id:
            # Like the real replica: pool-capable processes always
            # send the flag, so an adoption's False overwrites.
            msg["warm_pool"] = rep.pool
        if rep.gang_size > 1:
            # The leader-only gang beat field the real registry
            # parses into ReplicaInfo.gang_* / gang_summary().
            msg["gang"] = {"id": f"sim/{rep.node}",
                           "size": rep.gang_size,
                           "live": rep.gang_live,
                           "coord": rep.addr}
        if rep.role == DECODE:
            msg["kv_headroom"] = max(
                0, rep.kv_pages - rep.outstanding(now))
        if now < rep.warm_until:
            msg["status"] = WARMING
        self.registry.observe(msg)

    def kill(self, rep: SimReplica) -> None:
        """Hard death (the SIGKILL analog): beats stop, in-flight
        calls fail with :class:`ConnectionLost` now, the registry
        notices through the router's mark_dead or the sweep."""
        rep.down = True
        self.transport.fail_pending(rep)

    def kill_gang_member(self, rep: SimReplica) -> Optional[SimReplica]:
        """SIGKILL one MEMBER of a gang replica: the gang dies whole
        (the leader tears down; pending calls fail now and replay on
        survivors), and the fleet re-forms it — a fresh gang, fresh
        rendezvous, re-warm — after ``cfg.gang_reform_s``.  Returns
        the dying replica (the re-formed one appears asynchronously)."""
        if rep.gang_size <= 1 or rep.down or rep.removed:
            return None
        rep.gang_live = rep.gang_size - 1
        self.kill(rep)
        rep.removed = True
        self.metrics.inc("gang_deaths")
        role, size = rep.role, rep.gang_size
        wv, mid = rep.weights_version, rep.model_id

        def reform() -> None:
            if self._stopped:
                return
            self.add_replica(role=role, gang_size=size,
                             warm_s=self.cfg.warmup_s,
                             weights_version=wv, model_id=mid)
            self.metrics.inc("gang_reforms")

        self.engine.after(self.cfg.gang_reform_s, reform)
        return rep

    def _schedule_sweep(self) -> None:
        if self._stopped:
            return
        self.registry.sweep()
        self.engine.after(self.cfg.sweep_interval, self._schedule_sweep)

    # -- the dynamic-fleet surface (real FleetAutoscaler actuates it) ------

    def set_target(self, role: str, n: int) -> None:
        self.targets[role] = int(n)
        self.registry.set_target(role, int(n))

    def bounds(self, role: str) -> Tuple[int, int]:
        return (self.cfg.min_replicas, self.cfg.max_replicas)

    def launch_replica(self, key: str,
                       weights_version: Optional[str] = None) -> str:
        model, role = split_key(key)
        rep = self.add_replica(role=role, warm_s=self.cfg.warmup_s,
                               weights_version=weights_version,
                               model_id=(model if model not in
                                         (None, POOL) else ""),
                               pool=model == POOL)
        return rep.node

    def kill_replica(self, node: str) -> bool:
        for rep in self.transport.replicas.values():
            if rep.node == node and not rep.removed:
                self.kill(rep)
                rep.removed = True
                return True
        return False

    def tier_actual(self, key: str) -> int:
        model, role = split_key(key)
        out = 0
        for r in self.transport.replicas.values():
            if r.down or r.removed or (r.role or UNIFIED) != role:
                continue
            if model == POOL:
                out += 1 if r.pool else 0
            elif model is not None:
                out += 1 if r.model_id == model else 0
            else:
                out += 1
        return out

    def tier_members(self, key: str):
        from tfmesos_tpu_torch.fleet.catalog import filter_members
        model, role = split_key(key)
        return filter_members(self.registry.members(role), key)

    def adopt_replica(self, addr: str, model_id: str) -> bool:
        """The sim's warm-pool adoption: flip the replica's model
        identity (the real path installs weights — here it is
        instantaneous) and inject one immediate beat so routing views
        follow without waiting a heartbeat interval."""
        rep = self.transport.replicas.get(addr)
        if rep is None or rep.down or rep.removed or not rep.pool:
            return False
        rep.model_id = model_id
        rep.pool = False
        self.registry.observe({
            "op": "heartbeat", "addr": rep.addr,
            "capacity": rep.capacity,
            "outstanding": rep.outstanding(self.engine.clock.now),
            "role": rep.role, "node": rep.node,
            "weights_version": rep.weights_version, "gen": rep.gen,
            "model_id": model_id, "warm_pool": False})
        self.metrics.inc("sim_adoptions")
        return True

    def request_migration(self, addr: str) -> None:
        rep = self.transport.replicas.get(addr)
        if rep is not None:
            rep.migrating = True
            self.transport.suspend_pending(rep)

    def enable_autoscaler(self) -> FleetAutoscaler:
        """Attach the REAL autoscaler (its default registry+metrics
        signal source) and schedule its ticks on the virtual clock."""
        self.autoscaler = FleetAutoscaler(self, self.cfg.autoscaler,
                                          clock=self.engine.clock)
        self._auto_tick()
        return self.autoscaler

    def enable_trader(self, catalog: ModelCatalog) -> ModelTrader:
        """Attach the REAL model trader (the per-(model, tier)
        generalization of the autoscaler) on the virtual clock, wire
        the router's cold-start demand hook to it, and schedule its
        ticks — the multi-model scenario's control plane."""
        self.replica_budget = self.cfg.model_budget
        trader = ModelTrader(self, catalog, self.cfg.autoscaler,
                             trader_config=self.cfg.trader,
                             clock=self.engine.clock)
        self.autoscaler = trader
        self.router.on_model_demand = trader.demand
        self._auto_tick()
        return trader

    def _auto_tick(self) -> None:
        if self._stopped or self.autoscaler is None:
            return
        self.autoscaler.step()
        desc = self.autoscaler.describe()
        self.trajectory.append(
            {"t": round(self.engine.clock.now, 3),
             **{role: {"target": d["target"], "actual": d["actual"],
                       "alive": d["alive"]}
                for role, d in desc.items()}})
        if len(self.trajectory) > 10000:
            del self.trajectory[:5000]
        self.engine.after(self.cfg.autoscaler.interval, self._auto_tick)

    # -- traffic -----------------------------------------------------------

    def _prompt(self, n: int) -> tuple:
        p = self._prompts.get(n)
        if p is None:
            p = self._prompts[n] = tuple(range(n))
        return p

    def _build(self, req: Request) -> tuple:
        """The gateway-receipt analog: resolve the class, stamp the
        absolute deadline, build the forward dict."""
        spec = self.admission.resolve(req.cls)
        now = self.engine.clock.now
        deadline = None
        msg: Dict[str, Any] = {
            "op": "generate", "prompt": self._prompt(req.prompt_len),
            "max_new_tokens": req.new_tokens, "stop_token": None,
            "priority": spec.rank}
        if getattr(spec, "batch", False):
            # Mirrors the gateway: the router prefers replicas with
            # free slots for batch-lane work.
            msg["_background"] = True
        if getattr(req, "session", None):
            msg["session"] = req.session
        if getattr(req, "model", None):
            msg["_model"] = req.model
        if req.deadline_ms is not None and req.deadline_ms > 0:
            deadline = now + req.deadline_ms / 1000.0
            msg["deadline"] = deadline
        return msg, spec, now, deadline

    def _pick_front(self, front) -> Optional["_SimFront"]:
        """The front door this arrival dials: an explicit index, or
        round-robin over the LIVE fronts (clients spreading
        connections); None when every front is dead."""
        if front is not None:
            f = self.fronts[front % len(self.fronts)]
            return None if f.dead else f
        n = len(self.fronts)
        for _ in range(n):
            f = self.fronts[self._rr % n]
            self._rr += 1
            if not f.dead:
                return f
        return None

    def submit(self, req: Request, sink: Optional[list] = None,
               front=None) -> bool:
        """Admit one request (shed bookkeeping mirrors the gateway);
        truthy (the front served) when admitted.  ``sink``, when
        given, receives ``(reply, end_time)`` at completion — how a
        caller observes its OWN request's outcome even when a
        different fiber dispatches it.  ``front`` pins a specific
        gateway; default spreads round-robin over live fronts."""
        f = self._pick_front(front)
        msg, spec, now, deadline = self._build(req)
        self.injected += 1
        m = self.metrics
        m.inc("received")
        if f is None:
            # Every front door is dead: the client's dial fails — an
            # explicit connection error, never a hang.
            m.inc("failed")
            self.shed += 1
            self.finished += 1
            return False
        item = (msg, spec.name, now, deadline, sink)
        try:
            f.admission.admit(item, cls=spec.name, deadline=deadline)
        except DeadlineExceeded:
            m.inc("shed_deadline")
            self.shed += 1
            self.finished += 1
            return False
        except RateLimited:
            m.inc("shed_rate_limited")
            self.shed += 1
            self.finished += 1
            return False
        except Overloaded:
            m.inc("shed_queue")
            m.inc(f"shed_queue_{spec.name}")
            self.shed += 1
            self.finished += 1
            return False
        m.inc("admitted")
        return f

    def _inject(self, req: Request) -> None:
        """Engine-context arrival: admit, then hand work to an idle
        dispatch worker of the front that took it."""
        f = self.submit(req)
        if f and f.idle:
            self.engine._resume(f.idle.popleft())

    def _queue_expired(self, item: tuple) -> None:
        """A queued request's deadline passed before dispatch — the
        explicit-answer path (mirrors Gateway._queue_expired)."""
        _, cls, _, _, sink = item
        self.metrics.inc("shed_deadline")
        self.metrics.inc("failed")
        self.expired_in_queue += 1
        self.finished += 1
        if sink is not None:
            sink.append(({"op": "error", "kind": "deadline_exceeded"},
                         self.engine.clock.now))

    def _batch_cap(self) -> int:
        """Concurrent batch-lane dispatches the budget split allows:
        ``batch_slot_frac`` of the live fleet's aggregate slots — the
        sim analog of batch rows taking only idle decode slots and
        leftover tick budget (docs/SERVING.md "Offline lane")."""
        total = sum(r.capacity for r in self.transport.replicas.values()
                    if not (r.down or r.removed))
        return max(1, int(self.cfg.batch_slot_frac * total))

    def _requeue_batch(self, item: tuple) -> None:
        """Re-admit a budget-deferred batch item (engine context); a
        front at its bound sheds it explicitly, never silently."""
        _, cls, _, deadline, sink = item
        f = self._pick_front(None)
        if f is None:
            self.metrics.inc("failed")
            self.shed += 1
            self.finished += 1
            return
        try:
            f.admission.admit(item, cls=cls, deadline=deadline)
        except (Overloaded, DeadlineExceeded):
            self.metrics.inc("shed_queue")
            self.shed += 1
            self.finished += 1
            if sink is not None:
                sink.append(({"op": "error", "kind": "overloaded"},
                             self.engine.clock.now))
            return
        if f.idle:
            self.engine._resume(f.idle.popleft())

    def dispatch(self, item: tuple) -> Any:
        """Fiber-context: one request through the real router, with
        the gateway worker's metric bookkeeping."""
        msg, cls, t_enq, deadline, sink = item
        eng = self.engine
        m = self.metrics
        is_batch = cls in self._batch_cls
        if is_batch and self._batch_busy >= self._batch_cap():
            # The lane is at its slot split: requeue shortly and free
            # this worker for interactive items NOW — a parked batch
            # item must never hold a dispatcher an interactive
            # arrival needs (the preemption analog at the front).
            m.inc("batch_deferrals")
            eng.after(0.01, lambda: self._requeue_batch(item))
            return None
        cls_h = self._cls_hist.get(cls)
        wait_ms = (eng.clock.now - t_enq) * 1000.0
        self._h_queue_wait.observe(wait_ms)
        if cls_h is not None:
            cls_h[0].observe(wait_ms)
        mlabel = msg.get("_model")
        if mlabel:
            # The per-model queue-wait histogram — the trader's
            # relative-pressure signal, same as the real gateway's.
            m.hist(f"queue_wait_ms_model_{mlabel}").observe(wait_ms)
        if is_batch:
            self._batch_busy += 1
        try:
            reply = self.router.route(msg)
        except Exception as e:  # noqa: BLE001 - every loss recorded
            m.inc("failed")
            self.lost.append(e)
            self.finished += 1
            if sink is not None:
                sink.append((None, eng.clock.now))
            return None
        finally:
            if is_batch:
                self._batch_busy -= 1
        end = eng.clock.now
        if isinstance(reply, dict) and reply.get("op") == "completion":
            m.inc("completed")
            m.inc("tokens_out", int(reply.get("n_tokens") or 0))
            lat_ms = (end - t_enq) * 1000.0
            self._h_ttft.observe(reply.get("ttft_ms") or 0.0)
            self._h_latency.observe(lat_ms)
            if cls_h is not None:
                cls_h[1].observe(lat_ms)
            self.completed += 1
            if deadline is not None and end > deadline + self._eps_s:
                self.conformance_violations += 1
        else:
            m.inc("failed")
            kind = reply.get("kind") if isinstance(reply, dict) else None
            if kind == "deadline_exceeded":
                m.inc("deadline_exceeded")
                self.deadline_errors += 1
                if deadline is not None \
                        and end > deadline + self._eps_s:
                    self.conformance_violations += 1
            else:
                self.lost.append(RuntimeError(f"error reply: {reply!r}"))
        self.finished += 1
        if sink is not None:
            sink.append((reply, end))
        return reply

    def start_workers(self, n: Optional[int] = None) -> None:
        """The dispatch pool (the gateway's worker-thread analog):
        PER-FRONT fibers that drain that front's WFQ queue and park
        when it empties."""
        per = n if n is not None else self.cfg.workers
        for f in self.fronts:
            for i in range(per):
                self.engine.spawn(
                    lambda f=f: self._worker_body(f),
                    name=f"sim-gw{f.idx}-worker-{i}"
                    if len(self.fronts) > 1 else f"sim-worker-{i}")

    def _worker_body(self, front: Optional["_SimFront"] = None) -> None:
        front = front or self.fronts[0]
        eng = self.engine
        while True:
            if front.dead:
                eng.park()          # a killed gateway's pool is gone
                continue
            item = front.admission.get(timeout=0)
            if item is None:
                front.idle.append(eng._current)
                eng.park()
                continue
            self.dispatch(item)

    def kill_gateway(self, idx: int) -> int:
        """Hard-kill one front door mid-traffic (the bench's gateway
        SIGKILL analog): its dispatch pool stops, and every item still
        QUEUED there is re-admitted on a surviving front — the
        client-failover replay (idempotent requests, nothing was
        delivered).  Returns how many items failed over.  Re-admission
        sheds (a survivor at its bound) surface as explicit
        ``overloaded`` answers, never silent losses."""
        f = self.fronts[idx % len(self.fronts)]
        if f.dead:
            return 0
        f.dead = True
        moved = 0
        while True:
            item = f.admission.get(timeout=0)
            if item is None:
                break
            msg, cls, t_enq, deadline, sink = item
            target = self._pick_front(None)
            if target is None:
                self.metrics.inc("failed")
                self.shed += 1
                self.finished += 1
                continue
            try:
                target.admission.admit(item, cls=cls, deadline=deadline)
            except (Overloaded, DeadlineExceeded):
                self.metrics.inc("shed_queue")
                self.shed += 1
                self.finished += 1
                continue
            moved += 1
            if target.idle:
                self.engine._resume(target.idle.popleft())
        self.gateway_failovers += moved
        self.metrics.inc("gateway_failovers", moved)
        self.log.info("gateway %d killed; %d queued item(s) failed "
                      "over", idx, moved)
        return moved

    def feed(self, workload) -> None:
        """Schedule an open-arrival workload (lazily: one pending
        arrival event at a time, so a million-request stream never
        materializes in memory)."""
        n = getattr(workload, "n_requests", None)
        if n is None:
            try:
                n = len(workload)
            except TypeError:
                raise ValueError(
                    "open workloads need a known size (n_requests or "
                    "__len__) for the completion predicate") from None
        self.planned += int(n)
        it = iter(workload)

        def chain() -> None:
            req = next(it, None)
            if req is None:
                return
            self.engine.at(req.at, lambda: (self._inject(req), chain()))

        first = next(it, None)
        if first is not None:
            self.engine.at(first.at,
                           lambda: (self._inject(first), chain()))
        else:
            self.planned -= int(n)

    def spawn_feeder(self, reqs, record: Optional[list] = None,
                     stop: Optional[Callable[[], bool]] = None) -> None:
        """Closed-loop feeder fiber over a request LIST: submit one,
        then serve one WFQ-dispatched item (its own or a peer's — net
        flow conserved, WFQ order preserved), like the soak bench's
        client threads."""
        reqs = list(reqs)
        self.planned += len(reqs)

        def body() -> None:
            done = 0
            for req in reqs:
                if stop is not None and stop():
                    break
                t0 = self.engine.clock.now
                done += 1
                # Closed-loop feeders serve what they submit: pin to
                # front 0 so net flow stays conserved per queue.
                if not self.submit(req, front=0):
                    continue
                item = self.admission.get(timeout=0)
                if item is None:
                    continue        # another fiber raced it away
                self.dispatch(item)
                if record is not None:
                    record.append(
                        (self.engine.clock.now - t0) * 1000.0)
            self.planned -= len(reqs) - done

        self.engine.spawn(body, name="sim-feeder")

    # -- lifecycle / results -----------------------------------------------

    def drained(self) -> bool:
        """Every PLANNED request answered (completion, shed, or
        explicit error) — the scenario completion predicate."""
        return self.planned > 0 and self.finished >= self.planned

    def stop(self) -> None:
        self._stopped = True
        self.engine.stop_fibers()

    def results(self, wall_s: float) -> Dict[str, Any]:
        m = self.metrics
        completed = max(1, m.get("completed"))
        out: Dict[str, Any] = {
            "sim_seconds": round(self.engine.clock.now, 3),
            "events": self.engine.events,
            "sim_events_per_sec": round(
                self.engine.events / max(1e-9, wall_s), 1),
            "sim_replicas_per_wallclock_sec": round(
                len(self.transport.replicas) * self.engine.clock.now
                / max(1e-9, wall_s), 1),
            "wall_s": round(wall_s, 3),
            "requests": self.injected,
            "completed": m.get("completed"),
            "failed": m.get("failed"),
            "lost": len(self.lost),
            "retries": m.get("retries"),
            "retry_amplification": round(
                (m.get("completed") + m.get("retries")) / completed, 4),
            "deadline_errors": self.deadline_errors,
            "conformance_violations": self.conformance_violations,
            "shed": self.admission.shed_counts(),
            "breakers": self.router.breaker_summary(),
            "retry_budget": self.router.retry_budget_level(),
            "classes": {},
        }
        # Fleet utilization: slot-seconds served over slot-seconds
        # offered (static-fleet gauge; a replica's whole lifetime
        # counts as offered — the offline lane's win is THIS number
        # rising while interactive latency holds).
        span = self.engine.clock.now
        offered = sum(r.capacity for r in self.transport.replicas.values()
                      if not r.removed) * span
        if offered > 0:
            busy = sum(r.busy_s for r in self.transport.replicas.values())
            out["utilization"] = round(min(1.0, busy / offered), 4)
        if self._batch_cls:
            out["batch_deferrals"] = m.get("batch_deferrals")
        for name, (_, _, lat_name) in self._cls_hist.items():
            cur = m.hist_cumulative(lat_name)
            if cur is None:
                continue
            out["classes"][name] = {
                "count": cur[2],
                "p50_ms": m.percentile(lat_name, 0.50),
                "p90_ms": m.percentile(lat_name, 0.90),
                "p99_ms": m.percentile(lat_name, 0.99),
            }
        qw = m.hist_cumulative("queue_wait_ms")
        if qw is not None:
            out["queue_wait_p99_ms"] = m.percentile("queue_wait_ms", 0.99)
        if self.trajectory:
            out["autoscaler_trajectory"] = list(self.trajectory)
        return out


# -- scenarios ---------------------------------------------------------------


def _new_cfg(base: Optional[SimConfig], overrides) -> SimConfig:
    cfg = dataclasses.replace(base) if base is not None else SimConfig()
    # dataclasses.replace shares the nested mutable configs: deep-copy
    # them so a sweep's override never leaks into its siblings.
    cfg.model = dataclasses.replace(cfg.model)
    cfg.breaker = dataclasses.replace(cfg.breaker)
    cfg.autoscaler = dataclasses.replace(cfg.autoscaler)
    cfg.trader = dataclasses.replace(cfg.trader)
    for path, value in overrides or ():
        apply_override(cfg, path, value)
    return cfg


def scenario_steady(overrides=(), n_requests: int = 4000,
                    replicas: Optional[int] = None,
                    rate: Optional[float] = None,
                    seed: Optional[int] = None,
                    workload=None, model_fit: Optional[dict] = None,
                    cfg: Optional[SimConfig] = None) -> Dict[str, Any]:
    """Steady-state open arrivals against a fixed unified tier: the
    capacity-planning baseline (per-class latency percentiles and shed
    rates at a given replica count and arrival rate)."""
    cfg = _new_cfg(cfg, overrides)
    if replicas is not None:
        cfg.replicas = int(replicas)
    if seed is not None:
        cfg.seed = int(seed)
    if model_fit:
        for k, v in model_fit.items():
            if hasattr(cfg.model, k):
                setattr(cfg.model, k, v)
    # The dispatch pool must not be the bottleneck the scenario
    # measures — size it to cover the fleet's concurrency.
    cfg.workers = max(cfg.workers,
                      min(256, 2 * cfg.replicas * cfg.capacity))
    sim = FleetSim(cfg)
    for _ in range(cfg.replicas):
        sim.add_replica(UNIFIED)
    for _ in range(cfg.prefill_replicas):
        sim.add_replica(PREFILL)
    for _ in range(cfg.decode_replicas):
        sim.add_replica(DECODE)
    if workload is None:
        _, per_req_s = cfg.model.service_s(64, 16, random.Random(0))
        fleet_rate = cfg.replicas * cfg.capacity / max(1e-9, per_req_s)
        workload = SyntheticWorkload(
            n_requests=n_requests, seed=cfg.seed,
            rate=rate if rate is not None else 0.7 * fleet_rate,
            class_mix={"interactive": 1.0, "background": 2.0},
            prompt_len=64, new_tokens=16)
    sim.feed(workload)
    sim.start_workers()
    t0 = time.perf_counter()
    sim.engine.run(stop=sim.drained)
    wall = time.perf_counter() - t0
    out = sim.results(wall)
    sim.stop()
    return out


def scenario_surge(overrides=(), n_requests: int = 6000,
                   replicas: Optional[int] = None,
                   seed: Optional[int] = None,
                   workload=None, model_fit: Optional[dict] = None,
                   cfg: Optional[SimConfig] = None) -> Dict[str, Any]:
    """A 4x arrival-rate step against an autoscaled tier: reports the
    autoscaler trajectory (tick-by-tick target/actual/alive) — the
    hysteresis-tuning scenario (``--sweep autoscaler.queue_wait_hi_ms=
    200,500,2000``)."""
    cfg = _new_cfg(cfg, overrides)
    if replicas is not None:
        cfg.replicas = int(replicas)
    if seed is not None:
        cfg.seed = int(seed)
    if model_fit:
        for k, v in model_fit.items():
            if hasattr(cfg.model, k):
                setattr(cfg.model, k, v)
    cfg.autoscale = True
    # Workers cover the scaled-out fleet so added replicas actually
    # relieve the queue (the pool is the gateway-dispatcher analog).
    cfg.workers = max(cfg.workers,
                      min(256, 2 * cfg.max_replicas * cfg.capacity))
    sim = FleetSim(cfg)
    for _ in range(cfg.replicas):
        sim.add_replica(UNIFIED)
    sim.set_target(UNIFIED, cfg.replicas)
    sim.enable_autoscaler()
    _, per_req_s = cfg.model.service_s(64, 16, random.Random(0))
    base_rate = 0.5 * cfg.replicas * cfg.capacity / max(1e-9, per_req_s)
    if workload is None:
        calm = SyntheticWorkload(
            n_requests=n_requests // 3, seed=cfg.seed, rate=base_rate,
            class_mix={"interactive": 1.0, "background": 1.0})
        surge_start = max(r.at for r in calm) if n_requests >= 3 else 0.0
        surge = SyntheticWorkload(
            n_requests=n_requests - n_requests // 3, seed=cfg.seed + 1,
            rate=4.0 * base_rate,
            class_mix={"interactive": 1.0, "background": 1.0},
            start_at=surge_start)
        sim.feed(calm)
        sim.feed(surge)
    else:
        sim.feed(workload)
    sim.start_workers()
    t0 = time.perf_counter()
    sim.engine.run(stop=sim.drained)
    wall = time.perf_counter() - t0
    out = sim.results(wall)
    out["autoscaled_to"] = sim.tier_actual(UNIFIED)
    sim.stop()
    return out


def scenario_soak_replay(overrides=(), n_per_feeder: int = 120,
                         seed: Optional[int] = None,
                         replicas: Optional[int] = None,
                         workload=None, model_fit: Optional[dict] = None,
                         cfg: Optional[SimConfig] = None
                         ) -> Dict[str, Any]:
    """THE FIDELITY GATE: the seeded ``bench_fleet_soak`` chaos
    timeline replayed through the real control plane on the virtual
    clock — a gray-slow replica under two-class deadline-carrying
    traffic, short-deadline probes, a hard kill + real-autoscaler
    self-heal, a one-shot link sever, and a blue-green rollout.  The
    qualitative contract (asserted in tier-1, tests/test_sim.py):

    * the slow replica is breaker-isolated (``latency_outlier``) while
      the registry still reports it ALIVE — the gray failure;
    * zero lost requests across kill, sever, and rollout;
    * retry amplification <= 1.5;
    * deadline probes answer ``deadline_exceeded`` at ~their deadline.
    """
    cfg = _new_cfg(cfg, overrides)
    if seed is not None:
        cfg.seed = int(seed)
    cfg.replicas = int(replicas) if replicas is not None else 3
    cfg.capacity = 2
    cfg.workers = 0                     # closed-loop feeders dispatch
    if model_fit:
        for k, v in model_fit.items():
            if hasattr(cfg.model, k):
                setattr(cfg.model, k, v)
    # The soak's shape at sim scale: ~10ms services, a 25x-gray victim
    # (the bench's 0.25s slow_task against CPU-replica ~10ms decodes),
    # liveness clocks as shipped so the kill is detected by heartbeat
    # loss exactly like the bench.
    cfg.model = dataclasses.replace(cfg.model, jitter=cfg.model.jitter
                                    or 0.05)
    sim = FleetSim(cfg)
    eng = sim.engine
    reps = [sim.add_replica(UNIFIED) for _ in range(cfg.replicas)]
    victim = min(reps, key=lambda r: r.addr)
    victim.slow_factor = 25.0
    sim.set_target(UNIFIED, cfg.replicas)

    stop_flag = [False]
    walls: List[float] = []
    for cls, toks in (("interactive", 2), ("interactive", 2),
                      ("background", 8)):
        reqs = [Request(at=0.0, cls=cls, prompt_len=8, new_tokens=toks,
                        deadline_ms=120000.0)
                for _ in range(n_per_feeder)]
        sim.spawn_feeder(reqs, record=walls if cls == "interactive"
                         else None, stop=lambda: stop_flag[0])

    t0 = time.perf_counter()
    # Phase A — gray failure: run until the victim's breaker opens
    # (breakers on), or for a fixed traffic window (the CONTROL arm —
    # breakers disabled, the victim keeps serving 25x slow and the
    # interactive percentiles show it).
    breakers = sim.router.breakers
    if breakers is not None:
        eng.run(until=300.0,
                stop=lambda: victim.addr in breakers.open_addrs())
        victim_isolated = victim.addr in breakers.open_addrs()
        victim_trip_reason = breakers.describe().get(
            victim.addr, {}).get("reason", "")
    else:
        eng.run(until=eng.clock.now + 3.0)
        victim_isolated = False
        victim_trip_reason = ""
    victim_alive = victim.addr in [
        r.addr for r in sim.registry.alive()]

    # Deadline probes: long decodes against a far-too-short deadline
    # must answer deadline_exceeded at ~the deadline (in-batcher
    # cancel / router fail-fast), never a late completion.  Each probe
    # observes its OWN outcome through the item sink — under WFQ a
    # feeder may be the fiber that actually dispatches it.
    probe_outcomes: List[str] = []

    def probe_body() -> None:
        for _ in range(4):
            req = Request(at=0.0, cls="interactive", prompt_len=8,
                          new_tokens=400, deadline_ms=60.0)
            sink: list = []
            t_probe = eng.clock.now
            if not sim.submit(req, sink=sink):
                probe_outcomes.append("shed")
                continue
            while not sink:
                item = sim.admission.get(timeout=0)
                if item is not None:
                    sim.dispatch(item)
                else:
                    eng.sleep(0.002)
            reply, end = sink[0]
            kind = reply.get("kind") if isinstance(reply, dict) else None
            late = end > t_probe + 0.060 + 0.015
            probe_outcomes.append(
                "ok" if kind == "deadline_exceeded" and not late
                else f"violation:{kind}:{late}")

    eng.spawn(probe_body, name="sim-probe")
    eng.run(until=eng.clock.now + 10.0,
            stop=lambda: len(probe_outcomes) >= 4)

    # Phase B — hard churn: SIGKILL a healthy replica whole, then
    # hand-stepped REAL-autoscaler ticks with calm signals relaunch it
    # (crash self-heal through the warming state) — the exact shape of
    # the bench's phase B.
    doomed = next(r for r in reps if r is not victim and not r.down)
    sim.kill(doomed)
    calm = {"queue_wait_p99_ms": 0.0, "util": 0.5, "kv_headroom": None}
    auto = FleetAutoscaler(
        sim, dataclasses.replace(cfg.autoscaler, scale_up_cooldown=0.0,
                                 scale_down_cooldown=0.0),
        signals=lambda: {UNIFIED: dict(calm)}, clock=eng.clock)
    heal_deadline = eng.clock.now + 120.0
    while (sim.tier_actual(UNIFIED) < cfg.replicas
           or len(sim.registry.alive()) < cfg.replicas) \
            and eng.clock.now < heal_deadline:
        auto.step()
        eng.run(until=eng.clock.now + 0.1)
    healed = sim.tier_actual(UNIFIED) >= cfg.replicas \
        and len(sim.registry.alive()) >= cfg.replicas

    # One-shot link sever against a healthy replica: the router drops
    # the link and retries; the next beat revives the entry.
    other = next(r for r in sim.transport.replicas.values()
                 if not r.down and r is not victim)
    other.sever_next = 1

    # Phase C — blue-green rollout under the same traffic: v2 tier up
    # (warming -> alive), preference shift, drain-migrate-kill of v1.
    v1 = [r for r in sim.transport.replicas.values() if not r.down]
    v2 = [sim.add_replica(UNIFIED, weights_version="v2",
                          warm_s=cfg.warmup_s) for _ in range(3)]
    eng.run(until=eng.clock.now + 30.0,
            stop=lambda: sum(
                1 for r in sim.registry.alive()
                if r.weights_version == "v2") >= len(v2))
    sim.router.set_preferred_version("v2")
    for r in v1:
        sim.registry.begin_drain(r.addr, pinned=True)
        sim.request_migration(r.addr)
    eng.run(until=eng.clock.now + 2.0)
    for r in v1:
        if not r.down:
            sim.kill(r)

    # Drain the feeders to completion.
    eng.run(until=eng.clock.now + 600.0, stop=sim.drained)
    stop_flag[0] = True
    wall = time.perf_counter() - t0

    out = sim.results(wall)
    out.update({
        "victim": victim.addr,
        "victim_isolated": bool(victim_isolated),
        "victim_alive_while_isolated": bool(victim_alive),
        "victim_trip_reason": victim_trip_reason,
        "healed": bool(healed),
        "probe_outcomes": probe_outcomes,
        "probes_conformant": all(p == "ok" for p in probe_outcomes),
        "migration_reruns": sim.metrics.get("migration_reruns"),
        "migration_resumes": sim.metrics.get("migration_resumes"),
        "interactive_p99_ms": (sorted(walls)[
            max(0, int(0.99 * len(walls)) - 1)] if walls else None),
    })
    sim.stop()
    return out


class _LeanOpenWorkload:
    """Deterministic fixed-interval arrivals alternating the two
    default classes — the scale scenario's workload, built to add as
    little generator overhead as possible at 1M requests (no
    per-request distribution draws)."""

    def __init__(self, n_requests: int, rate: float):
        self.n_requests = int(n_requests)
        self.rate = float(rate)

    def __iter__(self):
        gap = 1.0 / self.rate
        t = 0.0
        a = Request(0.0, "interactive", 16, 8, None)
        b = Request(0.0, "background", 16, 8, None)
        for i in range(self.n_requests):
            t += gap
            yield (a if i & 1 else b)._replace(at=t)


def scenario_scale(overrides=(), n_requests: int = 1_000_000,
                   replicas: Optional[int] = None,
                   seed: Optional[int] = None,
                   workload=None, model_fit: Optional[dict] = None,
                   cfg: Optional[SimConfig] = None) -> Dict[str, Any]:
    """The scale proof: 1000 replicas, >= 1M requests, open Poisson
    arrivals — the ``bench_fleet_sim`` scenario (no deadlines, two
    classes, breakers on).  Exists to keep ``sim_events_per_sec``
    honest; shrink ``n_requests``/``replicas`` for smoke runs."""
    cfg = _new_cfg(cfg, overrides)
    cfg.replicas = int(replicas) if replicas is not None else 1000
    if seed is not None:
        cfg.seed = int(seed)
    if not any(p == "workers" for p, _ in (overrides or ())):
        # 64 dispatchers is the sweet spot measured for switch
        # overhead; the scenario measures control-plane scale (1000
        # registry entries, picks over the full tier), not pool width.
        cfg.workers = 64
    cfg.max_queue = 4096
    cfg.hb_interval = 1.0
    cfg.model = dataclasses.replace(cfg.model, jitter=0.0)
    if model_fit:
        for k, v in model_fit.items():
            if hasattr(cfg.model, k):
                setattr(cfg.model, k, v)
    sim = FleetSim(cfg)
    for _ in range(cfg.replicas):
        sim.add_replica(UNIFIED)
    if workload is None:
        _, per_req_s = cfg.model.service_s(16, 8, random.Random(0))
        # Arrivals at the dispatcher pool's saturation point (the pool
        # is the concurrency bound, same shape as the real gateway's
        # worker pool): the queue stays primed, so this measures peak
        # sustainable throughput — and never idles the pool.
        rate = cfg.workers / max(1e-9, per_req_s)
        workload = _LeanOpenWorkload(n_requests, rate)
    sim.feed(workload)
    sim.start_workers()
    t0 = time.perf_counter()
    sim.engine.run(stop=sim.drained)
    wall = time.perf_counter() - t0
    out = sim.results(wall)
    sim.stop()
    return out


def scenario_diurnal(overrides=(), n_requests: int = 1_000_000,
                     replicas: Optional[int] = None,
                     seed: Optional[int] = None,
                     workload=None, model_fit: Optional[dict] = None,
                     cfg: Optional[SimConfig] = None) -> Dict[str, Any]:
    """The million-user front door's day at 10x the scale proof:
    10,000 replicas, >= 1M requests riding a sinusoidal day/night
    envelope with seeded flash crowds (:class:`~tfmesos_tpu_torch.fleet.
    workload.DiurnalWorkload` — fit the constants from a real
    ``tfserve trace --json`` export with ``fit_diurnal``), heartbeats
    SHARDED (``cfg.hb_shards``) so the event heap prices requests,
    not 10k timer pops per sim-second.  Byte-for-byte deterministic
    per seed; gateway counts, trader constants and admission bounds
    all sweepable.  Publishes ``sim_events_per_sec_10k`` — the
    10x-replica hot-path floor benched next to ``sim_events_per_sec``
    (the scale scenario's 45k events/s contract)."""
    cfg = _new_cfg(cfg, overrides)
    cfg.replicas = int(replicas) if replicas is not None else 10_000
    if seed is not None:
        cfg.seed = int(seed)
    if not swept(overrides, "workers"):
        cfg.workers = 64      # the scale scenario's measured sweet spot
    if not swept(overrides, "max_queue"):
        # ALIAS-AWARE guard (swept, not a raw path scan): a
        # ``--sweep admission.max_queue=...`` row must keep its bound
        # — the raw scan saw only "admission.max_queue" and silently
        # clobbered every row back to 4096.
        cfg.max_queue = 4096
    # A 10k fleet beats and sweeps SLOWER than a 3-replica one (real
    # fleets stretch liveness cadence with size): per-sim-second table
    # work is replicas/hb_interval observes plus a full-table sweep
    # every sweep_interval — at the scale scenario's cadence that is
    # 10k observes + 5 sweeps per sim-second of pure bookkeeping wall.
    # Each constant stays individually sweepable.
    for path, v in (("hb_interval", 5.0), ("suspect_after", 7.5),
                    ("dead_after", 15.0), ("evict_after", 60.0),
                    ("sweep_interval", 2.0)):
        if not swept(overrides, path):
            setattr(cfg, path, v)
    if cfg.hb_shards <= 0:
        # Per-replica beats are 2k heap events per sim-second of pure
        # timer churn at this scale; 64 shard beats carry the same
        # registry observations.
        cfg.hb_shards = 64
    cfg.model = dataclasses.replace(cfg.model, jitter=0.0)
    if model_fit:
        for k, v in model_fit.items():
            if hasattr(cfg.model, k):
                setattr(cfg.model, k, v)
    sim = FleetSim(cfg)
    # 10k one-line "registered" INFO records are pure handler wall (and
    # unreadable output) at bring-up — quiet the registry logger for
    # the bulk registration only.
    reg_log = logging.getLogger("tfmesos_tpu_torch.fleet.registry")
    old_level = reg_log.level
    reg_log.setLevel(logging.WARNING)
    try:
        for _ in range(cfg.replicas):
            sim.add_replica(UNIFIED)
    finally:
        reg_log.setLevel(old_level)
    if workload is None:
        _, per_req_s = cfg.model.service_s(16, 8, random.Random(0))
        # MEAN arrivals at the dispatcher pool's saturation point (the
        # scale scenario's pump) so the envelope swings the pool from
        # trough slack to crest overload — two full day/night cycles
        # plus four flash crowds across the stream.
        peak = 4.0
        pump = cfg.workers / max(1e-9, per_req_s)
        base = pump / (1.0 + (peak - 1.0) / 2.0)
        span = n_requests / pump
        workload = DiurnalWorkload(
            n_requests, base, seed=cfg.seed,
            period_s=max(1.0, span / 2.0), peak_ratio=peak,
            bursts=4, burst_ratio=3.0,
            burst_duration_s=max(0.5, span / 50.0),
            class_mix={"interactive": 4.0, "background": 1.0},
            prompt_len=16, prompt_sigma=0.0,
            new_tokens=8, new_tokens_sigma=0.0)
    sim.feed(workload)
    sim.start_workers()
    t0 = time.perf_counter()
    sim.engine.run(stop=sim.drained)
    wall = time.perf_counter() - t0
    out = sim.results(wall)
    out["sim_events_per_sec_10k"] = out.get("sim_events_per_sec")
    out["hb_shards"] = cfg.hb_shards
    sim.stop()
    return out


def scenario_offline_lane(overrides=(), n_requests: int = 3000,
                          replicas: Optional[int] = None,
                          seed: Optional[int] = None,
                          workload=None,
                          model_fit: Optional[dict] = None,
                          cfg: Optional[SimConfig] = None
                          ) -> Dict[str, Any]:
    """The OFFLINE lane (docs/SERVING.md "Offline lane"):
    interactive arrivals ride a diurnal envelope whose trough leaves
    decode slots idle, while a deadline-less batch backlog (half the
    interactive volume, submitted up front) fills them through the
    strict-priority batch class.  The tunable under sweep is the
    interactive-vs-batch budget split: ``--sweep batch_slot_frac=
    0.25,0.5,0.75,1.0`` prices reserve headroom against harvested
    utilization, and ``--sweep batch_lane=false,true`` is the
    lane-off baseline the bench asserts against (utilization strictly
    higher with the lane on, interactive p99 held, zero interactive
    requests lost)."""
    cfg = _new_cfg(cfg, overrides)
    if replicas is not None:
        cfg.replicas = int(replicas)
    if seed is not None:
        cfg.seed = int(seed)
    if not swept(overrides, "batch_lane"):
        cfg.batch_lane = True
    if not swept(overrides, "max_queue"):
        # The batch backlog arrives up front BY DESIGN — it must fit
        # the bounded queue, or the scenario measures shed, not the
        # lane (the bound stays individually sweepable).
        cfg.max_queue = max(cfg.max_queue, n_requests)
    if model_fit:
        for k, v in model_fit.items():
            if hasattr(cfg.model, k):
                setattr(cfg.model, k, v)
    cfg.workers = max(cfg.workers,
                      min(256, 2 * cfg.replicas * cfg.capacity))
    sim = FleetSim(cfg)
    for _ in range(cfg.replicas):
        sim.add_replica(UNIFIED)
    n_batch = n_requests // 2
    if workload is None:
        _, per_req_s = cfg.model.service_s(16, 8, random.Random(0))
        # Crest at ~0.9x the fleet's service rate: saturated enough
        # that the lane must yield, trough idle enough that there is
        # capacity to harvest.
        pump = cfg.replicas * cfg.capacity / max(1e-9, per_req_s)
        base = 0.45 * pump
        span = n_requests / (base * 1.5)
        workload = DiurnalWorkload(
            n_requests, base, seed=cfg.seed,
            period_s=max(1.0, span), peak_ratio=2.0,
            class_mix={"interactive": 1.0},
            prompt_len=16, prompt_sigma=0.0,
            new_tokens=8, new_tokens_sigma=0.0,
            deadline_ms=60_000.0)
    sim.feed(workload)
    if n_batch and cfg.batch_lane:
        # The backlog: deadline-less batch arrivals land in the first
        # slice of the day and wait for idle slots.  Lane OFF is the
        # no-offline-work baseline — without the class there is no
        # surface to submit it through.
        sim.feed(SyntheticWorkload(
            n_batch, rate=max(1.0, n_batch / 2.0),
            seed=cfg.seed + 1, class_mix={"batch": 1.0},
            prompt_len=16, prompt_sigma=0.0,
            new_tokens=8, new_tokens_sigma=0.0))
    sim.start_workers()
    t0 = time.perf_counter()
    sim.engine.run(stop=sim.drained)
    wall = time.perf_counter() - t0
    out = sim.results(wall)
    out["batch_lane"] = cfg.batch_lane
    out["batch_slot_frac"] = cfg.batch_slot_frac
    out["batch_planned"] = n_batch if cfg.batch_lane else 0
    sim.stop()
    return out


def scenario_multi_gateway(overrides=(), n_requests: int = 6000,
                           replicas: Optional[int] = None,
                           seed: Optional[int] = None,
                           workload=None,
                           model_fit: Optional[dict] = None,
                           cfg: Optional[SimConfig] = None
                           ) -> Dict[str, Any]:
    """The multi-gateway front door at sim scale (`tfserve --gateways
    N`): arrivals spread round-robin over N gateway fronts sharing ONE
    registry/router view; mid-run one front is HARD-KILLED and its
    queued work fails over to the survivors (the client-replay analog)
    — the scenario asserts the fleet answers every planned request
    (zero lost) and reports per-front shed plus the failover count, so
    front-door policy constants (per-front queue bounds, worker width)
    are sweepable at 1000-replica scale."""
    cfg = _new_cfg(cfg, overrides)
    if cfg.gateways < 2:
        # The scenario is ABOUT the multi-front topology: a lone front
        # has nothing to fail over to.  Loud, so a sweep row labeled
        # gateways=1 is never silently a 3-front run.
        if any(p == "gateways" for p, _ in (overrides or ())):
            raise ValueError(
                f"the multi-gateway scenario needs gateways >= 2 "
                f"(got {cfg.gateways}); sweep the steady scenario "
                f"for a single-front baseline")
        cfg.gateways = 3
    if replicas is not None:
        cfg.replicas = int(replicas)
    if seed is not None:
        cfg.seed = int(seed)
    if model_fit:
        for k, v in model_fit.items():
            if hasattr(cfg.model, k):
                setattr(cfg.model, k, v)
    # Per-front pools must jointly cover the fleet's concurrency even
    # AFTER one front dies: size each front's pool for the whole fleet
    # divided by the surviving fronts.
    cfg.workers = max(cfg.workers,
                      min(128, (2 * cfg.replicas * cfg.capacity)
                          // max(1, cfg.gateways - 1)))
    sim = FleetSim(cfg)
    for _ in range(cfg.replicas):
        sim.add_replica(UNIFIED)
    if workload is None:
        _, per_req_s = cfg.model.service_s(64, 16, random.Random(0))
        # Slightly OVER fleet capacity: queues stay primed, so the
        # killed front demonstrably holds work that must fail over
        # (an idle-queue kill would prove nothing).
        rate = 1.2 * cfg.replicas * cfg.capacity / max(1e-9, per_req_s)
        workload = SyntheticWorkload(
            n_requests=n_requests, seed=cfg.seed, rate=rate,
            class_mix={"interactive": 1.0, "background": 2.0},
            prompt_len=64, new_tokens=16)
    else:
        rate = getattr(workload, "rate", 100.0)
    sim.feed(workload)
    sim.start_workers()
    # SIGKILL one front door mid-traffic: at roughly the arrival
    # stream's midpoint.
    n = getattr(workload, "n_requests", n_requests)
    t_kill = 0.5 * n / max(1e-9, rate)
    killed_at: List[float] = []

    def kill() -> None:
        killed_at.append(sim.engine.clock.now)
        sim.kill_gateway(1)

    sim.engine.at(t_kill, kill)
    t0 = time.perf_counter()
    sim.engine.run(stop=sim.drained)
    wall = time.perf_counter() - t0
    out = sim.results(wall)
    out.update({
        "gateways": len(sim.fronts),
        "gateway_killed_at": round(killed_at[0], 3) if killed_at
        else None,
        "gateway_failovers": sim.gateway_failovers,
        "per_front_shed": [f.admission.shed_counts()
                           for f in sim.fronts],
    })
    sim.stop()
    return out


class _SessionWorkload:
    """Multi-turn conversations as an open-arrival stream: ``sessions``
    concurrent conversations of ``turns`` turns each, every turn's
    prompt the FULL history so far (prior prompt + reply + the new
    user tokens) — the workload shape the KV tier exists for.  Turn
    rounds interleave across sessions (round-robin with Poisson gaps),
    so a session's turns never arrive back-to-back and the tier must
    actually hold the parked state across interleaved traffic."""

    def __init__(self, sessions: int, turns: int, rate: float,
                 seed: int = 0, user_tokens: int = 32,
                 reply_tokens: int = 16, cls: str = "interactive"):
        if sessions < 1 or turns < 1:
            raise ValueError(f"sessions ({sessions}) and turns "
                             f"({turns}) must be >= 1")
        self.sessions = int(sessions)
        self.turns = int(turns)
        self.rate = float(rate)
        self.seed = int(seed)
        self.user_tokens = int(user_tokens)
        self.reply_tokens = int(reply_tokens)
        self.cls = cls
        self.n_requests = self.sessions * self.turns

    def __iter__(self):
        rng = random.Random(self.seed)
        t = 0.0
        per_turn = self.user_tokens + self.reply_tokens
        for k in range(self.turns):
            plen = k * per_turn + self.user_tokens
            for s in range(self.sessions):
                t += rng.expovariate(self.rate)
                yield Request(at=t, cls=self.cls, prompt_len=plen,
                              new_tokens=self.reply_tokens,
                              session=f"s{s}")


def scenario_sessions(overrides=(), n_requests: Optional[int] = None,
                      replicas: Optional[int] = None,
                      seed: Optional[int] = None,
                      turns: int = 6, sessions: Optional[int] = None,
                      workload=None, model_fit: Optional[dict] = None,
                      cfg: Optional[SimConfig] = None
                      ) -> Dict[str, Any]:
    """Session park/resume at scale (docs/SERVING.md "KV tiering &
    sessions"): thousands of multi-turn conversations whose later
    turns resume from the host-shared KV tier and prefill only the new
    tail, with one replica HARD-KILLED mid-run — parked sessions
    survive it (the tier is host-shared, the disk-dir deployment) and
    keep resuming on the survivors.  Reports the tier hit rate and the
    mean resumed vs cold-turn TTFT; the regression contract (asserted
    in tests/test_sim.py): zero lost requests across the kill, and
    resumed turns strictly cheaper than cold full-history prefills."""
    cfg = _new_cfg(cfg, overrides)
    if replicas is not None:
        cfg.replicas = int(replicas)
    if seed is not None:
        cfg.seed = int(seed)
    if model_fit:
        for k, v in model_fit.items():
            if hasattr(cfg.model, k):
                setattr(cfg.model, k, v)
    # Long-history prefills are the cost the tier removes — make the
    # per-token prefill cost visible against the base.
    if not any(p.startswith("model.") for p, _ in (overrides or ())):
        cfg.model = dataclasses.replace(cfg.model,
                                        prefill_ms_per_token=0.2)
    cfg.workers = max(cfg.workers,
                      min(256, 2 * cfg.replicas * cfg.capacity))
    sim = FleetSim(cfg)
    # The cross-host placement knob (gang-parked sharded sessions):
    # below 1.0, a resume landing off the parker's host re-prefills
    # cold — sweep it to price host-local vs shared artifact stores.
    sim.transport.cross_host_resume = float(cfg.cross_host_resume)
    sim.transport.kv_replication = int(cfg.kv_replication)
    sim.transport.kv_forward_ms = float(cfg.kv_forward_ms)
    sim.transport.kv_placement = str(cfg.kv_placement)
    reps = [sim.add_replica(UNIFIED) for _ in range(cfg.replicas)]
    if workload is None:
        n_sessions = int(sessions) if sessions is not None else (
            max(1, int(n_requests) // max(1, turns))
            if n_requests is not None else 500)
        _, per_req_s = cfg.model.service_s(
            (turns // 2) * 48 + 32, 16, random.Random(0))
        rate = 0.6 * cfg.replicas * cfg.capacity / max(1e-9, per_req_s)
        workload = _SessionWorkload(n_sessions, turns, rate,
                                    seed=cfg.seed)
    sim.feed(workload)
    sim.start_workers()
    # Hard-kill one replica at roughly the stream's midpoint: parked
    # sessions must keep resuming on the survivors.
    n = getattr(workload, "n_requests", 0)
    rate = getattr(workload, "rate", 100.0)
    if len(reps) > 1 and n:
        sim.engine.at(0.5 * n / max(1e-9, rate),
                      lambda: sim.kill(reps[0]))
    t0 = time.perf_counter()
    sim.engine.run(stop=sim.drained)
    wall = time.perf_counter() - t0
    out = sim.results(wall)
    st = sim.transport.session_stats
    hits, misses = st["hits"], st["misses"]
    out.update({
        "session_tier": dict(st),
        "kv_tier_hit_rate": round(hits / max(1, hits + misses), 4),
        "sessions_parked": len(sim.transport.session_tier),
        "resumed_ttft_mean_ms": round(
            st["ttft_hit_ms"] / max(1, st["resume"]), 3),
        "cold_ttft_mean_ms": round(
            st["ttft_cold_ms"] / max(1, st["park"] - st["resume"]), 3),
        "cross_host_resume": cfg.cross_host_resume,
        "kv_replication": cfg.kv_replication,
        "kv_placement": cfg.kv_placement,
    })
    # The placement sweep's figure of merit: how evenly the K-way
    # copies landed across surviving tiers (max vs mean copies held).
    load = sim.transport._tier_load
    if load:
        out["kv_copy_load_max"] = max(load.values())
        out["kv_copy_load_mean"] = round(
            sum(load.values()) / len(load), 2)
    sim.stop()
    return out


def scenario_gang(overrides=(), n_requests: int = 4000,
                  replicas: Optional[int] = None,
                  seed: Optional[int] = None,
                  workload=None, model_fit: Optional[dict] = None,
                  cfg: Optional[SimConfig] = None) -> Dict[str, Any]:
    """Gang replicas at sim scale (docs/SERVING.md "Gang replicas"):
    a unified tier of N-member pod-slice gangs under steady open
    arrivals, with one gang MEMBER hard-killed mid-run — the gang
    dies whole, re-forms after ``gang_reform_s`` (rendezvous +
    re-warm), and its in-flight work replays on the survivors.  The
    regression contract (tests/test_sim.py): zero lost requests
    across the member kill, the fleet ends with the booted gang count
    again, and a gang fleet's decode tail beats the single-process
    fleet of equal replica count (that is what the slice buys).
    Sweep the slice shape with ``--sweep gang_size=2,4,8`` or the
    collective tax with ``--sweep gang_efficiency=0.6,0.85,1.0``."""
    cfg = _new_cfg(cfg, overrides)
    if replicas is not None:
        cfg.replicas = int(replicas)
    if seed is not None:
        cfg.seed = int(seed)
    if model_fit:
        for k, v in model_fit.items():
            if hasattr(cfg.model, k):
                setattr(cfg.model, k, v)
    if cfg.gang_size <= 1:
        cfg.gang_size = 4
    cfg.workers = max(cfg.workers,
                      min(256, 2 * cfg.replicas * cfg.capacity))
    sim = FleetSim(cfg)
    reps = [sim.add_replica(UNIFIED, gang_size=cfg.gang_size)
            for _ in range(cfg.replicas)]
    if workload is None:
        # Rate from the SINGLE-PROCESS model: the same offered load a
        # non-gang fleet of this shape would see, so the gang's
        # speedup shows up as latency headroom, not as an easier run.
        _, per_req_s = cfg.model.service_s(64, 16, random.Random(0))
        workload = SyntheticWorkload(
            n_requests=n_requests, seed=cfg.seed,
            rate=0.7 * cfg.replicas * cfg.capacity
            / max(1e-9, per_req_s),
            class_mix={"interactive": 1.0, "background": 2.0},
            prompt_len=64, new_tokens=16)
    sim.feed(workload)
    sim.start_workers()
    n = getattr(workload, "n_requests", 0)
    rate = getattr(workload, "rate", 100.0)
    if n:
        # Mid-stream member SIGKILL: the gang death + whole re-form.
        sim.engine.at(0.5 * n / max(1e-9, rate),
                      lambda: sim.kill_gang_member(reps[0]))
    t0 = time.perf_counter()
    sim.engine.run(stop=sim.drained)
    if n:
        # Let the re-form land (it may trail the last arrival): the
        # scenario's contract is that the fleet ENDS whole again.
        sim.engine.run(until=sim.engine.clock.now + cfg.gang_reform_s
                       + cfg.warmup_s + 3 * cfg.hb_interval)
    wall = time.perf_counter() - t0
    out = sim.results(wall)
    out.update({
        "gang_size": cfg.gang_size,
        "gang_efficiency": cfg.gang_efficiency,
        "gang_reform_s": cfg.gang_reform_s,
        "gang_deaths": sim.metrics.get("gang_deaths"),
        "gang_reforms": sim.metrics.get("gang_reforms"),
        "gangs_actual": sim.tier_actual(UNIFIED),
        "gang_summary": sim.registry.gang_summary(),
    })
    sim.stop()
    return out


def scenario_multi_model(overrides=(), n_requests: int = 24000,
                         replicas: Optional[int] = None,
                         seed: Optional[int] = None,
                         workload=None,
                         model_fit: Optional[dict] = None,
                         cfg: Optional[SimConfig] = None
                         ) -> Dict[str, Any]:
    """The model catalog at sim scale (docs/SERVING.md "Model
    catalog"): skewed two-model traffic whose hotness FLIPS mid-run
    against a fixed fleet-wide replica budget, plus one idle model and
    a warm pool.  The REAL :class:`~tfmesos_tpu_torch.fleet.catalog.
    ModelTrader` must (a) scale the idle model to zero (freeing its
    budget slot), (b) TRADE replicas from the cooling model to the
    heating one after the flip — without thrashing them back and
    forth — and (c) cold-start the zeroed model through the warm pool
    when a late request demands it.  The regression contract
    (tests/test_sim.py): the post-flip hot model ends with MORE
    replicas than it booted, trades stay bounded, the cold start
    completes, zero lost requests — deterministic per seed.  Sweep the
    trading constants with ``--sweep trader.zero_after_ticks=4,8,16``
    or ``--sweep trader.trade_cooldown_s=0,5,20``."""
    cfg = _new_cfg(cfg, overrides)
    if seed is not None:
        cfg.seed = int(seed)
    if model_fit:
        for k, v in model_fit.items():
            if hasattr(cfg.model, k):
                setattr(cfg.model, k, v)
    if not cfg.models:
        cfg.models = (("alpha", 3), ("beta", 1), ("gamma", 1))
    if replicas is not None:
        # --replicas scales the FIRST (hot) model's boot count.
        first = cfg.models[0]
        cfg.models = ((first[0], int(replicas)),) + cfg.models[1:]
    if cfg.warm_pool == 0:
        cfg.warm_pool = 1
    boot = sum(n for _, n in cfg.models)
    if cfg.model_budget is None:
        cfg.model_budget = boot + cfg.warm_pool
    # Trading reacts at the tick cadence; the scenario's phases span
    # tens of virtual seconds, so the default cooldowns fit.
    cfg.autoscale = True
    cfg.workers = max(cfg.workers,
                      min(256, 2 * cfg.model_budget * cfg.capacity))
    sim = FleetSim(cfg)
    catalog = ModelCatalog([
        ModelSpec(mid, replicas=n, seed=i)
        for i, (mid, n) in enumerate(cfg.models)])
    for i, (mid, n) in enumerate(cfg.models):
        key = model_key(mid)
        sim.set_target(key, n)
        for _ in range(n):
            sim.launch_replica(key)
    from tfmesos_tpu_torch.fleet.catalog import POOL_KEY
    sim.set_target(POOL_KEY, cfg.warm_pool)
    for _ in range(cfg.warm_pool):
        sim.launch_replica(POOL_KEY)
    sim.enable_trader(catalog)
    hot, cold = cfg.models[0][0], cfg.models[1][0]
    idle = cfg.models[2][0] if len(cfg.models) > 2 else None
    if workload is None:
        _, per_req_s = cfg.model.service_s(64, 16, random.Random(0))
        # Saturate the HOT model's boot allocation so its pressure is
        # unambiguous; the cold model idles along at a trickle.
        hot_rate = 1.1 * cfg.models[0][1] * cfg.capacity \
            / max(1e-9, per_req_s)
        cold_rate = 0.1 * hot_rate
        n_half = n_requests // 2
        mk = SyntheticWorkload
        phase1 = [
            mk(n_requests=int(n_half * 0.9), seed=cfg.seed,
               rate=hot_rate, prompt_len=64, new_tokens=16,
               model=hot),
            mk(n_requests=max(1, int(n_half * 0.1)), seed=cfg.seed + 1,
               rate=cold_rate, prompt_len=64, new_tokens=16,
               model=cold),
        ]
        t_flip = max(max(r.at for r in w) for w in phase1)
        phase2 = [
            mk(n_requests=int(n_half * 0.9), seed=cfg.seed + 2,
               rate=hot_rate, prompt_len=64, new_tokens=16,
               model=cold, start_at=t_flip),
            mk(n_requests=max(1, int(n_half * 0.1)), seed=cfg.seed + 3,
               rate=cold_rate, prompt_len=64, new_tokens=16,
               model=hot, start_at=t_flip),
        ]
        for w in phase1 + phase2:
            sim.feed(w)
    else:
        t_flip = None
        sim.feed(workload)
    sim.start_workers()
    t0 = time.perf_counter()
    sim.engine.run(stop=sim.drained)
    # Allocation is read the moment traffic drains — before idleness
    # scales everything back to zero.
    post_flip_hot_actual = sim.tier_actual(model_key(cold))
    # COLD START: one late request for the scaled-to-zero idle model
    # must route through the demand hook -> warm-pool adoption and
    # COMPLETE, never error.
    cold_start: Dict[str, Any] = {}
    if idle is not None:
        sink: list = []
        req = Request(at=0.0, cls=None, prompt_len=16, new_tokens=4,
                      model=idle)
        t_demand = sim.engine.clock.now

        def probe() -> None:
            if not sim.submit(req, sink=sink):
                return
            while not sink:
                item = sim.admission.get(timeout=0)
                if item is not None:
                    sim.dispatch(item)
                else:
                    sim.engine.sleep(0.01)

        sim.engine.spawn(probe, name="sim-cold-start")
        sim.engine.run(until=sim.engine.clock.now + 60.0,
                       stop=lambda: bool(sink))
        reply = sink[0][0] if sink else None
        cold_start = {
            "completed": bool(isinstance(reply, dict)
                              and reply.get("op") == "completion"),
            "wait_s": round(sim.engine.clock.now - t_demand, 3),
        }
    wall = time.perf_counter() - t0
    out = sim.results(wall)
    out.update({
        "hot_then_cold": (hot, cold),
        "flip_at": round(t_flip, 3) if t_flip is not None else None,
        "trades": sim.metrics.get("model_trades"),
        "trade_blocked": sim.metrics.get("model_trade_blocked"),
        "scale_to_zero": sim.metrics.get("model_scale_to_zero"),
        "adoptions": sim.metrics.get("sim_adoptions"),
        "cold_starts": sim.metrics.get("model_cold_starts"),
        "final_actual": {mid: sim.tier_actual(model_key(mid))
                         for mid, _ in cfg.models},
        "post_flip_hot_actual": post_flip_hot_actual,
        "pool_actual": sim.tier_actual(POOL_KEY),
        "budget": cfg.model_budget,
        "cold_start": cold_start,
    })
    sim.stop()
    return out


SCENARIOS: Dict[str, Callable[..., Dict[str, Any]]] = {
    "steady": scenario_steady,
    "surge": scenario_surge,
    "soak-replay": scenario_soak_replay,
    "scale": scenario_scale,
    "diurnal": scenario_diurnal,
    "offline-lane": scenario_offline_lane,
    "multi-gateway": scenario_multi_gateway,
    "sessions": scenario_sessions,
    "multi-model": scenario_multi_model,
    "gang": scenario_gang,
}


def run_scenario(name: str, overrides=(), **kwargs) -> Dict[str, Any]:
    """Run one named scenario with ``(path, value)`` overrides."""
    fn = SCENARIOS.get(name)
    if fn is None:
        raise ValueError(f"unknown scenario {name!r} "
                         f"(have: {', '.join(sorted(SCENARIOS))})")
    return fn(overrides=overrides, **kwargs)


def run_sweep(name: str, path: str, values, overrides=(),
              **kwargs) -> List[Tuple[str, Dict[str, Any]]]:
    """Run ``name`` once per sweep value (each on the same seed, so
    rows differ only by the swept constant); returns ``[(value,
    results)]`` for the CLI's comparison table."""
    out = []
    for v in values:
        res = run_scenario(name,
                           overrides=list(overrides) + [(path, v)],
                           **kwargs)
        out.append((str(v), res))
    return out
