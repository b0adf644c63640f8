"""Fleet autoscaler: a feedback loop that sizes each serving tier (port
of ``tfmesos_tpu/fleet/autoscaler.py``).

The fleet is no longer a launch-time constant: this control loop reads
per-tier load signals every tick and converges each tier's replica
count toward a target inside ``[min_replicas, max_replicas]`` bounds —
the replica-membership-as-runtime-property stance of TF-Replicator
(PAPERS.md), applied to serving.

Signals (all already flowing before this module existed):

* **Prompt-bearing tiers** (unified, prefill) scale on the WINDOWED p99
  of the gateway's ``queue_wait_ms`` histogram — the interval between
  two control ticks, not the lifetime percentile, so the loop reacts to
  load that exists now rather than chasing a surge that ended minutes
  ago — plus tier utilization (self-reported outstanding / advertised
  capacity from registry heartbeats).
* **The decode tier** scales on aggregate KV-page headroom per alive
  replica (the heartbeat field decode routing already places by):
  decode replicas run out of *pages*, not CPU, long before their row
  counts saturate.

Actuation goes through the fleet's dynamic launcher:

* **Scale up** launches ONE new Mode-B replica task per tick (the same
  command line the tier booted with, ``--warmup`` included, so the
  newcomer registers ``warming`` and never takes traffic cold).
* **Scale down** picks the least-loaded alive replica and announces a
  PINNED drain at the registry (``begin_drain`` — drain-for-scale-down:
  the healthy victim keeps heartbeating plain alive beats while its
  in-flight work flushes, and those beats must not revive it), asks it
  to MIGRATE its in-flight rows (suspend → the router re-places each
  exported KV artifact on a surviving replica, resuming mid-stream;
  docs/SERVING.md "Priorities, preemption & migration"), then kills
  the task only once its outstanding count reaches zero (or the drain
  deadline passes).  In-flight requests are never shed.
* **Convergence doubles as self-healing**: a replica task that dies is
  dropped from the scheduler's table, actual falls below target, and
  the next tick relaunches it — one per tick, so a crash loop churns at
  the control cadence, not as fast as fork can go.

Stability guards: hysteresis (the up and down thresholds form a dead
band), separate per-tier cooldowns for each direction, at most one
pending drain per tier, and a hard invariant that a routable tier is
never drained below one alive replica no matter what the signals say.
Every decision lands in the log and in the ``autoscaler`` gauge
(target / actual / last_action per tier).

Determinism for tests: the clock and the signal source are both
injectable — a fake-signal test drives
``step()`` by hand and asserts the exact launch/drain/kill sequence,
no timing races involved.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional

from tfmesos_tpu_torch.fleet.metrics import Histogram
from tfmesos_tpu_torch.fleet.registry import ALIVE, DEAD, DECODE, KV
from tfmesos_tpu_torch.utils.logging import get_logger

__all__ = ["AutoscalerConfig", "FleetAutoscaler"]


@dataclasses.dataclass
class AutoscalerConfig:
    """Knobs of the control loop (docs/SERVING.md "Autoscaling"), with
    the JAX package's defaults: the hysteresis band between the ``hi``
    and ``lo`` bounds is what keeps the loop from flapping
    launch/drain/launch on a noisy signal."""

    #: seconds between control ticks (the loop's cadence).
    interval: float = 1.0
    #: prompt tiers scale UP when the windowed queue-wait p99 crosses
    #: this; the matching ``lo`` bound arms scale-down — the gap between
    #: them is the hysteresis dead band that keeps the loop from
    #: flapping on a noisy signal.
    queue_wait_hi_ms: float = 500.0
    queue_wait_lo_ms: float = 50.0
    #: tier utilization (self-reported outstanding / advertised
    #: capacity) bounds, same dead-band structure.
    util_hi: float = 0.75
    util_lo: float = 0.25
    #: decode tier: scale UP when average free KV pages per alive
    #: replica dip below ``lo``; ``hi`` (with low utilization) arms
    #: scale-down.
    kv_headroom_lo: float = 8.0
    kv_headroom_hi: float = 64.0
    #: fleet KV-tier occupancy (RAM-tier bytes used / budget, summed
    #: over every tiered replica): above this the tier is evicting
    #: parked artifacts, so it BLOCKS scale-down (a drained replica's
    #: tier capacity evicts more) and — together with the hit-rate
    #: floor below — arms scale-up even when queue wait looks calm.
    kv_tier_occupancy_hi: float = 0.9
    #: windowed KV-tier hit-rate floor: a saturated tier whose
    #: between-ticks hit rate sits below this is THRASHING (traffic
    #: still wants what eviction throws away) — more replicas mean
    #: more aggregate tier RAM, so that combination scales up.
    kv_tier_hit_rate_lo: float = 0.2
    #: per-tier cooldowns, one per direction: growing again right after
    #: growing is cheap to allow, shrinking is deliberately slower.
    scale_up_cooldown: float = 5.0
    scale_down_cooldown: float = 30.0
    #: a draining victim gets this long to flush its in-flight work
    #: before the kill goes through anyway.
    drain_timeout: float = 120.0
    #: minimum drain age before the kill: the victim's outstanding
    #: count is heartbeat-lagged, so a just-announced drain must not
    #: read a stale zero and kill mid-request.
    drain_grace: float = 1.0


class FleetAutoscaler:
    """The per-tier feedback loop over a :class:`FleetServer`.

    ``fleet`` must expose the dynamic-fleet surface (``registry``,
    ``metrics``, ``targets``, ``set_target``, ``bounds``,
    ``launch_replica``, ``kill_replica``, ``tier_actual``,
    ``scale_lock``) — tests drive the loop against a stub fleet
    through exactly the same surface.
    """

    def __init__(self, fleet, config: Optional[AutoscalerConfig] = None,
                 signals: Optional[Callable[[], Dict[str, Dict[str, Any]]]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.fleet = fleet
        self.config = config or AutoscalerConfig()
        self._signals = signals or self._default_signals
        self._clock = clock
        self.log = get_logger("tfmesos_tpu_torch.fleet.autoscaler")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Windowed-percentile state: the previous tick's cumulative
        # queue-wait histogram sample.
        self._prev_queue_wait: Optional[tuple] = None
        # Windowed KV-tier state: the previous tick's fleet-wide
        # counter aggregate, so hit rate is between-ticks (the same
        # react-to-now discipline as the queue-wait window).
        self._prev_kv: Optional[Dict[str, Any]] = None
        self._last_up: Dict[str, float] = {}
        self._last_down: Dict[str, float] = {}
        # addr -> {role, node, since, deadline}: drains in flight.
        self._draining: Dict[str, Dict[str, Any]] = {}
        self._last_action: Dict[str, str] = {}
        if getattr(fleet, "metrics", None) is not None:
            fleet.metrics.register_gauge("autoscaler", self.describe)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetAutoscaler":
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval):
            try:
                self.step()
            except Exception:
                # One broken tick must not kill the control loop; the
                # fleet keeps serving at its current size either way.
                self.log.exception("autoscaler tick failed")

    # -- signals -----------------------------------------------------------

    def _default_signals(self) -> Dict[str, Dict[str, Any]]:
        """Per-tier signal dict from the live registry + metrics: the
        windowed queue-wait p99 (global — one ingress queue feeds every
        tier), per-tier utilization, and per-tier average KV headroom
        per alive replica."""
        cur = self.fleet.metrics.hist_cumulative("queue_wait_ms")
        qw_p99 = None
        if cur is not None:
            qw_p99 = Histogram.delta_percentile(self._prev_queue_wait,
                                                cur, 0.99)
            self._prev_queue_wait = cur
        # KV-tier occupancy + windowed hit rate (fleet-wide, like the
        # queue-wait window — every tiered replica feeds one session
        # economy).  Counter deltas clamp at zero: a dying replica's
        # counters leave the aggregate, which must not read as
        # negative traffic.
        kv_occ = kv_hit = None
        kvsum = getattr(self.fleet.registry, "kv_tier_summary", None)
        if kvsum is not None:
            cur_kv = kvsum()
            if cur_kv.get("replicas"):
                budget = cur_kv.get("ram_bytes") or 0
                if budget > 0:
                    kv_occ = cur_kv.get("ram_bytes_used", 0) / budget
                prev = self._prev_kv or {}
                hits = max(0, cur_kv.get("hits", 0)
                           - prev.get("hits", 0))
                misses = max(0, cur_kv.get("misses", 0)
                             - prev.get("misses", 0))
                if hits + misses > 0:
                    kv_hit = hits / (hits + misses)
                self._prev_kv = cur_kv
        out: Dict[str, Dict[str, Any]] = {}
        summary = self.fleet.registry.role_summary()
        for role in self.fleet.targets:
            d = summary.get(role, {})
            alive = d.get("alive", 0)
            capacity = sum(r.capacity for r in self.fleet.registry.members(role)
                           if r.state == ALIVE)
            outstanding = d.get("outstanding", 0)
            util = (outstanding / capacity) if capacity > 0 else 0.0
            headroom = (d.get("kv_headroom", 0) / alive) if alive else None
            out[role] = {"queue_wait_p99_ms": qw_p99, "util": util,
                         "kv_headroom": headroom, "alive": alive,
                         "warming": d.get("warming", 0),
                         "kv_occupancy": kv_occ, "kv_hit_rate": kv_hit}
        return out

    # -- the control tick --------------------------------------------------

    def step(self, now: Optional[float] = None) -> None:
        """One control tick: retarget each tier from its signals, then
        converge actuals (launch, drain, reap).  Public so tests (and
        the bench) can drive the loop deterministically."""
        now = self._clock() if now is None else now
        with self.fleet.scale_lock:
            signals = self._signals()
            for role in list(self.fleet.targets):
                self._retarget(role, signals.get(role) or {}, now)
                self._converge(role, now)
            self._reap_drained(now)

    def _members(self, role: str):
        """This tier's registry members.  A fleet exposing
        ``tier_members`` (the model-catalog launcher)
        resolves composite ``"<model>/<role>"`` keys there; plain
        fleets keep the direct registry query."""
        tm = getattr(self.fleet, "tier_members", None)
        if tm is not None:
            return tm(role)
        return self.fleet.registry.members(role)

    def _scale_up(self, role: str) -> str:
        """Actuate one tier scale-up; the model trader overrides this
        to prefer warm-pool adoption over a cold launch."""
        return self.fleet.launch_replica(role)

    def _allow_zero(self, role: str) -> bool:
        """Whether this tier may drain its LAST alive replica (the
        scale-to-zero policy); the base loop never does."""
        return False

    def _retarget(self, role: str, sig: Dict[str, Any], now: float) -> None:
        cfg = self.config
        target = self.fleet.targets[role]
        lo, hi = self.fleet.bounds(role)
        # Composite per-(model, tier) keys ("m/decode") resolve their
        # ROLE by suffix — '/' is outside the model-id charset.
        if role.rsplit("/", 1)[-1] == KV:
            # The dedicated KV tier stays pinned at its boot size:
            # storage-only holders produce no queue-wait or
            # utilization signal, so the loop would only ever shrink
            # them — and every shrink throws away parked copies.
            # Convergence (crash relaunch) still runs for the tier.
            return
        if role.rsplit("/", 1)[-1] == DECODE:
            # Decode replicas exhaust KV pages, not rows: headroom is
            # the binding resource.
            headroom = sig.get("kv_headroom")
            util = sig.get("util") or 0.0
            up = headroom is not None and headroom < cfg.kv_headroom_lo
            down = (headroom is not None
                    and headroom > cfg.kv_headroom_hi
                    and util <= cfg.util_lo)
        else:
            qw = sig.get("queue_wait_p99_ms")
            util = sig.get("util") or 0.0
            up = ((qw is not None and qw > cfg.queue_wait_hi_ms)
                  or util > cfg.util_hi)
            down = ((qw is None or qw < cfg.queue_wait_lo_ms)
                    and util < cfg.util_lo)
            # KV-tier pressure (first-class next to queue wait): a
            # saturated tier THRASHING — evicting artifacts the
            # windowed hit rate says traffic still wants — scales up
            # (more replicas = more aggregate tier RAM), and a merely
            # saturated one blocks scale-down (the drained victim's
            # tier capacity would evict more parked sessions).
            kv_occ = sig.get("kv_occupancy")
            kv_hit = sig.get("kv_hit_rate")
            tier_hot = (kv_occ is not None
                        and kv_occ > cfg.kv_tier_occupancy_hi)
            if tier_hot:
                down = False
                if kv_hit is not None \
                        and kv_hit < cfg.kv_tier_hit_rate_lo:
                    up = True
        desired = target
        if up and now - self._last_up.get(role, -1e18) >= cfg.scale_up_cooldown:
            desired = target + 1
        elif (down and not up
              and now - self._last_down.get(role, -1e18)
              >= cfg.scale_down_cooldown):
            desired = target - 1
        # Bounds, and the hard floor: a routable tier never targets 0.
        desired = max(1, max(lo, min(hi, desired)))
        if desired == target:
            return
        direction = "up" if desired > target else "down"
        if direction == "up":
            self._last_up[role] = now
        else:
            self._last_down[role] = now
        self._last_action[role] = f"{direction}:{target}->{desired}"
        self.fleet.set_target(role, desired)
        self.fleet.metrics.inc(f"autoscale_{direction}")
        self.log.info(
            "autoscaler: %s tier target %d -> %d (queue_wait_p99=%s "
            "util=%.2f kv_headroom=%s)", role, target, desired,
            sig.get("queue_wait_p99_ms"), sig.get("util") or 0.0,
            sig.get("kv_headroom"))

    def _converge(self, role: str, now: float) -> None:
        """Drive actual toward target: launch when short (one per tick —
        self-healing of crashed replicas rides this same path), start a
        pinned drain on the least-loaded alive replica when over."""
        target = self.fleet.targets[role]
        pending = [(a, d) for a, d in self._draining.items()
                   if d["role"] == role]
        # Only LIVE draining victims discount "actual": a victim that
        # died mid-drain already left the scheduler's table (the
        # dynamic-death handler removed it), so subtracting its drain
        # record too would undercount the tier and launch a spurious
        # replica — full churn (warmup, then another drain) for
        # nothing.  The pending list itself still gates one-drain-at-
        # a-time below until _reap_drained clears the record.
        members = {r.addr: r for r in self._members(role)}
        live_draining = sum(
            1 for a, _ in pending
            if a in members and members[a].state != DEAD)
        actual = self.fleet.tier_actual(role) - live_draining
        if actual < target:
            node = self._scale_up(role)
            self._last_action[role] = f"launch:{node}"
            self.fleet.metrics.inc("autoscale_launches")
            self.log.info("autoscaler: %s tier %d/%d — launched %s "
                          "(registers warming, routed only once alive)",
                          role, actual, target, node)
            return
        if actual <= target or pending:
            return      # converged, or a drain is already in flight
        alive = [r for r in members.values() if r.state == ALIVE]
        if len(alive) < 2 and not (self._allow_zero(role)
                                   and target < 1):
            # Invariant: never drain a routable tier below one alive
            # replica — even when target says shrink, the LAST alive
            # member waits until its warming replacement (or a peer)
            # is routable.  Scale-to-zero tiers (the model trader's
            # idle models) opt out: their last replica drains away and
            # the next request cold-starts through the warm pool.
            return
        victim = min(alive, key=lambda r: (r.outstanding, r.addr))
        if not self.fleet.registry.begin_drain(victim.addr, pinned=True):
            return
        # Drain-migrate-kill: ask the victim to suspend its in-flight
        # rows so the router re-places them on surviving replicas — the
        # drain flushes promptly and a deadline kill cannot lose work.
        # Best-effort (stub fleets in tests have no migration surface).
        migrate = getattr(self.fleet, "request_migration", None)
        if migrate is not None:
            try:
                migrate(victim.addr)
            except Exception:
                self.log.exception("migrate request to %s failed; its "
                                   "in-flight work drains normally",
                                   victim.addr)
        self._draining[victim.addr] = {
            "role": role, "node": victim.node, "since": now,
            "deadline": now + self.config.drain_timeout}
        self._last_action[role] = f"drain:{victim.addr}"
        self.fleet.metrics.inc("autoscale_drains")
        self.log.info("autoscaler: %s tier %d/%d — draining least-loaded "
                      "%s (outstanding %d; kill after flush)", role,
                      actual, target, victim.addr, victim.outstanding)

    def _reap_drained(self, now: float) -> None:
        """Kill drained victims whose in-flight work has flushed — BOTH
        load signals must read zero: the victim's self-reported
        outstanding (heartbeat-lagged, hence the grace window) and the
        router's own count of requests it still has in flight there (a
        request dispatched right after the victim's last beat is
        invisible to the heartbeat signal) — or whose drain deadline
        passed."""
        router = getattr(self.fleet, "router", None)
        for addr, d in list(self._draining.items()):
            rep = next((r for r in self._members(d["role"])
                        if r.addr == addr), None)
            in_flight = router.outstanding(addr) if router is not None \
                else 0
            flushed = (rep is None or rep.state == DEAD
                       or (rep.outstanding <= 0 and in_flight <= 0
                           and now - d["since"] >= self.config.drain_grace))
            if not flushed and now < d["deadline"]:
                continue
            del self._draining[addr]
            killed = bool(d["node"]) and self.fleet.kill_replica(d["node"])
            if killed or rep is None or rep.state == DEAD:
                self.fleet.metrics.inc("autoscale_kills")
                self._last_action[d["role"]] = f"kill:{addr}"
                self.log.info("autoscaler: reaped drained replica %s "
                              "(%s)", addr,
                              "flushed" if flushed else "drain timeout")
            else:
                # The victim cannot be mapped back to a killable task
                # (no node advertised, or the task vanished): release
                # the pinned drain so its next routable beat revives it
                # — a zombie stuck DRAINING forever would block
                # convergence and get healthy peers drained in its
                # place.
                self.fleet.registry.clear_drain(addr)
                self.fleet.metrics.inc("autoscale_kill_failures")
                self._last_action[d["role"]] = f"kill_failed:{addr}"
                self.log.warning(
                    "autoscaler: cannot kill drained replica %s (node "
                    "%r unknown to the scheduler); drain released",
                    addr, d["node"])

    # -- observability -----------------------------------------------------

    def describe(self) -> Dict[str, Dict[str, Any]]:
        """The ``autoscaler`` gauge: what the loop believes, per tier."""
        out: Dict[str, Dict[str, Any]] = {}
        summary = self.fleet.registry.role_summary()
        for role, target in self.fleet.targets.items():
            d = summary.get(role, {})
            lo, hi = self.fleet.bounds(role)
            out[role] = {
                "target": target,
                "actual": self.fleet.tier_actual(role),
                "alive": d.get("alive", 0),
                "warming": d.get("warming", 0),
                "draining": len([x for x in self._draining.values()
                                 if x["role"] == role]),
                "min": lo, "max": hi,
                "last_action": self._last_action.get(role, ""),
            }
        return out
