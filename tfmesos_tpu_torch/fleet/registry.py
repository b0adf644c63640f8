"""Replica registry: who is serving, how loaded, and are they alive (port of ``tfmesos_tpu/fleet/registry.py``).

Replicas dial the registry and stream heartbeats over the authenticated
wire protocol (the same HMAC framing the rendezvous uses — an
unauthenticated process cannot register itself into the serving path).
Liveness is graded, not boolean:

* ``warming``  — registered and heartbeating with ``status: warming``
  (the replica is still compiling its jitted entry points —
  ``ContinuousBatcher.warmup``); NOT eligible for requests yet.  The
  replica flips itself to alive by simply dropping the status field
  once warmup returns.
* ``alive``    — heartbeating; eligible for new requests.
* ``draining`` — heartbeats stale (or the replica announced a drain);
  no NEW requests are routed, in-flight ones may still finish.
  A drain announcement beats ``warming`` — an exiting replica must
  never re-enter the routable path through a late warming beat window.
* ``dead``     — hard heartbeat timeout, heartbeat-connection EOF (the
  usual signal of process death, since the connection lives inside the
  replica), or the router observed a connection failure.  Dead entries
  are EVICTED from the table after a grace window.

A dead/draining replica that heartbeats again is revived (to alive, or
to warming if the beat still says so) — so a transient network blip
(or an overeager router ``mark_dead``) self-heals instead of requiring
operator action.  A malformed ``status`` field costs the field, not
the beat: the beat still counts for liveness and the state defaults to
alive, exactly like the other optional heartbeat fields.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
from typing import Any, Dict, List, Optional

from tfmesos_tpu_torch import wire
from tfmesos_tpu_torch.utils.logging import get_logger

__all__ = ["WARMING", "ALIVE", "DRAINING", "DEAD", "UNIFIED", "PREFILL",
           "DECODE", "KV", "ROLES", "MODEL_ID_RE", "validate_model_id",
           "ReplicaInfo", "ReplicaRegistry"]

WARMING = "warming"
ALIVE = "alive"
DRAINING = "draining"
DEAD = "dead"


UNIFIED = "unified"
PREFILL = "prefill"
DECODE = "decode"
#: dedicated KV-fabric replicas: jax-free artifact holders (a
#: KVTierStore behind the replica wire surface, no batcher) that park
#: other replicas' sessions — never routable for generate/prefill (no
#: router tier picks the role), but first-choice fabric targets.
KV = "kv"
ROLES = (UNIFIED, PREFILL, DECODE, KV)

#: model ids share ``weights_version``'s charset and for the same
#: reason: the label joins a ``shell=True`` Mode-B replica command
#: line (``--model-id``) and becomes a Prometheus metric-name
#: component, so the charset is a SECURITY boundary, not cosmetics.
#: fullmatch, never match-with-$ ('$' would accept a trailing newline
#: that shell=True reads as a command terminator).
MODEL_ID_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,63}")


def validate_model_id(model_id: str) -> str:
    """The one model-id gate every ingress shares (catalog, CLI,
    gateway op, replica argv); raises ``ValueError`` with the charset
    spelled out."""
    if not isinstance(model_id, str):
        raise TypeError(f"model_id must be a string, got "
                        f"{type(model_id).__name__}")
    if not MODEL_ID_RE.fullmatch(model_id):
        raise ValueError(
            f"model_id {model_id!r} is not a valid label: want 1-64 "
            f"chars of [A-Za-z0-9._-] starting alphanumeric (it joins "
            f"the replica command line and Prometheus metric names, so "
            f"the charset is a security boundary)")
    return model_id


@dataclasses.dataclass
class ReplicaInfo:
    """One serving replica as the registry sees it."""

    addr: str               # host:port the replica serves requests on
    capacity: int = 0       # concurrent rows it can decode
    outstanding: int = 0    # its own in-flight count, self-reported
    state: str = ALIVE
    last_beat: float = 0.0  # monotonic time of the last heartbeat
    # Prefix-cache summary piggybacked on heartbeats ({page, first,
    # seed, hashes} per serving.prefix_cache_summary) — what the
    # router's prefix-affinity choice matches prompts against.  None
    # until the replica advertises one.
    prefix: Optional[dict] = None
    # KV-tier summary (fleet/kvtier.py), another heartbeat field:
    # parked session ids (the router's session-affinity key), spilled
    # prefix digests in the same summary shape as ``prefix`` (so the
    # affinity matcher can steer shared prompts at TIER-resident pages
    # too), plus counters/occupancy for the gateway's kv_tier gauge.
    kv_tier: Optional[dict] = None
    # Speculative-decoding summary piggybacked on heartbeats
    # ({acceptance_rate, rounds, row_rounds, committed, n_draft}) —
    # the draft acceptance rate is THE spec-serving health number, and
    # this is how it becomes visible fleet-wide (the gateway's ``spec``
    # gauge aggregates it).  None until a draft-equipped replica
    # advertises one.
    spec: Optional[dict] = None
    # Disaggregated serving: the replica's advertised tier (prefill /
    # decode / unified — unified when it never says) and its free-KV-
    # page headroom, both heartbeat fields.  Decode-tier routing places
    # imported prefills by headroom; -1 = never advertised.
    role: str = UNIFIED
    kv_headroom: int = -1
    # The replica announced a drain (operator intent, not staleness).
    # While set, a late ``status: warming`` beat must NOT revive the
    # entry — an exiting replica never re-enters through its own
    # warmup; only a plain (routable) beat clears it.
    announced_drain: bool = False
    # Drain-for-scale-down vs drain-for-death: a PINNED drain is set by
    # the control plane (autoscaler shrink, rollout reap) on a replica
    # that is still healthy and heartbeating — its plain alive beats
    # refresh liveness but must NOT revive it to routable while its
    # outstanding work flushes.  The pin dies with the process (a beat
    # after DEAD is a new process) or is reset by a beat carrying a
    # weights_version DIFFERENT from the one pinned (a relaunch with
    # upgraded weights on a reused addr must not inherit a stale drain).
    drain_pinned: bool = False
    pinned_version: str = ""
    # Blue-green rollout identity, both heartbeat fields: the weights
    # version this replica serves (rides the hello and every beat) and
    # the launch generation it was fenced into (the scheduler's epoch,
    # via TPUMESOS_GENERATION); -1 / "" = never advertised.
    weights_version: str = ""
    gen: int = -1
    # The scheduler-side identity ("job:index") of the Mode-B task this
    # replica runs under — how the control plane maps a registry addr
    # back to a killable task.
    node: str = ""
    # Model catalog (docs/SERVING.md "Model catalog"), all heartbeat
    # fields: the model this replica serves ("" = model-less — the
    # single-model fleet of old, or a warm-pool member awaiting
    # adoption), whether it is an undedicated WARM-POOL member (alive
    # and pre-warmed but excluded from every router pick until the
    # trader assigns it a model), and the last adapter delta folded
    # into its weights ("" = base weights) — a suspended mid-stream
    # export may only resume under the SAME adapter version.
    model_id: str = ""
    warm_pool: bool = False
    adapter_version: str = ""
    # Gang replicas (docs/SERVING.md "Gang replicas"), all heartbeat
    # fields carried in one ``gang`` dict on the LEADER's beats: the
    # gang's launch label (scheduler add_gang identity), how many
    # member tasks form the mesh (1 = the single-process replica of
    # old), how many members are currently joined to the leader
    # (-1 = never advertised), and the leader's member-rendezvous
    # address — what ``gang_lookup`` hands a booting member.  The
    # fleet routes to the LEADER only; members never register here.
    gang_id: str = ""
    gang_size: int = 1
    gang_live: int = -1
    gang_coord: str = ""


def _advertises_prefix(rep: "ReplicaInfo") -> int:
    """1 when this entry carries prompt-matchable prefix digests — a
    device prefix-cache summary OR a KV tier's spilled-page summary —
    the quantity the router's O(1) affinity-scan gate counts."""
    if rep.prefix is not None:
        return 1
    if isinstance(rep.kv_tier, dict) and rep.kv_tier.get("prefix"):
        return 1
    return 0


class ReplicaRegistry:
    """Heartbeat listener + liveness sweeper over a replica table.

    ``clock`` is injectable: production runs on ``time.monotonic``; a
    test may drive the table on a virtual clock, delivering beats
    through :meth:`observe` and liveness through :meth:`sweep` without
    ``start()`` (no sockets then)."""

    def __init__(self, token: str = "", host: str = "127.0.0.1",
                 suspect_after: float = 1.5, dead_after: float = 3.0,
                 evict_after: float = 10.0, sweep_interval: float = 0.2,
                 metrics=None, clock=time.monotonic):
        self.token = token
        self.host = host
        self.suspect_after = float(suspect_after)
        self.dead_after = float(dead_after)
        self.evict_after = float(evict_after)
        self.sweep_interval = float(sweep_interval)
        self.metrics = metrics
        self._clock = clock
        self.log = get_logger("tfmesos_tpu_torch.fleet.registry")
        self.addr: Optional[str] = None
        self._server: Optional[wire.WireServer] = None
        self._table: Dict[str, ReplicaInfo] = {}
        self._conns: Dict[str, object] = {}
        # Registered fleet front doors (the `gateways` discovery op):
        # each Gateway registers its addr at start and removes it on a
        # GRACEFUL stop — a killed gateway stays listed (discovery is
        # best-effort; client failover skips dead entries itself).
        # Front-door discovery set.  Values carry liveness: ``None`` is
        # a PERMANENT entry (registered in-process by the launcher —
        # its stop() unregisters it); a float is an EXPIRY deadline for
        # a wire-registered gateway process, refreshed by its periodic
        # ``register_gateway`` frames and swept like a heartbeat — a
        # SIGKILLed gateway process falls out of discovery on its own.
        # Keyed by the LEASE key — the process's private scrape addr
        # when it has one, else the public addr — because with
        # SO_REUSEPORT N processes share ONE public addr and each still
        # needs its own lease (and its own metrics scrape target).
        # Values are (public_addr, expiry-or-None).
        self._gateways: Dict[str, tuple] = {}
        # Membership version + cached routable views: bumped ONLY when
        # the set a router pick iterates could change (entry add/evict,
        # state or role transition) — NOT on per-beat field refreshes
        # (outstanding, kv_headroom), which the cached entries reflect
        # live.  This is what keeps routing O(1) per request at
        # 1000-replica scale instead of copying the whole table per
        # pick (see alive_view).
        self._version = 0
        self._views: Dict[tuple, tuple] = {}
        # Count of entries advertising a prefix-cache summary: the
        # router skips its O(replicas) affinity scan entirely while
        # this is zero (the common non-prefix-cache deployment).
        self._prefix_count = 0
        # Count of warm-pool members: the router's O(1) gate in front
        # of its pool-exclusion filter (a fleet without a warm pool
        # must not pay a per-pick scan for it).
        self._pool_count = 0
        # Generation fence floor: beats stamped with a gen BELOW this
        # are dropped entirely — a straggler of a reaped rollout
        # generation can never re-register and serve stale weights.
        self._min_gen: int = 0
        self._fence_logged: set = set()
        # Per-role replica targets (what the control plane WANTS), shown
        # next to actuals in role_summary so the roles gauge reads as
        # target-vs-actual at a glance.
        self._targets: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ReplicaRegistry":
        # The intake is a WireServer event loop: every heartbeat
        # connection of the whole fleet rides ONE selector thread
        # instead of one blocked-in-recv thread per replica — at
        # 1000-replica scale the thread-per-connection registry was the
        # second front-door ceiling after the gateway (docs/SERVING.md
        # "Front-door scaling").
        self._server = wire.WireServer(
            self._on_msg, token=self.token, host=self.host,
            name="registry", on_close=self._on_conn_close,
            advertise_host=(None if self.host in ("0.0.0.0", "::")
                            else self.host)).start()
        self.addr = self._server.addr
        self.log.info("replica registry listening on %s (event-loop "
                      "I/O)", self.addr)
        s = threading.Thread(target=self._sweep_loop,
                             name="registry-sweep", daemon=True)
        s.start()
        self._threads = [s]
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.stop()
        with self._lock:
            self._conns.clear()
        for t in self._threads:
            t.join(timeout=2.0)

    # -- heartbeat intake --------------------------------------------------

    def _on_msg(self, conn, msg) -> None:
        """Event-loop handler: apply one frame to the table.  A bad
        frame (wrong token, oversize) never reaches here — the
        WireServer's Framer rejects it and drops the connection, same
        pre-auth discipline as the threaded loop had."""
        if isinstance(msg, dict) and msg.get("op") == "gang_lookup":
            # Member rendezvous: a booting gang member polls for its
            # leader's coordination address (the leader advertises it
            # in the ``gang`` field of its beats).  Served on the
            # heartbeat socket — the one address every launched task
            # already knows.
            try:
                conn.send(self.gang_lookup(msg.get("gang_id")))
            except Exception as e:
                self.log.warning("gang_lookup reply failed: %s", e)
            return
        if isinstance(msg, dict) and msg.get("op") in ("kv_peers",
                                                       "kv_locate"):
            # KV-fabric placement queries, served on the heartbeat
            # socket like gang_lookup: ``kv_peers`` lists replication
            # targets, ``kv_locate`` resolves which hosts currently
            # advertise an artifact (the registry-driven placement map
            # that lets a resume find surviving copies after the
            # parker died).
            try:
                if msg["op"] == "kv_peers":
                    conn.send(self.kv_peers())
                else:
                    conn.send(self.kv_locate(msg.get("kind"),
                                             msg.get("key")))
            except Exception as e:
                self.log.warning("%s reply failed: %s", msg["op"], e)
            return
        if isinstance(msg, dict) and msg.get("op") == "registry_view":
            # The multi-process gateway sidecar's poll: the whole table
            # as heartbeat-shaped dicts it replays into its local
            # registry, plus the gateway discovery set.  Served on the
            # heartbeat socket like every other read — a gateway
            # process is just one more wire peer.
            try:
                conn.send(self.registry_view())
            except Exception as e:
                self.log.warning("registry_view reply failed: %s", e)
            return
        if isinstance(msg, dict) and msg.get("op") == "register_gateway":
            # A gateway PROCESS leasing itself into discovery; always
            # TTL'd (clamped) — only the in-process launcher path may
            # create permanent entries, so a wire peer can never park
            # an unreapable address in the discovery set.
            gaddr = msg.get("addr")
            if isinstance(gaddr, str) and gaddr and len(gaddr) <= 256:
                raw_ttl = msg.get("ttl")
                try:
                    ttl = float(raw_ttl) if raw_ttl is not None else 10.0
                except (TypeError, ValueError):
                    ttl = 10.0
                scrape = msg.get("scrape")
                if not (isinstance(scrape, str) and scrape
                        and len(scrape) <= 256):
                    scrape = None
                self.register_gateway(gaddr,
                                      ttl=max(1.0, min(ttl, 300.0)),
                                      scrape=scrape)
                try:
                    conn.send({"op": "gateway_registered", "addr": gaddr})
                except Exception as e:
                    self.log.warning("register_gateway reply failed: %s",
                                     e)
            return
        addr = self.observe(msg, conn)
        if addr is not None:
            # Remember which replica this connection speaks for, so its
            # EOF can be attributed (the earliest death signal).
            conn.replica_addr = addr

    def _on_conn_close(self, conn) -> None:
        if self._stop.is_set():
            return
        addr = getattr(conn, "replica_addr", None)
        if addr is None:
            return
        # The heartbeat connection lives INSIDE the replica process;
        # its EOF is the earliest death signal we get — far ahead of
        # the heartbeat timeout.  (A reconnecting replica re-registers
        # through a new connection, which replaces this one in _conns
        # first.)
        with self._lock:
            stale = self._conns.get(addr) is conn
            if stale:
                del self._conns[addr]
        if stale:
            self.mark_dead(addr, why="heartbeat connection closed")

    def observe(self, msg, conn=None) -> Optional[str]:
        """Apply one registry message (``hello`` / ``heartbeat`` /
        ``drain``) to the table.  The wire path calls this per received
        frame (``conn`` is the event loop's ``WireConn``); a test may
        call it directly with ``conn=None`` and run the same table
        logic, fences and all."""
        if not isinstance(msg, dict):
            return None
        addr = msg.get("addr")
        op = msg.get("op")
        if not addr or op not in ("hello", "heartbeat", "drain"):
            self.log.warning("unexpected registry message: %r", msg)
            return None
        # Optional rollout-identity fields, parsed up front: the
        # generation fence must see ``gen`` before the beat can touch
        # the table, and the pinned-drain reset keys off the beat's
        # ``weights_version``.  Malformed values cost the field, never
        # the beat.
        gen: Optional[int] = None
        if "gen" in msg:
            try:
                gen = int(msg["gen"])
            except (TypeError, ValueError):
                gen = None
        wv: Optional[str] = None
        raw_wv = msg.get("weights_version")
        # bool is an int subclass: True must cost the FIELD (like any
        # malformed value), not coerce to the version label "True" —
        # which could spuriously match the relaunch-with-new-weights
        # heuristic and clear a pinned scale-down drain.
        if (isinstance(raw_wv, (str, int, float))
                and not isinstance(raw_wv, bool)):
            wv = str(raw_wv)
        # The beat's announced state: ``status: warming`` marks a
        # replica still compiling (ContinuousBatcher.warmup) — present
        # and heartbeating, but not routable; anything else (including
        # a malformed status) costs the FIELD, not the beat, and the
        # state defaults to alive like every other optional field.
        target = WARMING if msg.get("status") == WARMING else ALIVE
        with self._lock:
            if gen is not None and gen < self._min_gen:
                # Generation fence (blue-green rollout): this process
                # belongs to a reaped generation — its beats (hello
                # included: a straggler RE-REGISTERING) are dropped
                # whole, so it can never re-enter the table and serve
                # stale weights.  Its entry, if any, goes stale → dead
                # → evicted on the sweeper's clocks.
                if addr not in self._fence_logged:
                    self._fence_logged.add(addr)
                    self.log.warning(
                        "dropping fenced beat from %s (generation %d < "
                        "fence %d): stale-weights straggler", addr, gen,
                        self._min_gen)
                return None
            rep = self._table.get(addr)
            if op == "drain":
                if rep is not None and rep.state in (ALIVE, WARMING):
                    rep.state = DRAINING
                    rep.announced_drain = True
                    self._version += 1
                    self.log.info("replica %s draining", addr)
                return addr
            if rep is None:
                rep = self._table[addr] = ReplicaInfo(addr=addr,
                                                      state=target)
                self._version += 1
                self.log.info("replica %s registered (%s)", addr, target)
            if rep.state == DEAD:
                # A DEAD entry's beat comes from a NEW process on the
                # old addr (or a revived one whose drain is moot) — the
                # announced drain died with the process, so honor the
                # beat's own status: a relaunched replica on a reused
                # port must show as warming, not stay pinned dead.
                rep.announced_drain = False
                rep.drain_pinned = False
            if (rep.drain_pinned and wv is not None
                    and wv != rep.pinned_version):
                # A scale-down drain pins the weights version it was
                # announced against; a beat advertising a DIFFERENT
                # version is a relaunch with upgraded weights on a
                # reused addr — the stale drain must not survive it.
                self.log.info("replica %s drain reset by weights_version "
                              "%s (pinned at %s)", addr, wv,
                              rep.pinned_version)
                rep.drain_pinned = False
                rep.announced_drain = False
            if rep.announced_drain and target == WARMING:
                # Drain beats warming: an exiting replica's late
                # warming beat refreshes liveness but never re-enters
                # the table's routable path.
                target = rep.state
            if rep.drain_pinned and target == ALIVE:
                # Drain-for-scale-down: the replica is healthy and
                # still heartbeating plain (routable) beats while its
                # outstanding work flushes — liveness refreshes, but
                # the control plane's drain is not its to clear.
                target = rep.state
            if rep.state != target:
                self.log.info("replica %s %s -> %s", addr, rep.state,
                              target)
                rep.state = target
                self._version += 1
            if target == ALIVE:
                rep.announced_drain = False
            if gen is not None:
                rep.gen = gen
            if wv is not None:
                rep.weights_version = wv
            if isinstance(msg.get("node"), str):
                rep.node = msg["node"]
            if "capacity" in msg:
                rep.capacity = int(msg["capacity"])
            if "outstanding" in msg:
                rep.outstanding = int(msg["outstanding"])
            if "prefix_cache" in msg or "kv_tier" in msg \
                    or "spec" in msg:
                # Prefix-advertisement accounting only when the beat
                # could change it — the plain liveness beat (the 10k-
                # replica steady state) skips both scans.
                before = _advertises_prefix(rep)
                if isinstance(msg.get("prefix_cache"), dict):
                    rep.prefix = msg["prefix_cache"]
                if isinstance(msg.get("kv_tier"), dict):
                    # A tier advertising spilled prefix digests joins
                    # the affinity-scan gate the same way a device
                    # summary does.
                    rep.kv_tier = msg["kv_tier"]
                if isinstance(msg.get("spec"), dict):
                    rep.spec = msg["spec"]
                self._prefix_count += _advertises_prefix(rep) - before
            if msg.get("role") in ROLES and rep.role != msg["role"]:
                rep.role = msg["role"]
                self._version += 1
            # Model-catalog fields.  A malformed model_id costs the
            # FIELD, not the beat (the optional-field convention) — and the charset check is load-bearing: the
            # value reaches Prometheus metric names and trade logs, so
            # a replica cannot smuggle an arbitrary string into the
            # table by heartbeating it.
            raw_model = msg.get("model_id")
            if isinstance(raw_model, str) \
                    and (raw_model == ""
                         or MODEL_ID_RE.fullmatch(raw_model)) \
                    and rep.model_id != raw_model:
                rep.model_id = raw_model
                self._version += 1      # per-model views change
            if "warm_pool" in msg:
                pool = msg.get("warm_pool") is True
                if rep.warm_pool != pool:
                    rep.warm_pool = pool
                    self._pool_count += 1 if pool else -1
                    self._version += 1
            raw_av = msg.get("adapter_version")
            if isinstance(raw_av, str) \
                    and (raw_av == "" or MODEL_ID_RE.fullmatch(raw_av)):
                rep.adapter_version = raw_av
            if "kv_headroom" in msg:
                try:
                    rep.kv_headroom = int(msg["kv_headroom"])
                except (TypeError, ValueError):
                    pass    # a bad field never costs the beat
            raw_gang = msg.get("gang")
            if isinstance(raw_gang, dict):
                # Gang identity rides the leader's beats as one dict;
                # each sub-field is optional and a malformed sub-field
                # costs THAT field, never the beat (the optional-field
                # convention).  live is clamped to [0, size] — a leader
                # cannot advertise more joined members than the gang
                # has.
                gid = raw_gang.get("id")
                if isinstance(gid, str) and len(gid) <= 128:
                    rep.gang_id = gid
                try:
                    size = int(raw_gang["size"])
                    if size >= 1:
                        rep.gang_size = size
                except (KeyError, TypeError, ValueError):
                    pass
                try:
                    live = int(raw_gang["live"])
                    if live >= 0:
                        rep.gang_live = min(live, rep.gang_size)
                except (KeyError, TypeError, ValueError):
                    pass
                coord = raw_gang.get("coord")
                if isinstance(coord, str) and len(coord) <= 128:
                    rep.gang_coord = coord
            rep.last_beat = self._clock()
            if conn is not None:
                self._conns[addr] = conn
        return addr

    # -- liveness sweeping -------------------------------------------------

    def _sweep_loop(self) -> None:
        while not self._stop.wait(self.sweep_interval):
            self.sweep()

    def sweep(self, now: Optional[float] = None) -> None:
        """One liveness pass over the table (stale → draining → dead →
        evicted).  The sweeper thread runs this every
        ``sweep_interval``; a test may call it directly with its own
        ``now``."""
        now = self._clock() if now is None else now
        with self._lock:
            for addr, rep in list(self._table.items()):
                age = now - rep.last_beat
                if age > self.evict_after:
                    del self._table[addr]
                    self._conns.pop(addr, None)
                    self._prefix_count -= _advertises_prefix(rep)
                    if rep.warm_pool:
                        self._pool_count -= 1
                    self._version += 1
                    self.log.info("replica %s evicted (%s, last beat "
                                  "%.1fs ago)", addr, rep.state, age)
                elif age > self.dead_after and rep.state != DEAD:
                    rep.state = DEAD
                    self._version += 1
                    self.log.warning("replica %s dead (no heartbeat "
                                     "for %.1fs)", addr, age)
                    if self.metrics is not None:
                        self.metrics.inc("replicas_died")
                elif age > self.suspect_after and rep.state == ALIVE:
                    rep.state = DRAINING
                    self._version += 1
                    self.log.warning("replica %s draining (heartbeat "
                                     "stale %.1fs)", addr, age)
            for key in [k for k, (_, exp) in self._gateways.items()
                        if exp is not None and exp <= now]:
                gaddr = self._gateways.pop(key)[0]
                self.log.warning("gateway %s lease expired (process "
                                 "gone?); leaving discovery", gaddr)

    # -- queries / writes --------------------------------------------------

    def alive(self) -> List[ReplicaInfo]:
        """Replicas eligible for NEW requests (copies, race-free).
        This is the ONE routability query every router tier goes
        through — warming replicas are excluded here, so no pick
        (unified, prefill, or decode) can ever select one."""
        with self._lock:
            return [dataclasses.replace(r) for r in self._table.values()
                    if r.state == ALIVE]

    def alive_view(self, roles: tuple) -> List[ReplicaInfo]:
        """The ALIVE members of the given tiers as a CACHED list of
        live table entries — the router's per-request candidate set,
        O(1) amortized at any fleet size.  The list is rebuilt only
        when membership could have changed (state/role transitions,
        adds, evictions — the version bumps above); per-beat field
        refreshes (outstanding, kv_headroom, prefix, weights_version)
        show through the shared entries immediately.  Contract: the
        returned list and its entries are SHARED — callers filter into
        new lists and never mutate (the router does exactly that)."""
        # Lock-free cache hit: dict.get and the int compare are atomic
        # under the GIL, views are REPLACED (never mutated in place),
        # and a stale read costs at worst one pick a one-version-old
        # list — the same staleness any pick already tolerates between
        # heartbeats.  This runs several times per routed request.
        hit = self._views.get(roles)
        if hit is not None and hit[0] == self._version:
            return hit[1]
        with self._lock:
            hit = self._views.get(roles)
            if hit is not None and hit[0] == self._version:
                return hit[1]
            view = [r for r in self._table.values()
                    if r.state == ALIVE and (r.role or UNIFIED) in roles]
            self._views[roles] = (self._version, view)
            return view

    def has_prefix_summaries(self) -> bool:
        """Whether ANY table entry advertises a prefix-cache summary —
        the O(1) gate in front of the router's O(candidates) affinity
        scan (a fleet with no prefix caches must not pay the scan on
        every prompt-bearing request)."""
        return self._prefix_count > 0

    def warming(self) -> List[ReplicaInfo]:
        """Replicas registered but still compiling (copies) — present
        for bring-up accounting and the gateway's gauge, invisible to
        routing."""
        with self._lock:
            return [dataclasses.replace(r) for r in self._table.values()
                    if r.state == WARMING]

    def members(self, role: Optional[str] = None,
                model: Optional[str] = None) -> List[ReplicaInfo]:
        """Every table entry (copies), optionally filtered to one tier
        and/or one model — the control plane's membership query (any
        state, unlike ``alive()``)."""
        with self._lock:
            return [dataclasses.replace(r) for r in self._table.values()
                    if (role is None or (r.role or UNIFIED) == role)
                    and (model is None or r.model_id == model)]

    def has_pool(self) -> bool:
        """Whether ANY table entry is a warm-pool member — the O(1)
        gate in front of the router's pool-exclusion filter."""
        return self._pool_count > 0

    def model_summary(self) -> Dict[str, dict]:
        """Per-model replica counts, aggregate outstanding, and
        adapter-version distribution — the gateway's ``models`` gauge
        (docs/SERVING.md "Model catalog").  Warm-pool members land
        under the ``(pool)`` row; model-less replicas under ``""``
        only when any exist (a model-less fleet reports one anonymous
        row, a catalog fleet none)."""
        out: Dict[str, dict] = {}
        with self._lock:
            for rep in self._table.values():
                label = "(pool)" if rep.warm_pool else rep.model_id
                d = out.setdefault(label, {
                    "alive": 0, "warming": 0, "draining": 0, "dead": 0,
                    "outstanding": 0, "adapters": {}})
                d[rep.state] = d.get(rep.state, 0) + 1
                if rep.state == ALIVE:
                    d["outstanding"] += rep.outstanding
                    av = rep.adapter_version or ""
                    d["adapters"][av] = d["adapters"].get(av, 0) + 1
        return out

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dataclasses.asdict(r) for r in self._table.values()]

    def role_summary(self) -> Dict[str, dict]:
        """Per-role replica counts and aggregate self-reported
        outstanding — exported as the gateway's ``roles`` gauge so
        fleet metrics (and the disagg bench) can assert each tier
        actually exists and served traffic."""
        out: Dict[str, dict] = {}
        with self._lock:
            for rep in self._table.values():
                d = out.setdefault(rep.role or UNIFIED,
                                   {"alive": 0, "warming": 0,
                                    "draining": 0, "dead": 0,
                                    "outstanding": 0, "kv_headroom": 0,
                                    "versions": {}, "gangs": 0,
                                    "gang_members": 0, "gang_live": 0})
                d[rep.state] = d.get(rep.state, 0) + 1
                if rep.gang_size > 1:
                    # Gang replicas: one table entry = one leader = N
                    # member tasks; the member-liveness sum is what an
                    # operator watches during a re-form.
                    d["gangs"] += 1
                    d["gang_members"] += rep.gang_size
                    d["gang_live"] += max(0, rep.gang_live)
                if rep.state == ALIVE:
                    d["outstanding"] += rep.outstanding
                    if rep.kv_headroom > 0:
                        d["kv_headroom"] += rep.kv_headroom
                    # Weights-version distribution of the ROUTABLE tier
                    # members — what an operator watches converge during
                    # a blue-green rollout.
                    v = rep.weights_version or ""
                    d["versions"][v] = d["versions"].get(v, 0) + 1
            for role, target in self._targets.items():
                d = out.setdefault(role, {"alive": 0, "warming": 0,
                                          "draining": 0, "dead": 0,
                                          "outstanding": 0,
                                          "kv_headroom": 0,
                                          "versions": {}, "gangs": 0,
                                          "gang_members": 0,
                                          "gang_live": 0})
                d["target"] = target
        return out

    def gang_lookup(self, gang_id) -> Dict[str, Any]:
        """Resolve one gang's leader-coordination address and launch
        generation (the member-rendezvous reply).  ``found`` stays
        False until the leader's first coord-bearing beat lands — a
        booting member polls."""
        out: Dict[str, Any] = {"op": "gang_info",
                               "gang_id": gang_id if isinstance(
                                   gang_id, str) else "",
                               "found": False}
        if not isinstance(gang_id, str) or not gang_id:
            return out
        with self._lock:
            for rep in self._table.values():
                if (rep.gang_id == gang_id and rep.gang_coord
                        and rep.state != DEAD):
                    out.update(found=True, coord=rep.gang_coord,
                               gen=rep.gen, size=rep.gang_size)
                    break
        return out

    def gang_summary(self) -> Dict[str, Any]:
        """Fleet-wide gang aggregate (the gateway's ``gangs`` gauge —
        a FLAT numeric dict, because the Prometheus exposition only
        flattens one label level): how many gang replicas the table
        holds, their summed member slots, how many members are
        currently joined, and how many gangs run degraded (fewer
        members joined than the mesh needs — the window between a
        member death and the teardown/re-form)."""
        agg = {"gangs": 0, "members": 0, "live": 0, "warming": 0,
               "degraded": 0}
        with self._lock:
            for rep in self._table.values():
                if rep.gang_size <= 1 or rep.state == DEAD:
                    # A dead gang is debris awaiting eviction, not a
                    # serving gang the gauge should count.
                    continue
                agg["gangs"] += 1
                agg["members"] += rep.gang_size
                live = max(0, rep.gang_live)
                agg["live"] += live
                if rep.state == WARMING:
                    agg["warming"] += 1
                elif rep.state == ALIVE and live < rep.gang_size:
                    # Only an ALIVE gang with members missing is
                    # degraded.  A re-forming gang (WARMING with
                    # live < size) already counts under ``warming`` —
                    # counting it degraded too would double-book the
                    # whole re-form window.
                    agg["degraded"] += 1
        return agg

    def kv_tier_summary(self) -> Dict[str, Any]:
        """Fleet-wide KV-tier aggregate (the gateway's ``kv_tier``
        gauge, reachable through ``tfserve metrics`` and the Prometheus
        exposition): summed counters
        (``kv_tier_{hits,misses,spills,promotions,park,resume}`` and
        friends), total occupancy, parked-session count, and how many
        replicas run a tier at all."""
        agg: Dict[str, Any] = {"replicas": 0, "sessions": 0,
                               "ram_bytes_used": 0, "ram_bytes": 0}
        with self._lock:
            for rep in self._table.values():
                kt = rep.kv_tier
                if not isinstance(kt, dict):
                    continue
                agg["replicas"] += 1
                sess = kt.get("sessions")
                if isinstance(sess, list):
                    agg["sessions"] += len(sess)
                for field in ("ram_bytes_used", "ram_bytes"):
                    used = kt.get(field)
                    if isinstance(used, (int, float)) \
                            and not isinstance(used, bool):
                        agg[field] += int(used)
                counters = kt.get("counters")
                if isinstance(counters, dict):
                    for k, v in counters.items():
                        if isinstance(v, (int, float)) \
                                and not isinstance(v, bool):
                            agg[k] = agg.get(k, 0) + int(v)
        return agg

    def kv_peers(self) -> Dict[str, Any]:
        """The KV fabric's replication-target list: every routable
        replica that runs a KV tier, plus every dedicated KV-role
        replica (tier or not — a booting KV holder is still a valid
        push target).  Dedicated holders sort first so ``KVFabric``
        prefers parking on hosts whose whole job is parking.  Reply is
        a plain dict served on the heartbeat socket (see ``_on_msg``)."""
        peers: List[dict] = []
        with self._lock:
            for rep in self._table.values():
                if rep.state not in (ALIVE, DRAINING):
                    continue
                role = rep.role or UNIFIED
                if role != KV and not isinstance(rep.kv_tier, dict):
                    continue
                peer = {"addr": rep.addr, "role": role,
                        "weights_version": rep.weights_version or ""}
                # Heartbeat-advertised tier fullness (0.0..1.0+), the
                # load signal behind ``placement=loaded``: parks drift
                # away from peers whose RAM tier is nearly full.
                kt = rep.kv_tier
                if isinstance(kt, dict):
                    used = kt.get("ram_bytes_used")
                    cap = kt.get("ram_bytes")
                    if isinstance(used, (int, float)) \
                            and isinstance(cap, (int, float)) \
                            and not isinstance(used, bool) \
                            and not isinstance(cap, bool) and cap > 0:
                        peer["occupancy"] = round(float(used)
                                                  / float(cap), 4)
                peers.append(peer)
        peers.sort(key=lambda p: (p["role"] != KV, p["addr"]))
        return {"op": "kv_peers", "peers": peers}

    def registry_view(self) -> Dict[str, Any]:
        """The whole table as HEARTBEAT-SHAPED dicts (plus each entry's
        current ``state`` and the gateway discovery set) — the
        multi-process gateway sidecar polls this and REPLAYS every
        entry into its process-local registry through the normal
        ``observe``/``mark_dead`` surface, so each gateway process
        routes off the same states and fences the central table holds
        without any shared memory.  Optional fields appear only when
        the replica advertised them, mirroring real beats."""
        reps: List[Dict[str, Any]] = []
        with self._lock:
            for rep in self._table.values():
                d: Dict[str, Any] = {
                    "op": "heartbeat", "addr": rep.addr,
                    "state": rep.state, "capacity": rep.capacity,
                    "outstanding": rep.outstanding, "role": rep.role,
                }
                if rep.state == WARMING:
                    d["status"] = WARMING
                if rep.weights_version:
                    d["weights_version"] = rep.weights_version
                if rep.gen >= 0:
                    d["gen"] = rep.gen
                if rep.node:
                    d["node"] = rep.node
                if rep.kv_headroom >= 0:
                    d["kv_headroom"] = rep.kv_headroom
                if isinstance(rep.prefix, dict):
                    d["prefix_cache"] = rep.prefix
                if isinstance(rep.kv_tier, dict):
                    d["kv_tier"] = rep.kv_tier
                if isinstance(rep.spec, dict):
                    d["spec"] = rep.spec
                if rep.model_id:
                    d["model_id"] = rep.model_id
                if rep.warm_pool:
                    d["warm_pool"] = True
                if rep.adapter_version:
                    d["adapter_version"] = rep.adapter_version
                if rep.gang_id or rep.gang_size > 1:
                    d["gang"] = {"id": rep.gang_id,
                                 "size": rep.gang_size,
                                 "live": rep.gang_live,
                                 "coord": rep.gang_coord}
                reps.append(d)
        return {"op": "registry_view", "replicas": reps,
                "gateways": self.gateway_addrs()}

    def kv_locate(self, kind, key) -> Dict[str, Any]:
        """Resolve which hosts currently advertise one artifact — the
        placement map a resume walks after its parker died.  Built
        from the same heartbeat-carried ``kv_tier`` summaries the
        gateway gauges read: a holder that died stops advertising
        within one sweep, so forwarding never dials a corpse for long.
        Session keys match the advertised ``sessions`` list; prefix
        keys the ``prefix.hashes`` list.  Reply always carries an
        ``addrs`` list (possibly empty) — ``KVFabric.locate`` reads
        exactly that key."""
        out: Dict[str, Any] = {"op": "kv_addrs",
                               "kind": kind if isinstance(kind, str)
                               else "",
                               "key": key if isinstance(key, str)
                               else "",
                               "addrs": []}
        if not isinstance(kind, str) or not isinstance(key, str) \
                or not key:
            return out
        with self._lock:
            for rep in self._table.values():
                if rep.state not in (ALIVE, DRAINING):
                    continue
                kt = rep.kv_tier
                if not isinstance(kt, dict):
                    continue
                if kind == "session":
                    held = kt.get("sessions")
                else:
                    pfx = kt.get("prefix")
                    held = pfx.get("hashes") if isinstance(
                        pfx, dict) else None
                if isinstance(held, list) and key in held:
                    out["addrs"].append(rep.addr)
        # Dedicated KV holders first, mirroring kv_peers: they are the
        # cheapest hosts to serve a fetch (no decode work competing).
        with self._lock:
            kv_addrs = {r.addr for r in self._table.values()
                        if (r.role or UNIFIED) == KV}
        out["addrs"].sort(key=lambda a: (a not in kv_addrs, a))
        return out

    def spec_summary(self) -> Dict[str, Any]:
        """Fleet-wide speculative-decoding aggregate (the gateway's
        ``spec`` gauge, reachable through ``tfserve metrics`` and the
        Prometheus exposition): how many replicas serve with a draft,
        summed round/commit counters, and the fleet-wide draft
        ACCEPTANCE RATE — accepted proposals over proposal
        opportunities, recomputed from the per-replica sums so
        replicas with different traffic weigh by their actual rounds.
        ``acceptance_rate`` is present only once a speculative round
        has run somewhere (a dict-gauge key that would be None is
        omitted rather than poisoning the exposition)."""
        agg: Dict[str, Any] = {"replicas": 0, "rounds": 0,
                               "committed": 0}
        row_rounds = 0
        opportunities = 0

        def _int(v):
            return (int(v) if isinstance(v, int)
                    and not isinstance(v, bool) and v >= 0 else None)

        with self._lock:
            for rep in self._table.values():
                sp = rep.spec
                if not isinstance(sp, dict):
                    continue
                agg["replicas"] += 1
                # A replica's counters fold in ATOMICALLY or not at
                # all: summing a malformed replica's committed into
                # the numerator while its row_rounds drop out of the
                # denominator would inflate the fleet rate past 1.0
                # (the mixed-version-fleet shape).
                vals = [_int(sp.get(k)) for k in
                        ("rounds", "committed", "row_rounds",
                         "n_draft")]
                if any(v is None for v in vals):
                    continue
                rounds, committed, rr, nd = vals
                agg["rounds"] += rounds
                agg["committed"] += committed
                row_rounds += rr
                opportunities += rr * nd
        if opportunities > 0:
            agg["acceptance_rate"] = round(
                (agg["committed"] - row_rounds) / opportunities, 4)
        return agg

    def register_gateway(self, addr: str,
                         ttl: Optional[float] = None,
                         scrape: Optional[str] = None) -> None:
        """Record one fleet front door for client-side discovery (the
        gateway's ``gateways`` op hands the set out; multi-gateway
        failover dials down it).  ``ttl`` (seconds) makes the entry
        LEASED — a gateway PROCESS re-registers over the wire on every
        sidecar poll, so a killed process expires out of discovery
        instead of lingering; ``None`` (the in-process default) is
        permanent until :meth:`unregister_gateway`.  ``scrape`` is the
        process's PRIVATE per-process wire address (metrics scrape +
        lease identity): with SO_REUSEPORT every process shares one
        public ``addr``, so the scrape addr is what keeps N leases
        distinct."""
        key = scrape or addr
        with self._lock:
            known = key in self._gateways
            self._gateways[key] = (
                addr, None if ttl is None
                else self._clock() + float(ttl))
        if not known:
            self.log.info(
                "gateway %s registered%s%s", addr,
                "" if ttl is None else f" (ttl {ttl:.0f}s)",
                f" scrape {scrape}" if scrape else "")

    def unregister_gateway(self, addr: str) -> None:
        """Graceful gateway stop: leave the discovery set.  A KILLED
        gateway never calls this — its stale entry is harmless
        (clients skip unreachable addresses while failing over)."""
        with self._lock:
            self._gateways = {k: v for k, v in self._gateways.items()
                              if k != addr and v[0] != addr}

    def set_gateways(self, addrs: List[str]) -> None:
        """Replace the discovery set wholesale — the gateway sidecar
        syncing the CENTRAL registry's view into its process-local
        table, so any gateway process answers the ``gateways`` op with
        the full fleet set (entries here are mirror copies; liveness is
        the central registry's job)."""
        with self._lock:
            self._gateways = {a: (a, None) for a in addrs
                              if isinstance(a, str) and a}

    def gateway_addrs(self) -> List[str]:
        """The registered front doors, stable order, deduplicated
        (SO_REUSEPORT processes share one public addr); expired leases
        excluded — the sweeper reaps them, this just never hands one
        out in the window before it runs."""
        now = self._clock()
        with self._lock:
            return sorted({a for a, exp in self._gateways.values()
                           if exp is None or exp > now})

    def gateway_leases(self) -> List[str]:
        """One dialable address PER GATEWAY PROCESS (the scrape addr
        when the lease carries one, else the public addr) — what the
        launcher's metrics fan-in walks, and how bring-up counts
        processes that share a REUSEPORT public addr."""
        now = self._clock()
        with self._lock:
            return sorted(k for k, (_, exp) in self._gateways.items()
                          if exp is None or exp > now)

    def set_target(self, role: str, n: Optional[int]) -> None:
        """Record the control plane's WANTED replica count for one tier
        (``None`` clears it); surfaces as ``target`` in
        :meth:`role_summary` next to the actual counts."""
        with self._lock:
            if n is None:
                self._targets.pop(role, None)
            else:
                self._targets[role] = int(n)

    def begin_drain(self, addr: str, pinned: bool = True) -> bool:
        """Control-plane drain (autoscaler scale-down, rollout reap):
        the replica leaves the routable path NOW, in-flight work may
        finish.  ``pinned`` (the scale-down default) survives the
        replica's own plain alive beats — a healthy replica being
        shrunk away keeps heartbeating and must not revive itself; the
        pin is recorded against the replica's current weights_version
        so a relaunch with NEWER weights on the same addr resets it.
        False when the addr is unknown."""
        with self._lock:
            rep = self._table.get(addr)
            if rep is None:
                return False
            if rep.state in (ALIVE, WARMING):
                rep.state = DRAINING
                self._version += 1
            rep.announced_drain = True
            if pinned:
                rep.drain_pinned = True
                rep.pinned_version = rep.weights_version
        self.log.info("replica %s draining (%s)", addr,
                      "scale-down, pinned" if pinned else "announced")
        return True

    def clear_drain(self, addr: str) -> None:
        """Cancel a control-plane drain: the next routable beat revives
        the entry.  The autoscaler releases a drain this way when the
        victim cannot be mapped back to a killable task — a replica
        stuck pinned-DRAINING forever would block tier convergence."""
        with self._lock:
            rep = self._table.get(addr)
            if rep is None:
                return
            rep.drain_pinned = False
            rep.announced_drain = False
        self.log.info("replica %s drain cleared", addr)

    def fence_generation(self, min_gen: int) -> None:
        """Raise the generation fence floor: beats (re-registrations
        included) stamped with ``gen < min_gen`` are dropped whole from
        here on — the scheduler's fencing epoch applied to the serving
        path, so a straggler of a reaped rollout generation can never
        serve stale weights.  Monotone: the floor never lowers."""
        with self._lock:
            raised = min_gen > self._min_gen
            if raised:
                self._min_gen = int(min_gen)
                self._fence_logged.clear()
        if raised:
            self.log.info("registry generation fence raised to %d",
                          min_gen)

    def gen_allowed(self, gen) -> bool:
        """Whether a launch generation is at or above the fence floor —
        the router consults this before re-placing a drain-migration's
        suspended KV export, so a reaped-generation zombie's artifact
        can never land on a live replica (the serving-path twin of the
        heartbeat fence above).  Unknown/malformed generations pass:
        the fence rejects provably stale state, absence of a stamp is
        a version-blind deployment."""
        if gen is None:
            return True
        try:
            g = int(gen)
        except (TypeError, ValueError):
            return True
        with self._lock:
            return g >= self._min_gen

    def mark_dead(self, addr: str, why: str = "reported by router") -> None:
        """Out-of-band death report (router connection failure).  The
        next heartbeat revives the entry if the replica is in fact
        fine."""
        with self._lock:
            rep = self._table.get(addr)
            if rep is None or rep.state == DEAD:
                return
            rep.state = DEAD
            self._version += 1
        self.log.warning("replica %s marked dead: %s", addr, why)
        if self.metrics is not None:
            self.metrics.inc("replicas_died")

    def wait_for(self, n: int, timeout: float = 60.0) -> bool:
        """Block until ``n`` replicas are alive (fleet bring-up)."""
        deadline = self._clock() + timeout
        while self._clock() < deadline:
            if len(self.alive()) >= n:
                return True
            if self._stop.wait(0.05):
                return False
        return len(self.alive()) >= n
