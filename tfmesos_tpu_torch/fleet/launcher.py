"""Fleet bring-up: registry + gateway + dynamically launched replicas
(port of ``tfmesos_tpu/fleet/launcher.py``).

``FleetServer`` is the one-object front: it mints a cluster token,
starts the registry and the gateway in process, then launches the
replicas as **Mode-B tasks through the backend abstraction**
(``LocalBackend``: subprocesses of this host).  Each replica task runs
``python -m tfmesos_tpu_torch.server``, which execs
``python -m tfmesos_tpu_torch.fleet.replica``: the port replica, on the
card unless the fleet was built with ``device="cpu"``.  The scheduler,
registry and gateway share one token, delivered to the replicas as a
mode-0600 token file, so every hop of the serving path is authenticated
with the same secret.

Replica membership is a runtime property: the scheduler runs in dynamic
mode with an initially empty task table, and each tier converges toward
a target count — ``launch_replica`` / ``kill_replica`` grow and shrink
it one Mode-B task at a time.  Replica death is a serving event, not a
cluster event: the router routes around a dead replica.

The KV tier rides the replica command line: ``kv_tier_mb`` gives every
replica a RAM tier and, unless ``kv_tier_dir`` names one, one disk
directory the fleet creates and removes on stop, which its replicas
share (a session parked by one resumes on another); ``kv_replication``
and ``kv_placement`` set the fabric's copies, and ``kv_replicas``
launches that many ``--role kv`` holders (capacity 0, never routed).

Not ported yet, refused by name at construction (each with its ROADMAP
item): the autoscaler, the model catalog with its warm pool and trader,
gang replicas, speculative decoding, gateway processes, the HTTP edge,
the offline lane and the Mesos master.  Blue-green rollouts
(``rollout``) wait too.
"""

from __future__ import annotations

import re
import sys
import threading
import time
from typing import Dict, List, Optional

from tfmesos_tpu_torch import wire
from tfmesos_tpu_torch.fleet.admission import AdmissionController, PriorityClass
from tfmesos_tpu_torch.fleet.client import FleetClient
from tfmesos_tpu_torch.fleet.gateway import Gateway
from tfmesos_tpu_torch.fleet.metrics import FleetMetrics
from tfmesos_tpu_torch.fleet.registry import (ALIVE, DEAD, DECODE, KV,
                                              PREFILL, UNIFIED,
                                              ReplicaRegistry)
from tfmesos_tpu_torch.fleet.router import Router
from tfmesos_tpu_torch.fleet.tracing import TraceBook
from tfmesos_tpu_torch.scheduler import (MAX_FAILURE_COUNT, ClusterError,
                                         TPUMesosScheduler)
from tfmesos_tpu_torch.utils.logging import get_logger

__all__ = ["FleetServer", "NotPorted", "TIER_JOBS",
           "validate_kv_tier_dir"]

#: tier role -> the scheduler job name its Mode-B tasks launch under.
TIER_JOBS = {UNIFIED: "replica", PREFILL: "prefill", DECODE: "decode",
             KV: "kv"}

#: weights_version labels join the replica command line (shell=True).
_VERSION_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,63}")

#: the KV tier's directory joins the same command line: a conservative
#: path charset, no whitespace or shell metacharacters, no leading '-'.
_KV_DIR_RE = re.compile(r"[A-Za-z0-9/._~][A-Za-z0-9/._~+-]{0,255}")


def validate_kv_tier_dir(path: str) -> str:
    path = str(path)
    if not _KV_DIR_RE.fullmatch(path):
        raise ValueError(
            f"kv_tier_dir {path!r} is not a safe path: want 1-256 "
            f"chars of [A-Za-z0-9/._~+-] not starting with '-' or '+' "
            f"(it joins the replica command line, so the charset is a "
            f"security boundary)")
    return path

#: the JAX FleetServer's options that wait: name -> (what, ROADMAP item,
#: the value that asks for nothing).  Passing any other value refuses.
_NOT_PORTED = {
    "autoscale": ("autoscale, the fleet autoscaler", "A.12", False),
    "min_replicas": ("min_replicas, the autoscaler's floor", "A.12", None),
    "max_replicas": ("max_replicas, the autoscaler's ceiling", "A.12",
                     None),
    "autoscale_config": ("autoscale_config", "A.12", None),
    "models": ("models, the model catalog", "A.12", None),
    "warm_pool": ("warm_pool, the catalog's warm pool", "A.12", 0),
    "model_budget": ("model_budget, the catalog's budget", "A.12", None),
    "trader_config": ("trader_config, the model trader", "A.12", None),
    "gang_size": ("gang_size above 1, gang replicas", "A.9", 1),
    "draft": ("draft, speculative decoding", "A.8", False),
    "n_draft": ("n_draft, speculative decoding", "A.8", 4),
    "gateway_processes": ("gateway_processes, gateway processes",
                          "A.12", 0),
    "http_port": ("http_port, the HTTP edge", "A.12", None),
    "batch_lane": ("batch_lane, the offline lane", "A.12", False),
    "master": ("master, the Mesos backend", "A.12", None),
}


class NotPorted(ValueError):
    """A fleet option whose machinery the port does not have yet."""


def _refuse(what: str, item: str) -> None:
    raise NotPorted(f"not ported yet: {what} (ROADMAP {item})")


class FleetServer:
    """Bring up (and tear down) a whole serving fleet of port replicas.

    ``device`` is the replicas' device: ``None`` is the card (a machine
    without one fails at bring-up with the replica's error); ``"cpu"``
    appends ``--device cpu`` to every replica command."""

    def __init__(self, replicas: int = 2, rows: int = 4,
                 tiny: bool = False, seed: int = 0,
                 max_len: Optional[int] = None,
                 page_size: Optional[int] = None,
                 prefill_bucket: Optional[int] = None,
                 multi_step: int = 1,
                 prefix_cache_pages: int = 0,
                 pipeline_depth: int = 0,
                 fused_prefill: bool = False,
                 tokens_per_tick: Optional[int] = None,
                 warmup: bool = False,
                 kv_tier_mb: float = 0.0,
                 kv_tier_dir: Optional[str] = None,
                 kv_replication: int = 1,
                 kv_placement: str = "rendezvous",
                 kv_replicas: int = 0,
                 prefill_replicas: int = 0,
                 decode_replicas: int = 0,
                 device: Optional[str] = None,
                 weights_version: str = "v0",
                 backend=None,
                 replica_cpus: float = 1.0, replica_mem: float = 1024.0,
                 replica_chips: int = 0,
                 gateway_host: str = "127.0.0.1", gateway_port: int = 0,
                 gateways: int = 1,
                 workers: int = 8, max_queue: int = 64,
                 rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 priority_classes: Optional[List[PriorityClass]] = None,
                 migrate_on_drain: bool = True,
                 breakers: bool = True,
                 max_retries: int = 2, request_timeout: float = 120.0,
                 start_timeout: float = 300.0,
                 heartbeat_interval: float = 0.3,
                 report_interval: Optional[float] = None,
                 metrics_port: Optional[int] = None,
                 trace_sample: float = 0.05,
                 trace_slow_ms: float = 1000.0,
                 quiet: bool = True, token: Optional[str] = None,
                 **not_ported):
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"FleetServer got an unexpected keyword "
                                f"argument {name!r}")
            what, item, default = _NOT_PORTED[name]
            if value != default:
                _refuse(what, item)
        if min(replicas, prefill_replicas, decode_replicas) < 0:
            raise ValueError(
                f"replica counts must be >= 0, got replicas={replicas} "
                f"prefill_replicas={prefill_replicas} "
                f"decode_replicas={decode_replicas}")
        if (prefill_replicas > 0) != (decode_replicas > 0):
            raise ValueError(
                f"prefill_replicas and decode_replicas come together — "
                f"a lone tier cannot serve the disaggregated handoff "
                f"(got prefill_replicas={prefill_replicas}, "
                f"decode_replicas={decode_replicas})")
        if replicas + prefill_replicas + decode_replicas < 1:
            raise ValueError(
                f"the fleet needs at least one replica, got "
                f"replicas={replicas} + prefill_replicas="
                f"{prefill_replicas} + decode_replicas={decode_replicas}")
        if device not in (None, "cpu"):
            raise ValueError(f"device must be None or 'cpu', got {device!r}")
        self.replicas = int(replicas)
        self.prefill_replicas = int(prefill_replicas)
        self.decode_replicas = int(decode_replicas)
        self.device = device
        # The label joins the replica command line, which Mode-B agents
        # run with shell=True: only a fixed charset may pass.
        if not _VERSION_RE.fullmatch(str(weights_version)):
            raise ValueError(
                f"weights_version {weights_version!r} is not a valid "
                f"label: want 1-64 chars of [A-Za-z0-9._-] starting "
                f"alphanumeric (it joins the replica command line)")
        self.weights_version = str(weights_version)
        self.rows = int(rows)
        self.tiny = bool(tiny)
        self.seed = int(seed)
        self.max_len = max_len
        self.page_size = page_size
        self.prefill_bucket = prefill_bucket
        self.multi_step = int(multi_step)
        self.prefix_cache_pages = int(prefix_cache_pages)
        self.pipeline_depth = int(pipeline_depth)
        self.fused_prefill = bool(fused_prefill)
        self.tokens_per_tick = (None if tokens_per_tick is None
                                else int(tokens_per_tick))
        if self.tokens_per_tick is not None and self.tokens_per_tick < 1:
            raise ValueError(f"tokens_per_tick must be >= 1, got "
                             f"{tokens_per_tick}")
        self.warmup = bool(warmup)
        # The KV tier and fabric (each value joins the replica command
        # line, so each is validated: ints, a closed set, a path
        # charset).  kv_tier_mb > 0 without a directory shares one the
        # fleet creates at start and removes at stop.
        if kv_tier_mb < 0:
            raise ValueError(f"kv_tier_mb must be >= 0, got {kv_tier_mb}")
        self.kv_tier_mb = float(kv_tier_mb)
        self.kv_tier_dir = (validate_kv_tier_dir(kv_tier_dir)
                            if kv_tier_dir is not None else None)
        self._kv_tier_tmp: Optional[str] = None
        self.kv_replication = int(kv_replication)
        if not 1 <= self.kv_replication <= 8:
            raise ValueError(
                f"kv_replication must be in [1, 8], got {kv_replication}")
        if kv_placement not in ("rendezvous", "loaded"):
            raise ValueError(f"kv_placement must be 'rendezvous' or "
                             f"'loaded', got {kv_placement!r}")
        self.kv_placement = kv_placement
        self.kv_replicas = int(kv_replicas)
        if self.kv_replicas < 0:
            raise ValueError(
                f"kv_replicas must be >= 0, got {kv_replicas}")
        if self.kv_replicas and self.kv_tier_mb <= 0:
            raise ValueError(
                "dedicated KV-role replicas hold tier artifacts — they "
                "need kv_tier_mb > 0")
        self.backend = backend
        self.replica_cpus = float(replica_cpus)
        self.replica_mem = float(replica_mem)
        self.replica_chips = int(replica_chips)
        self.gateway_host = gateway_host
        self.gateway_port = int(gateway_port)
        #: N stateless in-process gateways over ONE shared registry/
        #: router/admission view; the first listens on ``gateway_port``,
        #: the rest on OS-assigned ports, all discoverable through the
        #: ``gateways`` op.
        self.n_gateways = int(gateways)
        if self.n_gateways < 1:
            raise ValueError(f"gateways must be >= 1, got {gateways}")
        self.workers = int(workers)
        self.max_queue = int(max_queue)
        self.rate = rate
        self.burst = burst
        #: admission priority classes (weighted-fair queues at the
        #: gateway + preemption ranks inside the replicas); None = one
        #: default class.
        self.priority_classes = list(priority_classes) \
            if priority_classes else None
        #: drain-migrate-kill: a pinned drain asks the victim to SUSPEND
        #: its in-flight rows so the router re-places them on survivors.
        self.migrate_on_drain = bool(migrate_on_drain)
        self.breakers = bool(breakers)
        self.max_retries = int(max_retries)
        self.request_timeout = float(request_timeout)
        self.start_timeout = float(start_timeout)
        self.heartbeat_interval = float(heartbeat_interval)
        self.report_interval = report_interval
        #: optional stdlib-HTTP Prometheus exposition (GET /metrics on
        #: loopback); None = no endpoint.
        self.metrics_port = metrics_port
        self.trace_sample = float(trace_sample)
        self.trace_slow_ms = float(trace_slow_ms)
        self.quiet = quiet
        self.log = get_logger("tfmesos_tpu_torch.fleet", quiet=quiet)

        # An explicit token lets external clients authenticate; by
        # default each bring-up mints its own.
        self._token = token
        self.token: Optional[str] = None
        self.metrics: Optional[FleetMetrics] = None
        self.tracebook: Optional[TraceBook] = None
        self._metrics_http = None
        self.registry: Optional[ReplicaRegistry] = None
        self.router: Optional[Router] = None
        self.admission: Optional[AdmissionController] = None
        self.gateway: Optional[Gateway] = None
        #: every running front door (``gateway`` is ``gateways[0]``).
        self.gateways: List[Gateway] = []
        self.scheduler: Optional[TPUMesosScheduler] = None
        #: per-tier replica targets: what the control plane wants;
        #: bring-up drives the actuals toward these.
        self.targets: Dict[str, int] = {}
        #: serializes scaling decisions (launch/kill from any thread).
        self.scale_lock = threading.RLock()
        self._started = False

    # -- bring-up ----------------------------------------------------------

    def _replica_cmd(self, role: str = UNIFIED) -> str:
        parts = [sys.executable, "-m", "tfmesos_tpu_torch.fleet.replica",
                 "--registry", self.registry.addr,
                 "--rows", str(self.rows),
                 "--seed", str(self.seed),
                 "--heartbeat-interval", str(self.heartbeat_interval)]
        if role != UNIFIED:
            parts += ["--role", role]
        if self.weights_version:
            parts += ["--weights-version", self.weights_version]
        if self.tiny:
            parts.append("--tiny")
        if self.device == "cpu":
            parts += ["--device", "cpu"]
        if self.max_len is not None:
            parts += ["--max-len", str(int(self.max_len))]
        if self.page_size is not None:
            parts += ["--page-size", str(int(self.page_size))]
        if self.prefill_bucket is not None:
            parts += ["--prefill-bucket", str(int(self.prefill_bucket))]
        if self.multi_step != 1:
            parts += ["--multi-step", str(self.multi_step)]
        if self.prefix_cache_pages:
            parts += ["--prefix-cache-pages", str(self.prefix_cache_pages)]
        if self.pipeline_depth:
            parts += ["--pipeline-depth", str(self.pipeline_depth)]
        if self.fused_prefill:
            parts.append("--fused-prefill")
        if self.tokens_per_tick is not None:
            parts += ["--tokens-per-tick", str(self.tokens_per_tick)]
        if self.kv_tier_mb > 0:
            parts += ["--kv-tier-mb", str(self.kv_tier_mb)]
            tier_dir = self.kv_tier_dir or self._kv_tier_tmp
            if tier_dir:
                parts += ["--kv-tier-dir", tier_dir]
        elif self.kv_tier_dir:
            parts += ["--kv-tier-dir", self.kv_tier_dir]
        if self.kv_replication > 1:
            parts += ["--kv-replication", str(self.kv_replication)]
        if self.kv_placement != "rendezvous":
            parts += ["--kv-placement", self.kv_placement]
        if self.warmup:
            # Every launch of this cmd — boot or a later relaunch —
            # registers warming, captures its graphs, then takes traffic.
            parts.append("--warmup")
        return " ".join(parts)

    def fleet_snapshot(self) -> dict:
        """The fleet-level metrics snapshot (one process holds every
        gateway, so it is :meth:`snapshot`)."""
        return self.snapshot()

    def start(self) -> "FleetServer":
        self.token = self._token or wire.new_token()
        self.metrics = FleetMetrics()
        if self.kv_tier_mb > 0 and self.kv_tier_dir is None \
                and self._kv_tier_tmp is None:
            import tempfile

            # One disk tier for every replica of this host: a parked
            # session resumes on any same-version sibling.  mkdtemp is
            # mode 0700 and entries are HMAC-framed with the token.
            self._kv_tier_tmp = tempfile.mkdtemp(prefix="tfserve-kvtier-")
        try:
            # Liveness thresholds scale with the heartbeat cadence: a
            # slower (legal) interval must not make healthy replicas
            # flap alive -> draining between beats.
            hb = self.heartbeat_interval
            self.registry = ReplicaRegistry(
                token=self.token, metrics=self.metrics,
                suspect_after=max(1.5, 5.0 * hb),
                dead_after=max(3.0, 10.0 * hb),
                evict_after=max(10.0, 20.0 * hb)).start()
            self.router = Router(self.registry, self.metrics,
                                 token=self.token,
                                 max_retries=self.max_retries,
                                 request_timeout=self.request_timeout,
                                 breakers=self.breakers)
            self.admission = AdmissionController(
                max_queue=self.max_queue, rate=self.rate,
                burst=self.burst, classes=self.priority_classes)
            self.tracebook = TraceBook(sample=self.trace_sample,
                                       slow_ms=self.trace_slow_ms)
            # N stateless gateways over the ONE registry/router/
            # admission/tracebook view; the router's lifecycle is the
            # launcher's (close_router=False).
            self.gateways = []
            for i in range(self.n_gateways):
                gw = Gateway(self.router, self.admission, self.metrics,
                             token=self.token, host=self.gateway_host,
                             port=self.gateway_port if i == 0 else 0,
                             workers=self.workers,
                             registry=self.registry,
                             tracebook=self.tracebook,
                             close_router=False).start()
                self.gateways.append(gw)
            self.gateway = self.gateways[0]
            if self.metrics_port is not None:
                self._metrics_http = self.metrics.start_http_server(
                    self.metrics_port)
                self.log.info(
                    "prometheus exposition on :%d/metrics",
                    self._metrics_http.server_address[1])
            # The scheduler starts EMPTY in dynamic mode: every replica,
            # boot ones included, goes through launch_replica.
            self.scheduler = TPUMesosScheduler(
                [], dynamic=True, backend=self.backend,
                quiet=self.quiet, start_timeout=self.start_timeout,
                token=self.token)
            self.scheduler.on_dynamic_death = self._on_dynamic_death
            self.scheduler.start()
            for role, n in ((UNIFIED, self.replicas),
                            (PREFILL, self.prefill_replicas),
                            (DECODE, self.decode_replicas)):
                if n:
                    self.set_target(role, n)
                    for _ in range(n):
                        self.launch_replica(role)
            if self.kv_replicas:
                # Dedicated KV holders converge like a tier (a crashed one
                # relaunches at bring-up) but heartbeat capacity 0: the
                # router never sends them tokens.
                self.set_target(KV, self.kv_replicas)
                for _ in range(self.kv_replicas):
                    self.launch_replica(KV)
            self._wait_replicas()
        except Exception:
            self.stop()
            raise
        self._started = True
        if self.report_interval:
            self.metrics.start_reporter(self.log, self.report_interval)
        self.log.info("fleet up: gateway%s %s, %d replica(s) "
                      "(%d unified / %d prefill / %d decode), %d KV "
                      "holder(s)", "s" if self.n_gateways > 1 else "",
                      ", ".join(self.addrs),
                      self.total_replicas, self.replicas,
                      self.prefill_replicas, self.decode_replicas,
                      self.kv_replicas)
        return self

    @property
    def total_replicas(self) -> int:
        return self.replicas + self.prefill_replicas + self.decode_replicas

    # -- dynamic tier management -------------------------------------------

    def set_target(self, role: str, n: int) -> None:
        """Record one tier's wanted replica count (mirrored into the
        registry so the ``roles`` gauge shows target vs actual)."""
        self.targets[role] = int(n)
        self.registry.set_target(role, int(n))

    def launch_replica(self, role: str) -> str:
        """Launch ONE new Mode-B replica for tier ``role`` and return its
        node id ("job:index"); with ``warmup`` it registers ``warming``
        and never takes traffic cold."""
        job = TIER_JOBS[role]
        with self.scale_lock:
            task = self.scheduler.add_task(
                job, cmd=self._replica_cmd(role), cpus=self.replica_cpus,
                mem=self.replica_mem, chips=self.replica_chips)
        return f"{job}:{task.task_index}"

    def kill_replica(self, node: str) -> bool:
        """Kill one replica by its node id ("job:index")."""
        job, _, idx = node.rpartition(":")
        try:
            task = self.scheduler.task_by_index(job, int(idx))
        except ValueError:
            return False
        if task is None:
            return False
        with self.scale_lock:
            return self.scheduler.remove_task(task.id)

    def _on_dynamic_death(self, task) -> None:
        """Scheduler death hook (on its own thread): a replica process
        died.  The router already routes around it; the fleet records
        the death (``replica_deaths``) and relaunches nothing — the JAX
        fleet relaunches only from its autoscaler (not ported yet)."""
        if self.metrics is not None:
            self.metrics.inc("replica_deaths")
        self.log.warning("replica task %s:%d died; routing around it",
                         task.job_name, task.task_index)

    def tier_actual(self, role: str) -> int:
        """Live tasks launched for one tier, registered or not."""
        return len(self.scheduler.tasks_of(TIER_JOBS[role]))

    def tier_members(self, role: str):
        """Registry members of one tier."""
        return self.registry.members(role)

    def _alive_of(self, role: str) -> int:
        return sum(1 for r in self.registry.members(role)
                   if r.state == ALIVE)

    def request_migration(self, addr: str) -> bool:
        """Ask one replica to SUSPEND its in-flight rows: the victim
        answers each pending generate with a ``suspended`` export the
        router re-places on a survivor, so a drain flushes in one round
        trip instead of a generation's tail.  Best-effort: any failure
        leaves the plain drain (the victim keeps finishing its rows)."""
        if not self.migrate_on_drain or self.router is None:
            return False
        msg: dict = {"op": "migrate"}
        try:
            # Broker a direct-stream target up front: the victim pushes
            # each suspended artifact straight at the survivor and the
            # router adopts it by reference; with no eligible survivor
            # the artifacts relay through the router.
            target = self.router.migration_target(addr)
            if target:
                msg["push_to"] = target
        except Exception:
            pass
        try:
            self.router.control(addr, msg, timeout=30.0)
        except Exception as e:
            self.log.warning("migrate request to %s failed (%s); its "
                             "in-flight work drains normally", addr, e)
            return False
        self.metrics.inc("migrations_requested")
        return True

    def _drain_and_flush(self, reps, drain_timeout: float) -> None:
        """Pinned drains on every given replica (healthy members keep
        heartbeating while their in-flight work finishes), a migrate
        request to each, then wait until both flush signals read zero
        for all of them — the heartbeat-reported outstanding and the
        router's own in-flight count — or the drain deadline passes."""
        addrs = [r.addr for r in reps]
        for r in reps:
            self.registry.begin_drain(r.addr, pinned=True)
        for r in reps:
            self.request_migration(r.addr)
        deadline = time.monotonic() + float(drain_timeout)
        while addrs and time.monotonic() < deadline:
            table = {m.addr: m for m in self.registry.members()}
            busy = any(
                (table.get(a) is not None and table[a].state != DEAD
                 and table[a].outstanding > 0)
                or self.router.outstanding(a) > 0
                for a in addrs)
            if not busy:
                return
            time.sleep(0.05)

    def _wait_replicas(self) -> None:
        """Target-based bring-up: every tier must reach its target alive
        count.  Boot crashes are relaunched up to the scheduler's
        per-task failure budget scaled by the tier size, so a
        crash-looping replica cmd fails the bring-up loudly instead of
        idling to timeout."""
        deadline = time.monotonic() + self.start_timeout
        while time.monotonic() < deadline:
            # finished() raises ClusterError on backend-fatal errors.
            self.scheduler.finished()
            if all(self._alive_of(role) >= n
                   for role, n in self.targets.items()):
                return
            for role, n in self.targets.items():
                job = TIER_JOBS[role]
                fails = self.scheduler.dynamic_failures.get(job, 0)
                if fails >= MAX_FAILURE_COUNT * max(1, n):
                    raise ClusterError(
                        f"replica job {job!r} failed {fails} times "
                        f"during fleet bring-up")
                for _ in range(n - self.tier_actual(role)):
                    self.log.warning("bring-up relaunch of a crashed "
                                     "%s replica", role)
                    self.launch_replica(role)
            time.sleep(0.1)
        warming = len(self.registry.warming())
        counts = {role: self._alive_of(role) for role in self.targets}
        raise ClusterError(
            f"replicas routable after {self.start_timeout:.0f}s: "
            f"{counts} of targets {self.targets}"
            + (f" ({warming} still warming — raise start_timeout for "
               f"slow captures)" if warming else ""))

    # -- surface -----------------------------------------------------------

    @property
    def addr(self) -> Optional[str]:
        return self.gateway.addr if self.gateway is not None else None

    @property
    def addrs(self) -> List[str]:
        """Every front door's address."""
        return [gw.addr for gw in self.gateways if gw.addr]

    def client(self, timeout: float = 120.0) -> FleetClient:
        """A client over every gateway: one connection at a time, failing
        over to a surviving gateway (replaying idempotent in-flight
        generates) when its own dies."""
        return FleetClient(self.addrs or [self.addr], self.token,
                           timeout=timeout)

    def snapshot(self) -> dict:
        """The fleet metrics snapshot; the ``roles`` gauge carries each
        tier's target vs actual counts."""
        return self.metrics.snapshot() if self.metrics is not None else {}

    # -- teardown ----------------------------------------------------------

    def stop(self) -> None:
        self._started = False
        if self.metrics is not None:
            self.metrics.stop_reporter()
        if self._metrics_http is not None:
            self._metrics_http.shutdown()
            self._metrics_http.server_close()
            self._metrics_http = None
        for gw in self.gateways:
            if not gw.killed:
                gw.stop()
        self.gateways = []
        self.gateway = None
        # The gateways share the router (close_router=False); its links
        # close exactly once, here.
        if self.router is not None:
            self.router.close()
            self.router = None
        if self.scheduler is not None:
            # Teardown kills are deliberate: no death hook fires for them.
            self.scheduler.on_dynamic_death = None
            self.scheduler.stop()
            self.scheduler = None
        if self.registry is not None:
            self.registry.stop()
            self.registry = None
        if self._kv_tier_tmp is not None:
            import shutil

            shutil.rmtree(self._kv_tier_tmp, ignore_errors=True)
            self._kv_tier_tmp = None

    def __enter__(self) -> "FleetServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

