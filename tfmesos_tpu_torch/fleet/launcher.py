"""Fleet bring-up: registry + gateway + dynamically launched replicas
(port of ``tfmesos_tpu/fleet/launcher.py``).

``FleetServer`` is the one-object front: it mints a cluster token,
starts the registry and the gateway in process, then launches the
replicas as **Mode-B tasks through the backend abstraction**
(``LocalBackend``, subprocesses of this host, or ``MesosBackend`` for
a ``master``).  Each replica task runs
``python -m tfmesos_tpu_torch.server``, which execs
``python -m tfmesos_tpu_torch.fleet.replica``: the port replica, on the
card unless the fleet was built with ``device="cpu"``.  The scheduler,
registry and gateway share one token, delivered to the replicas as a
mode-0600 token file, so every hop of the serving path is authenticated
with the same secret.

Replica membership is a runtime property: the scheduler runs in dynamic
mode with an initially empty task table, and each tier converges toward
a target count — ``launch_replica`` / ``kill_replica`` grow and shrink
it one Mode-B task at a time, ``autoscale`` hands the targets to a
:class:`~tfmesos_tpu_torch.fleet.autoscaler.FleetAutoscaler` feedback
loop, and :meth:`FleetServer.rollout` replaces a whole tier's weights
blue-green with zero downtime (launch new-version replicas, warm them,
shift the router's version preference, bake, drain, reap — with the
registry's generation fence keeping reaped-generation stragglers out of
the serving path).  Replica death is a serving event, not a cluster
event: the router routes around a dead replica and, with the
autoscaler on, the convergence loop relaunches it.

``models`` makes the fleet a model catalog: each
:class:`~tfmesos_tpu_torch.fleet.catalog.ModelSpec` entry is a
per-(model, tier) target keyed ``"<model_id>/unified"``, a
``warm_pool`` of undedicated pre-warmed replicas adopts a model on
first demand, and a :class:`~tfmesos_tpu_torch.fleet.catalog.
ModelTrader` reallocates one ``model_budget`` between the models;
``swap_adapter`` hot-swaps a weight delta onto one model's replicas.

The KV tier rides the replica command line: ``kv_tier_mb`` gives every
replica a RAM tier and, unless ``kv_tier_dir`` names one, one disk
directory the fleet creates and removes on stop, which its replicas
share (a session parked by one resumes on another); ``kv_replication``
and ``kv_placement`` set the fabric's copies, and ``kv_replicas``
launches that many ``--role kv`` holders (capacity 0, never routed).
``draft`` / ``n_draft`` serve every replica speculatively (``--draft
--n-draft``: the preset's draft model); ``int8`` (the port's own)
serves int8 weights over an int8 page pool.

``gang_size`` > 1 makes every unified replica a GANG: N member tasks
placed all-or-nothing by ``add_gang`` and routed as ONE replica, the
leader (``fleet/gang.py``: members mirror-execute every request and ack
token digests).  A member's death tears the gang down whole, bumps the
scheduler generation and re-forms it under a fresh gang id
(``gang_reforms``); a catalog entry's own ``gang_size`` does the same
for its model, each gang costing that many slots of the budget.

``gateway_processes`` > 0 runs the front door as N ``python -m
tfmesos_tpu_torch.fleet.gateway`` processes over registry sidecars;
``http_port`` opens the HTTP/SSE edge on the first gateway;
``batch_lane`` adds the deadline-less ``batch`` class of the offline
lane; ``master`` runs the replicas as tasks of a Mesos master
(``host:port``, ``http://`` or ``zk://``) instead of this host.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from tfmesos_tpu_torch import wire
from tfmesos_tpu_torch.fleet.admission import AdmissionController, PriorityClass
from tfmesos_tpu_torch.fleet.autoscaler import (AutoscalerConfig,
                                                FleetAutoscaler)
from tfmesos_tpu_torch.fleet.catalog import (POOL, POOL_KEY, ModelCatalog,
                                             ModelSpec, ModelTrader,
                                             TraderConfig,
                                             filter_members, model_key,
                                             pack_adapter, split_key)
from tfmesos_tpu_torch.fleet.client import FleetClient
from tfmesos_tpu_torch.fleet.gateway import Gateway
from tfmesos_tpu_torch.fleet.metrics import FleetMetrics
from tfmesos_tpu_torch.fleet.registry import (ALIVE, DEAD, DECODE, KV,
                                              PREFILL, UNIFIED, WARMING,
                                              ReplicaRegistry,
                                              validate_model_id)
from tfmesos_tpu_torch.fleet.router import Router
from tfmesos_tpu_torch.fleet.tracing import TraceBook
from tfmesos_tpu_torch.scheduler import (MAX_FAILURE_COUNT, ClusterError,
                                         TPUMesosScheduler)
from tfmesos_tpu_torch.utils.logging import get_logger

__all__ = ["FleetServer", "RolloutError", "TIER_JOBS",
           "validate_kv_tier_dir", "validate_weights_version"]

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


def validate_weights_version(version: str) -> str:
    version = str(version)
    # fullmatch, not match-with-$: '$' would accept a trailing newline,
    # which shell=True treats as a command terminator.
    if not _VERSION_RE.fullmatch(version):
        raise ValueError(
            f"weights_version {version!r} is not a valid label: want "
            f"1-64 chars of [A-Za-z0-9._-] starting alphanumeric (it "
            f"joins the replica command line, so the charset is a "
            f"security boundary)")
    return version


class RolloutError(RuntimeError):
    """A blue-green rollout aborted (the old version kept serving)."""


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
                 gang_size: int = 1,
                 int8: bool = False,
                 draft: bool = False,
                 n_draft: int = 4,
                 models: Optional[List[ModelSpec]] = None,
                 warm_pool: int = 0,
                 model_budget: Optional[int] = None,
                 trader_config: Optional[TraderConfig] = None,
                 device: Optional[str] = None,
                 weights_version: str = "v0",
                 autoscale: bool = False,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 autoscale_config: Optional[AutoscalerConfig] = None,
                 backend=None, master: Optional[str] = None,
                 replica_cpus: float = 1.0, replica_mem: float = 1024.0,
                 replica_chips: int = 0,
                 gateway_host: str = "127.0.0.1", gateway_port: int = 0,
                 gateways: int = 1,
                 gateway_processes: int = 0,
                 http_port: Optional[int] = None,
                 workers: int = 8, max_queue: int = 64,
                 rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 priority_classes: Optional[List[PriorityClass]] = None,
                 batch_lane: bool = False,
                 migrate_on_drain: bool = True,
                 breakers: bool = True,
                 max_retries: int = 2, request_timeout: float = 120.0,
                 start_timeout: float = 300.0,
                 heartbeat_interval: float = 0.3,
                 report_interval: Optional[float] = None,
                 metrics_port: Optional[int] = None,
                 trace_sample: float = 0.05,
                 trace_slow_ms: float = 1000.0,
                 quiet: bool = True, token: Optional[str] = None):
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
        # Gang replicas: each unified "replica" is N member tasks,
        # placed as one atomic gang and routed as ONE replica (the
        # leader).  Role-split tiers stay single-process (the
        # disaggregated handoff is a per-request hop, not a gang).
        self.gang_size = int(gang_size)
        if self.gang_size < 1:
            raise ValueError(
                f"gang_size must be >= 1, got {gang_size}")
        if self.gang_size > 1 and (prefill_replicas or decode_replicas):
            raise ValueError(
                "gang replicas serve the unified tier; drop "
                "prefill_replicas/decode_replicas or gang_size")
        # Model catalog: with ``models``, the catalog entries size the
        # fleet (each entry's own ``replicas``), a ``warm_pool`` of
        # undedicated pre-warmed replicas caps cold-start TTFT, and
        # every replica count lives under ONE fleet-wide
        # ``model_budget`` the trader reallocates within.  ``replicas``
        # (the single-model knob) is ignored, and the disaggregated
        # role split is per-model routing only.
        self.catalog: Optional[ModelCatalog] = None
        self.warm_pool = int(warm_pool)
        self.trader_config = trader_config
        self.trader: Optional[ModelTrader] = None
        self.replica_budget: Optional[int] = None
        if self.warm_pool < 0:
            raise ValueError(f"warm_pool must be >= 0, got {warm_pool}")
        if models:
            if prefill_replicas or decode_replicas:
                raise ValueError(
                    "a model catalog runs unified tiers; drop "
                    "prefill_replicas/decode_replicas")
            self.catalog = ModelCatalog(models)
            # Budget math is in SLOTS (member tasks): a gang replica of
            # size N occupies N of them.
            boot = sum(s.replicas * s.gang_size for s in self.catalog)
            if boot + self.warm_pool < 1:
                raise ValueError(
                    "the catalog fleet needs at least one replica: "
                    "every entry boots 0 and warm_pool is 0")
            self.replica_budget = int(model_budget) \
                if model_budget is not None else boot + self.warm_pool
            if self.replica_budget < max(1, boot + self.warm_pool):
                raise ValueError(
                    f"model_budget ({self.replica_budget}) is below "
                    f"the boot footprint ({boot} model replicas + "
                    f"{self.warm_pool} warm pool)")
            replicas = 0
        elif self.warm_pool or model_budget is not None:
            raise ValueError("warm_pool/model_budget need a model "
                             "catalog (models=[...])")
        if self.catalog is None \
                and replicas + prefill_replicas + decode_replicas < 1:
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
        initial = {UNIFIED: self.replicas, PREFILL: self.prefill_replicas,
                   DECODE: self.decode_replicas}
        # Autoscale bounds are PER TIER: an explicit max_replicas
        # applies to every tier, but the default ceiling is twice EACH
        # tier's own initial count (a decode tier booted at 1 must not
        # inherit a 4-replica prefill tier's headroom), and a
        # non-autoscaled fleet's ceiling is exactly what was asked for.
        self.min_replicas = 1 if min_replicas is None else int(min_replicas)
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1 (a routable tier can never "
                f"scale to zero), got {self.min_replicas}")
        self._tier_max: Dict[str, int] = {}
        for role, n in initial.items():
            if not n:
                continue
            if max_replicas is not None:
                self._tier_max[role] = int(max_replicas)
            else:
                self._tier_max[role] = max(2 * n, n + 1) if autoscale \
                    else n
        if self.catalog is not None:
            # Per-(model, tier) bounds are the trader's business: each
            # key may range [0, budget] — floors and scale-to-zero live
            # in the catalog entries, the ceiling is the shared budget.
            self.max_replicas = self.replica_budget
        else:
            self.max_replicas = max(self._tier_max.values())
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})")
        for role, n in initial.items():
            if n and not (self.min_replicas <= n
                          <= self._tier_max[role]):
                raise ValueError(
                    f"initial {role} tier count {n} lies outside the "
                    f"autoscale bounds [{self.min_replicas}, "
                    f"{self._tier_max[role]}]")
        # The label joins the replica command line, which Mode-B agents
        # run with shell=True: only a fixed charset may pass.
        self.weights_version = validate_weights_version(weights_version)
        self.autoscale = bool(autoscale)
        self.autoscale_config = autoscale_config
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
        #: int8 weights over an int8 page pool on every replica (the
        #: port's own option: the replica's ``--int8``).
        self.int8 = bool(int8)
        #: speculative decoding on every replica (the preset's draft
        #: model, ``n_draft`` proposals a round); the acceptance rate
        #: rides the heartbeats into the registry's spec gauge.
        self.draft = bool(draft)
        self.n_draft = int(n_draft)
        if self.draft and self.n_draft < 1:
            raise ValueError(f"n_draft must be >= 1, got {n_draft}")
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
        if self.kv_replicas:
            # The kv tier is pinned at its boot size: the autoscaler's
            # signals never move for a storage-only holder, so letting
            # the loop retarget it would only ever shrink it.
            self._tier_max[KV] = self.kv_replicas
        self.backend = backend
        #: a Mesos master (``host:port``, ``http://...`` or ``zk://...``)
        #: runs the replicas as tasks on its agents; None: this host.
        self.master = master
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
        #: the multi-process front door: > 0 replaces the in-process
        #: gateways with N ``python -m tfmesos_tpu_torch.fleet.gateway``
        #: processes, each with its own WireServer, admission WFQ and
        #: router over a registry sidecar's mirrored view.  They share
        #: one public port through SO_REUSEPORT where the platform has
        #: it, else take their own ports behind the ``gateways`` op.
        self.gateway_processes = int(gateway_processes)
        if self.gateway_processes < 0:
            raise ValueError(
                f"gateway_processes must be >= 0, got {gateway_processes}")
        if self.gateway_processes and self.catalog is not None:
            # The trader answers cold-start demand through the shared
            # in-process router; a gateway process's own router has no
            # trader to ask, so a catalog fleet would lose scale-from-zero.
            raise ValueError(
                "gateway_processes and a model catalog are mutually "
                "exclusive: catalog cold-start demand rides the "
                "in-process router")
        #: HTTP/1.1 + SSE ingress: None is off.  The first in-process
        #: gateway, or the first gateway process, carries it.
        self.http_port = None if http_port is None else int(http_port)
        self.workers = int(workers)
        self.max_queue = int(max_queue)
        self.rate = rate
        self.burst = burst
        #: admission priority classes (weighted-fair queues at the
        #: gateway + preemption ranks inside the replicas); None = one
        #: default class.
        self.priority_classes = list(priority_classes) \
            if priority_classes else None
        #: the offline lane: appends a deadline-less ``batch`` class that
        #: dispatches only when every interactive queue is empty and
        #: ranks below every other class, so its resident rows yield
        #: their decode slots to the first interactive arrival.
        self.batch_lane = bool(batch_lane)
        if self.batch_lane:
            specs = (list(self.priority_classes)
                     if self.priority_classes
                     else [PriorityClass("interactive", weight=1.0,
                                         rank=0)])
            if not any(c.name == "batch" for c in specs):
                floor = min(c.rank for c in specs)
                specs.append(PriorityClass("batch", weight=1.0,
                                           rank=floor - 1, batch=True))
            self.priority_classes = specs
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
        #: gateway OS processes (multi-process mode); empty in process.
        self._gateway_procs: list = []
        #: the HTTP/SSE edge's address once bound (either mode).
        self.http_addr: Optional[str] = None
        self.scheduler: Optional[TPUMesosScheduler] = None
        self.autoscaler: Optional[FleetAutoscaler] = None
        #: per-tier replica targets — what the control plane WANTS; the
        #: convergence loops (autoscaler, _wait_replicas) drive actuals
        #: toward these.
        self.targets: Dict[str, int] = {}
        #: serializes every scaling decision: autoscaler ticks and
        #: rollouts are mutually exclusive (a rollout must not race the
        #: loop retargeting the tier it is replacing).
        self.scale_lock = threading.RLock()
        #: node id -> target key ("role", or "model/role" / POOL_KEY in
        #: catalog mode): how per-(model, tier) actuals are counted
        #: when every model's tasks share one scheduler job.  Updated
        #: at launch and on warm-pool adoption.
        self._node_keys: Dict[str, str] = {}
        #: gang id -> {key, job, size, task_ids, leader_node,
        #: weights_version}: the gang book.  An entry is popped on the
        #: FIRST member death, so the siblings' own deaths find nothing
        #: and a gang re-forms exactly once.
        self._gangs: Dict[str, dict] = {}
        self._gang_lock = threading.Lock()
        self._started = False

    # -- bring-up ----------------------------------------------------------

    def _replica_cmd(self, role: str = UNIFIED,
                     weights_version: Optional[str] = None,
                     model: Optional[ModelSpec] = None,
                     pool: bool = False) -> str:
        version = self.weights_version if weights_version is None \
            else weights_version
        parts = [sys.executable, "-m", "tfmesos_tpu_torch.fleet.replica",
                 "--registry", self.registry.addr,
                 "--rows", str(self.rows),
                 "--seed", str(self.seed),
                 "--heartbeat-interval", str(self.heartbeat_interval)]
        if model is not None:
            # model_id is validated at catalog construction — the same
            # shell=True boundary as weights_version.
            parts += ["--model-id", model.model_id,
                      "--model-seed", str(model.seed)]
        if pool:
            parts += ["--warm-pool"]
        if role != UNIFIED:
            parts += ["--role", role]
        if version:
            parts += ["--weights-version", version]
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
        if self.int8:
            parts.append("--int8")
        if self.draft:
            parts += ["--draft", "--n-draft", str(self.n_draft)]
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
            # Every launch of this cmd — boot, an autoscale-up, a
            # rollout's new tier or a relaunch — registers warming,
            # captures its graphs, then takes traffic.
            parts.append("--warmup")
        return " ".join(parts)

    def _gateway_cmd(self, port: int, reuseport: bool,
                     http_port: Optional[int]) -> List[str]:
        """One gateway process's argv (exec'd directly, never through a
        shell): the wire listener address plus the same admission/
        routing constants every in-process gateway gets.  The cluster
        token rides the environment (``TPUMESOS_TOKEN``), never the
        command line."""
        parts = [sys.executable, "-m", "tfmesos_tpu_torch.fleet.gateway",
                 "--registry", self.registry.addr,
                 "--host", self.gateway_host,
                 "--port", str(int(port)),
                 "--workers", str(self.workers),
                 "--max-queue", str(self.max_queue),
                 "--max-retries", str(self.max_retries),
                 "--request-timeout", str(self.request_timeout)]
        if reuseport:
            parts.append("--reuseport")
        if self.rate is not None:
            parts += ["--rate", str(self.rate)]
        if self.burst is not None:
            parts += ["--burst", str(self.burst)]
        if http_port is not None:
            parts += ["--http-port", str(int(http_port)),
                      "--http-host", self.gateway_host]
        if self.priority_classes:
            # The class table, so each process's admission WFQ and the
            # ranks it sends the replicas are the fleet's (the offline
            # lane's ``batch`` class included).
            parts += ["--classes-json", json.dumps(
                [dataclasses.asdict(c) for c in self.priority_classes])]
        return parts

    def _start_gateway_procs(self) -> None:
        """Launch ``gateway_processes`` front-door OS processes.  They
        share ONE public port via SO_REUSEPORT where the platform has
        it (the kernel load-balances accepts); elsewhere each takes an
        OS-assigned port and clients discover the set through the
        ``gateways`` op.  Either way every process leases a discovery
        entry in the central registry, which is also how this method
        knows bring-up finished."""
        n = self.gateway_processes
        reuseport = wire.reuseport_available()
        shared_port = 0
        if reuseport:
            shared_port = self.gateway_port
            if not shared_port:
                # Pick the shared port up front: bind-with-REUSEPORT,
                # read, close.  The tiny close-to-spawn window is the
                # standard ephemeral-port race; a loser fails loudly
                # at bind and the bring-up wait reports it.
                probe = wire.bind_ephemeral(self.gateway_host, 0,
                                            reuseport=True)
                shared_port = probe.getsockname()[1]
                probe.close()
        env = dict(os.environ)
        env["TPUMESOS_TOKEN"] = self.token
        env.pop("TPUMESOS_TOKEN_FILE", None)
        sink = subprocess.DEVNULL if self.quiet else None
        for i in range(n):
            if reuseport:
                port = shared_port
            else:
                port = self.gateway_port if i == 0 else 0
            cmd = self._gateway_cmd(
                port, reuseport,
                self.http_port if i == 0 else None)
            self._gateway_procs.append(subprocess.Popen(
                cmd, env=env, stdout=sink, stderr=sink))
        # Every process holds its OWN lease (keyed by its private
        # scrape addr), so N leases = N processes up even when
        # SO_REUSEPORT collapses the public discovery set to one addr.
        deadline = time.monotonic() + min(self.start_timeout, 30.0)
        while time.monotonic() < deadline:
            dead = [p for p in self._gateway_procs
                    if p.poll() is not None]
            if dead:
                raise ClusterError(
                    f"{len(dead)} gateway process(es) died during "
                    f"bring-up (first exit code "
                    f"{dead[0].returncode})")
            if len(self.registry.gateway_leases()) >= n:
                break
            time.sleep(0.05)
        else:
            raise ClusterError(
                f"only {len(self.registry.gateway_leases())} of {n} "
                f"gateway lease(s) registered within the bring-up "
                f"window")
        if self.http_port:
            self.http_addr = f"{self.gateway_host}:{self.http_port}"
        # Fleet-level scrape: the launcher's own /metrics (and
        # fleet_snapshot()) fold every gateway process's raw state in
        # at scrape time.
        self.metrics.fanin = self._scrape_gateway_raws
        self.log.info(
            "%d gateway process(es) up%s", n,
            f" sharing :{shared_port} via SO_REUSEPORT" if reuseport
            else " on per-process ports (no SO_REUSEPORT; clients "
                 "discover via the gateways op)")

    def _wait_gateway_mirrors(self, timeout: float = 15.0) -> None:
        """Block until every gateway process's sidecar mirror can route
        to as many alive replicas as the central registry lists RIGHT
        NOW — without this, a client's first request races the mirror's
        poll cadence and sheds with "no alive replicas" on a fleet
        that is, in fact, up."""
        want = len(self.registry.alive())
        if not want:
            return
        pending = set(self.registry.gateway_leases())
        deadline = time.monotonic() + timeout
        while pending and time.monotonic() < deadline:
            for addr in sorted(pending):
                try:
                    sock = wire.connect(addr, timeout=2.0)
                    try:
                        sock.settimeout(2.0)
                        wire.send_msg(sock, {"op": "status"}, self.token)
                        reply = wire.recv_msg(sock, self.token)
                    finally:
                        sock.close()
                except (OSError, wire.WireError):
                    continue
                alive = reply.get("alive") if isinstance(reply, dict) \
                    else None
                if isinstance(alive, int) and alive >= want:
                    pending.discard(addr)
            if pending:
                time.sleep(0.05)
        if pending:
            raise ClusterError(
                f"{len(pending)} gateway process(es) never mirrored "
                f"the {want} alive replica(s) within {timeout:.0f}s")

    def _scrape_gateway_raws(self) -> List[dict]:
        """Every gateway process's mergeable metrics state (``metrics``
        op with ``raw: true`` against each process's PRIVATE scrape
        listener — the shared REUSEPORT public addr would land on a
        kernel-chosen process); an unreachable process costs its
        contribution, never the scrape."""
        raws: List[dict] = []
        registry = self.registry
        if registry is None:
            return raws
        for addr in registry.gateway_leases():
            try:
                sock = wire.connect(addr, timeout=2.0)
                try:
                    sock.settimeout(2.0)
                    wire.send_msg(sock, {"op": "metrics", "raw": True},
                                  self.token)
                    reply = wire.recv_msg(sock, self.token)
                finally:
                    sock.close()
            except (OSError, wire.WireError):
                continue
            raw = reply.get("raw") if isinstance(reply, dict) else None
            if isinstance(raw, dict):
                raws.append(raw)
        return raws

    def fleet_snapshot(self) -> dict:
        """The fleet-level metrics snapshot: with gateway processes, every
        process's counters and histograms merged into the launcher's own
        at scrape time; otherwise :meth:`snapshot`."""
        if self.metrics is None:
            return {}
        if self.metrics.fanin is None:
            return self.metrics.snapshot()
        return self.metrics.merged().snapshot()

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
            if self.gateway_processes:
                # N OS processes, each with its own WireServer loop,
                # admission WFQ and router over a registry sidecar's
                # view: no in-process Gateway objects in this mode.
                self._start_gateway_procs()
            else:
                self.gateways = []
                for i in range(self.n_gateways):
                    gw = Gateway(self.router, self.admission, self.metrics,
                                 token=self.token, host=self.gateway_host,
                                 port=self.gateway_port if i == 0 else 0,
                                 workers=self.workers,
                                 registry=self.registry,
                                 tracebook=self.tracebook,
                                 close_router=False,
                                 http_port=self.http_port
                                 if i == 0 else None).start()
                    self.gateways.append(gw)
                self.gateway = self.gateways[0]
                self.http_addr = self.gateway.http_addr
            if self.metrics_port is not None:
                self._metrics_http = self.metrics.start_http_server(
                    self.metrics_port)
                self.log.info(
                    "prometheus exposition on :%d/metrics",
                    self._metrics_http.server_address[1])
            # The scheduler starts EMPTY in dynamic mode: every replica,
            # boot ones included, goes through launch_replica.
            self.scheduler = TPUMesosScheduler(
                [], dynamic=True, backend=self.backend, master=self.master,
                quiet=self.quiet, start_timeout=self.start_timeout,
                token=self.token)
            self.scheduler.on_dynamic_death = self._on_dynamic_death
            self.scheduler.start()
            if self.catalog is not None:
                # Per-(model, tier) targets + the warm pool, all under
                # one budget.  Entries booting 0 replicas start scaled
                # to zero and cold-start through the pool on demand.
                for spec in self.catalog:
                    key = model_key(spec.model_id)
                    self.set_target(key, spec.replicas)
                    for _ in range(spec.replicas):
                        self.launch_replica(key)
                if self.warm_pool:
                    self.set_target(POOL_KEY, self.warm_pool)
                    for _ in range(self.warm_pool):
                        self.launch_replica(POOL_KEY)
            else:
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
            if self.gateway_processes:
                self._wait_gateway_mirrors()
            for gw in self.gateways:
                gw.rollout_fn = self.rollout
                gw.catalog = self.catalog
                if self.catalog is not None:
                    gw.swap_adapter_fn = self._swap_adapter_packed
            if self.catalog is not None:
                # The trader IS the catalog fleet's control loop: it
                # reallocates the budget between models, scales idle
                # ones to zero, and answers the router's cold-start
                # demands from the warm pool.
                self.trader = ModelTrader(
                    self, self.catalog, self.autoscale_config,
                    trader_config=self.trader_config).start()
                self.autoscaler = self.trader
                self.router.on_model_demand = self.trader.demand
            elif self.autoscale:
                self.autoscaler = FleetAutoscaler(
                    self, self.autoscale_config).start()
        except Exception:
            self.stop()
            raise
        self._started = True
        if self.report_interval:
            self.metrics.start_reporter(self.log, self.report_interval)
        self.log.info("fleet up: gateway%s %s, %d replica(s) "
                      "(%d unified / %d prefill / %d decode), %d KV "
                      "holder(s)%s", "s" if self.n_gateways > 1 else "",
                      ", ".join(self.addrs),
                      self.total_replicas, self.replicas,
                      self.prefill_replicas, self.decode_replicas,
                      self.kv_replicas,
                      f", autoscaling within [{self.min_replicas}, "
                      f"{self.max_replicas}]" if self.autoscale else "")
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

    def bounds(self, key: str) -> Tuple[int, int]:
        """The autoscale bounds this tier's target must stay within
        (the floor is fleet-wide, the ceiling per tier).  Composite
        per-(model, tier) keys range [0, budget] — their floors and
        scale-to-zero policy live in the catalog entries the trader
        enforces."""
        model, _ = split_key(key)
        if model is not None:
            return 0, self.replica_budget or self.max_replicas
        return self.min_replicas, self._tier_max.get(key,
                                                     self.max_replicas)

    def gang_size_for(self, key: str) -> int:
        """How many member tasks one replica of ``key`` launches as: the
        catalog entry's ``gang_size`` for model keys, the fleet's for
        the unified tier, and 1 for role-split tiers and the warm pool
        (a pool replica has no model to shard yet)."""
        model, role = split_key(key)
        if model == POOL:
            return 1
        if model is not None:
            return int(getattr(self.catalog.get(model),
                               "gang_size", 1) or 1)
        return self.gang_size if role == UNIFIED else 1

    def launch_replica(self, key: str,
                       weights_version: Optional[str] = None) -> str:
        """Launch ONE new Mode-B replica for ``key`` — a plain role, a
        composite ``"<model>/<role>"``, or the warm pool's
        :data:`~tfmesos_tpu_torch.fleet.catalog.POOL_KEY` — and return
        its node id ("job:index"); with ``warmup`` it registers
        ``warming`` and never takes traffic cold.  With a gang size > 1
        the replica is a whole gang and the node id is its leader's."""
        size = self.gang_size_for(key)
        if size > 1:
            return self.launch_gang(key, weights_version, size)
        model, role = split_key(key)
        spec = None
        pool = model == POOL
        if model is not None and not pool:
            spec = self.catalog.get(model)
        job = TIER_JOBS[role]
        with self.scale_lock:
            task = self.scheduler.add_task(
                job, cmd=self._replica_cmd(role, weights_version,
                                           model=spec, pool=pool),
                cpus=self.replica_cpus, mem=self.replica_mem,
                chips=self.replica_chips)
            node = f"{job}:{task.task_index}"
            self._node_keys[node] = key
        return node

    def launch_gang(self, key: str,
                    weights_version: Optional[str] = None,
                    size: Optional[int] = None) -> str:
        """Launch one GANG replica for ``key``: N identical member cmds
        enter the scheduler as one atomic gang (``add_gang`` stamps the
        id/size/rank env), and rank 0 leads and registers as the one
        routable node this method returns."""
        size = self.gang_size_for(key) if size is None else int(size)
        model, role = split_key(key)
        spec = None
        if model is not None and model != POOL:
            spec = self.catalog.get(model)
        job = TIER_JOBS[role]
        cmd = self._replica_cmd(role, weights_version, model=spec)
        with self.scale_lock:
            members = self.scheduler.add_gang(
                job, [cmd] * size, cpus=self.replica_cpus,
                mem=self.replica_mem, chips=self.replica_chips)
            gang_id = members[0].gang
            node = f"{job}:{members[0].task_index}"
            with self._gang_lock:
                self._gangs[gang_id] = {
                    "key": key, "job": job, "size": size,
                    "task_ids": [t.id for t in members],
                    "leader_node": node,
                    "weights_version": weights_version}
            self._node_keys[node] = key
        return node

    def kill_replica(self, node: str) -> bool:
        """Kill one replica by its node id ("job:index").  A gang
        leader's node kills the WHOLE gang: members without a leader are
        debris, not a smaller replica."""
        # The node->key book entry dies with the task either way — a
        # churning trader (trade = kill + relaunch per cooldown) must
        # not grow the book, and tier_actual scans it per tick.
        self._node_keys.pop(node, None)
        with self._gang_lock:
            gang_id = next((g for g, info in self._gangs.items()
                            if info["leader_node"] == node), None)
            info = self._gangs.pop(gang_id, None) if gang_id else None
        if info is not None:
            # remove_task pulls each member from the table BEFORE the
            # kill, so the siblings' deaths report under unknown ids and
            # never re-enter the gang-death path.
            killed = False
            with self.scale_lock:
                for tid in info["task_ids"]:
                    killed = self.scheduler.remove_task(tid) or killed
            return killed
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
        the death (``replica_deaths``), and with the autoscaler on the
        next control tick relaunches it (the dead task left the
        scheduler's table, so actual fell below target).  A gang
        member's death is its gang's: the siblings are torn down and the
        gang re-forms under a FRESH generation and a fresh gang id, the
        double fence that keeps a zombie member of the dead gang out
        (its ``gang_lookup`` never resolves, and the new leader refuses
        joins of any other (gang, generation))."""
        if self.metrics is not None:
            self.metrics.inc("replica_deaths")
        gang_id = getattr(task, "gang", None)
        if gang_id is None:
            self.log.warning("replica task %s:%d died; routing around it",
                             task.job_name, task.task_index)
            return
        with self._gang_lock:
            info = self._gangs.pop(gang_id, None)
        if info is None:
            return      # a sibling already took the gang down
        self._node_keys.pop(info["leader_node"], None)
        for tid in info["task_ids"]:
            if tid == task.id:
                continue
            try:
                self.scheduler.remove_task(tid)
            except Exception as e:
                self.log.warning("gang %s sibling %s teardown failed: %s",
                                 gang_id, tid, e)
        if not self._started or self.scheduler is None:
            return
        try:
            self.scheduler.bump_generation()
            node = self.launch_gang(info["key"],
                                    info.get("weights_version"),
                                    info["size"])
            if self.metrics is not None:
                self.metrics.inc("gang_reforms")
            self.log.warning(
                "gang %s lost a member; torn down and re-forming as %s "
                "(leader %s)", gang_id, info["key"], node)
        except Exception:
            self.log.exception("gang %s re-form failed; the convergence "
                               "loop will retry", gang_id)

    def tier_actual(self, key: str) -> int:
        """Live tasks launched for one tier, registered or not — the
        convergence loops' notion of "actual", so a launched replica
        still starting or warming counts and the loop never launches
        it twice.  Composite keys count through the node->key map
        intersected with the scheduler's live task table (all models
        share one job).  A gang counts as ONE unit."""
        model, role = split_key(key)
        job = TIER_JOBS[role]
        if model is None:
            loose, gangs = 0, set()
            for t in self.scheduler.tasks_of(job):
                gang_id = getattr(t, "gang", None)
                if gang_id is None:
                    loose += 1
                else:
                    gangs.add(gang_id)
            return loose + len(gangs)
        # Only gang LEADERS enter the node->key book, so the
        # intersection already counts a gang once.
        live = {f"{job}:{t.task_index}"
                for t in self.scheduler.tasks_of(job)}
        return sum(1 for node, k in list(self._node_keys.items())
                   if k == key and node in live)

    def tier_members(self, key: str):
        """Registry members of one target key (the trader's membership
        query): role-filtered by the registry, model/pool-filtered
        here."""
        _, role = split_key(key)
        return filter_members(self.registry.members(role), key)

    def _alive_of(self, key: str,
                  weights_version: Optional[str] = None) -> int:
        return sum(1 for r in self.tier_members(key)
                   if r.state == ALIVE
                   and (weights_version is None
                        or r.weights_version == weights_version))

    def adopt_replica(self, addr: str, model_id: str,
                      timeout: float = 60.0) -> bool:
        """Assign a warm-pool replica a catalog model via the ``adopt``
        control op (a weight install on a pre-warmed process — the
        cold-start path that skips launch and graph capture).  Updates
        the node->key book immediately so the trader's actuals follow
        without waiting a heartbeat."""
        spec = self.catalog.get(model_id)
        try:
            reply = self.router.control(
                addr, {"op": "adopt", "model_id": spec.model_id,
                       "seed": spec.seed}, timeout=timeout)
        except Exception as e:
            self.log.warning("adoption of %s for model %s failed: %s",
                             addr, model_id, e)
            return False
        if not isinstance(reply, dict) or reply.get("op") != "adopted":
            self.log.warning("adoption of %s for model %s rejected: %r",
                             addr, model_id, reply)
            return False
        node = next((r.node for r in self.registry.members()
                     if r.addr == addr and r.node), None)
        if node is not None:
            self._node_keys[node] = model_key(model_id)
        return True

    def swap_adapter(self, model_id: str, adapter_version: str,
                     delta=None, packed: Optional[Tuple[dict, bytes]]
                     = None, timeout: float = 120.0) -> dict:
        """Hot-swap a LoRA-style weight delta onto EVERY alive replica
        of one model: the delta ships as ONE raw HMAC frame per replica
        (``swap_adapter`` op), each batcher folds it behind its
        weight-update fence (in-flight requests finish on the old
        delta; zero downtime), and the call returns once every replica
        acked.  ``delta`` is a param-path -> array dict (packed here);
        ``packed`` supplies pre-encoded ``(meta, body)`` instead (the
        gateway op's path — no numpy on the gateway).  Raises on an
        unknown model, a replica rejection, or a partial failure — a
        fleet serving two delta versions of one model would break the
        token-identical-streams contract, so partial application is an
        ERROR, not a success."""
        if self.catalog is None:
            raise RuntimeError("swap_adapter needs a model catalog")
        spec = self.catalog.get(model_id)     # KeyError on unknown
        adapter_version = validate_model_id(adapter_version)
        if packed is None:
            if delta is None:
                raise ValueError("swap_adapter needs delta or packed")
            packed = pack_adapter(delta)
        meta, body = packed
        members = self.registry.members(model=spec.model_id)
        if any(r.state == WARMING for r in members):
            # A warming replica would turn ALIVE on BASE weights right
            # after the swap acked — one model serving two weight
            # states, the partial-application state that is an error.
            # Fail up front; the operator retries once the tier settles.
            raise RuntimeError(
                f"model {model_id!r} has replica(s) still warming; "
                f"they would come up on the old weights — retry the "
                f"swap once the tier is fully routable")
        targets = [r for r in members if r.state == ALIVE]
        if not targets:
            raise RuntimeError(
                f"no alive replica serves model {model_id!r} (scaled "
                f"to zero? the swap applies at the next cold start "
                f"only if re-issued)")
        failures = []
        for r in targets:
            call = dict(meta)
            call.update(op="swap_adapter", model_id=spec.model_id,
                        adapter_version=adapter_version)
            try:
                reply = self.router.control_raw(r.addr, call, body,
                                                timeout=timeout)
            except Exception as e:
                failures.append(f"{r.addr}: {e}")
                continue
            if not isinstance(reply, dict) \
                    or reply.get("op") != "adapter_swapped":
                err = reply.get("error") if isinstance(reply, dict) \
                    else repr(reply)
                failures.append(f"{r.addr}: {err}")
        if failures:
            raise RuntimeError(
                f"adapter swap {adapter_version!r} on model "
                f"{model_id!r} failed on {len(failures)}/"
                f"{len(targets)} replica(s): {'; '.join(failures)}")
        self.metrics.inc("adapter_swaps")
        self.log.info("adapter %s swapped onto %d replica(s) of model "
                      "%s", adapter_version, len(targets), model_id)
        return {"model_id": spec.model_id,
                "adapter_version": adapter_version,
                "replicas": len(targets)}

    def _swap_adapter_packed(self, model_id: str, adapter_version: str,
                             meta: dict, body: bytes) -> dict:
        """The gateway op's entry point: the delta arrived base64 over
        the public port (which rejects raw frames pre-auth) and ships
        onward to the replicas as raw HMAC frames."""
        return self.swap_adapter(model_id, adapter_version,
                                 packed=(meta, body))

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
            if all(self._alive_of(key) >= n
                   for key, n in self.targets.items()):
                return
            for key, n in self.targets.items():
                job = TIER_JOBS[split_key(key)[1]]
                fails = self.scheduler.dynamic_failures.get(job, 0)
                if fails >= MAX_FAILURE_COUNT * max(1, n):
                    raise ClusterError(
                        f"replica job {job!r} failed {fails} times "
                        f"during fleet bring-up")
                for _ in range(n - self.tier_actual(key)):
                    self.log.warning("bring-up relaunch of a crashed "
                                     "%s replica", key)
                    self.launch_replica(key)
            time.sleep(0.1)
        warming = len(self.registry.warming())
        counts = {key: self._alive_of(key) for key in self.targets}
        raise ClusterError(
            f"replicas routable after {self.start_timeout:.0f}s: "
            f"{counts} of targets {self.targets}"
            + (f" ({warming} still warming — raise start_timeout for "
               f"slow captures)" if warming else ""))

    # -- blue-green rollout ------------------------------------------------

    def rollout(self, weights_version: str, bake_s: float = 1.0,
                warm_timeout: Optional[float] = None,
                drain_timeout: float = 120.0) -> dict:
        """Replace every tier's weights blue-green with zero downtime:

        1. bump the scheduler generation (the fencing epoch) and launch
           a full NEW-version replica set next to the old one — same
           per-tier targets, same cmd line (``--warmup`` included, so
           the new tier warms before it can be routed);
        2. wait until every tier's new-version alive count reaches its
           target — if that never happens the rollout ABORTS: the new
           tasks are reaped and the old version keeps serving;
        3. the SHIFT: one atomic router update prefers the new
           weights_version (the old tier stays registered as fallback
           through the bake window, so the shift itself cannot shed);
        4. after ``bake_s``, drain the old tier (pinned drains — the
           healthy old replicas keep heartbeating while their in-flight
           work flushes, and those beats must not revive them), wait
           for the flush, kill the old tasks, and raise the registry's
           generation fence so a stalled old-generation straggler can
           never re-register and serve stale weights.

        Returns a summary dict; raises :class:`RolloutError` on abort.
        """
        version = validate_weights_version(weights_version)
        if self.scheduler is None or self.registry is None:
            raise RuntimeError("fleet not started")
        with self.scale_lock:
            old_version = self.weights_version
            if version == old_version:
                raise ValueError(
                    f"fleet already serves weights_version {version!r}")
            gen = self.scheduler.bump_generation()
            warm_timeout = self.start_timeout if warm_timeout is None \
                else float(warm_timeout)
            new_nodes: List[Tuple[str, str]] = []
            for role, target in self.targets.items():
                for _ in range(target):
                    new_nodes.append(
                        (role, self.launch_replica(role, version)))
            self.log.info(
                "rollout %s -> %s: %d new-version replica(s) launched "
                "(generation %d); old tier keeps serving", old_version,
                version, len(new_nodes), gen)
            deadline = time.monotonic() + warm_timeout
            while time.monotonic() < deadline:
                self.scheduler.finished()
                if all(self._alive_of(role, version) >= target
                       for role, target in self.targets.items()):
                    break
                time.sleep(0.1)
            else:
                # Abort: the new tier never left warming (or its tasks
                # kept dying).  Reap it; the old version never stopped
                # serving, so this is a no-downtime failure.  Routing
                # is version-blind BEFORE the shift, so any new-version
                # replica that did reach ALIVE may already carry
                # traffic — drain those and wait for the flush before
                # the kill, exactly like the post-shift reap path.
                new_set = {node for _, node in new_nodes}
                self._drain_and_flush(
                    [r for r in self.registry.members()
                     if r.node in new_set and r.state == ALIVE],
                    drain_timeout)
                for _, node in new_nodes:
                    self.kill_replica(node)
                self.metrics.inc("rollouts_aborted")
                raise RolloutError(
                    f"rollout to {version!r} aborted: new tier not "
                    f"routable within {warm_timeout:.0f}s "
                    f"({len(self.registry.warming())} still warming, "
                    f"{len(new_set)} launched); {old_version!r} keeps "
                    f"serving")
            # The shift point: one atomic preference update.  From the
            # next pick on, the router selects old-version replicas only
            # if NO new-version replica is routable.
            self.router.set_preferred_version(version)
            self.weights_version = version
            self.metrics.inc("rollouts")
            self.log.info("rollout shift: router now prefers "
                          "weights_version %s (old %s is fallback for "
                          "%.1fs bake)", version, old_version, bake_s)
            if bake_s:
                time.sleep(bake_s)
            # Drain the old tier: pinned — these replicas are healthy
            # and keep heartbeating while their last requests flush.
            # The drain set is computed NOW, not at rollout start: a
            # replica that registered during the warm wait (an
            # autoscaler launch racing the scale lock) is old-version
            # fallback traffic too and must flush before the reap.
            managed_roles = {split_key(k)[1] for k in self.targets}
            old_members = [r for r in self.registry.members()
                           if (r.role or UNIFIED) in managed_roles
                           and r.weights_version != version
                           and r.state != DEAD]
            self._drain_and_flush(old_members, drain_timeout)
            # Reap every old-generation task of the managed tiers (the
            # registry's node field maps members back; the scheduler
            # table diff catches launched-but-never-registered ones).
            new_set = {node for _, node in new_nodes}
            # Gang-aware reap: a NEW gang's members carry node ids that
            # never entered new_nodes (only the leader did) — keep any
            # task whose gang's leader is new; reap old gangs whole and
            # drop their book entries so no death hook re-forms them.
            managed_jobs = {TIER_JOBS[r] for r in managed_roles}
            with self._gang_lock:
                keep_gangs = {g for g, info in self._gangs.items()
                              if info["leader_node"] in new_set}
                for g in [g for g, info in self._gangs.items()
                          if g not in keep_gangs
                          and info["job"] in managed_jobs]:
                    del self._gangs[g]
            reaped = 0
            for job in managed_jobs:
                for t in self.scheduler.tasks_of(job):
                    if getattr(t, "gang", None) in keep_gangs:
                        continue
                    node = f"{job}:{t.task_index}"
                    if node not in new_set:
                        self._node_keys.pop(node, None)
                        self.scheduler.remove_task(t.id)
                        reaped += 1
            # The fence: beats of generations before this rollout are
            # dropped from here on — a stopped straggler that wakes up
            # later cannot re-register and serve stale weights.
            self.registry.fence_generation(gen)
            self.log.info(
                "rollout to %s complete: %d old replica(s) drained and "
                "reaped, registry fenced at generation %d", version,
                reaped, gen)
            return {"old_version": old_version, "new_version": version,
                    "replicas": len(new_nodes), "reaped": reaped,
                    "generation": gen}

    # -- surface -----------------------------------------------------------

    @property
    def addr(self) -> Optional[str]:
        return self.gateway.addr if self.gateway is not None else None

    @property
    def addrs(self) -> List[str]:
        """Every front door's address.  With gateway processes this is
        the central registry's leased discovery set: under SO_REUSEPORT
        all N share one address, so one entry stands for the set."""
        if self.gateways:
            return [gw.addr for gw in self.gateways if gw.addr]
        if self._gateway_procs and self.registry is not None:
            return sorted(self.registry.gateway_addrs())
        return []

    def client(self, timeout: float = 120.0) -> FleetClient:
        """A client over every gateway: one connection at a time, failing
        over to a surviving gateway (replaying idempotent in-flight
        generates) when its own dies."""
        return FleetClient(self.addrs or [self.addr], self.token,
                           timeout=timeout)

    def snapshot(self) -> dict:
        """The fleet metrics snapshot; the ``roles`` gauge carries each
        tier's target vs actual counts and weights_version distribution,
        and ``autoscaler`` (when scaling) the control loop's beliefs."""
        return self.metrics.snapshot() if self.metrics is not None else {}

    # -- teardown ----------------------------------------------------------

    def stop(self) -> None:
        self._started = False
        if self.autoscaler is not None:
            self.autoscaler.stop()
            self.autoscaler = None
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
        self.http_addr = None
        if self.metrics is not None:
            self.metrics.fanin = None
        for proc in self._gateway_procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in self._gateway_procs:
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                try:
                    proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:  # pragma: no cover
                    pass
        self._gateway_procs = []
        # The gateways share the router (close_router=False); its links
        # close exactly once, here.
        if self.router is not None:
            self.router.close()
            self.router = None
        if self.scheduler is not None:
            # Teardown kills are deliberate: no death hook fires for
            # them, and no gang re-forms what stop() is reaping.
            self.scheduler.on_dynamic_death = None
            self.scheduler.stop()
            self.scheduler = None
        with self._gang_lock:
            self._gangs.clear()
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

