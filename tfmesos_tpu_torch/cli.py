"""``tfrun`` and ``tfserve`` for the PyTorch port (port of
``tfmesos_tpu/cli.py``: tfrun's ``build_parser``, ``parse_mesh``,
``parse_volumes``, ``LogCollector``, ``forward_map`` and ``main``, here
``run_main``; the serving entry ``build_serve_parser``, ``serve_main``
and the ``submit``, ``metrics``, ``trace``, ``gateways``, ``rollout``
and ``swap-adapter`` subcommands).

    python -m tfmesos_tpu_torch.cli run -w 2 -s 0 [--worker-logs '*'] \
        [--mesh dp=-1] [--restarts N | --restart-policy elastic] \
        -- python -m tfmesos_tpu_torch.transformer_train --device cpu
    python -m tfmesos_tpu_torch.cli serve [--replicas N] [--tiny] ...
    python -m tfmesos_tpu_torch.cli serve --autoscale --max-replicas 4
    python -m tfmesos_tpu_torch.cli serve --models chat:1,code:0 --warm-pool 1
    python -m tfmesos_tpu_torch.cli submit -g HOST:PORT --prompt 1,2,3
    python -m tfmesos_tpu_torch.cli metrics -g HOST:PORT
    python -m tfmesos_tpu_torch.cli rollout -g HOST:PORT --version v1
    python -m tfmesos_tpu_torch.cli swap-adapter -g HOST:PORT --model chat \
        --version a1 --npz delta.npz

``serve`` brings up a registry and a gateway in process and launches
port replicas (``tfmesos_tpu_torch.fleet.replica``) as local Mode-B
tasks, on the card unless ``--device cpu``.  It runs until SIGINT
(ctrl-c), then stops the fleet and every replica process.  Every flag
of the JAX ``tfserve`` parses with its default; the ones whose
machinery is not ported yet (``--gang-size``, ``--gateway-processes``,
``--http-port``, ``--batch-lane``, ``--master``), and the ``batch`` and
``simulate`` subcommands, exit 2 with ``tfserve: not ported yet:
<flag> (ROADMAP A.x)``.

``run`` is ``tfrun``: it runs one command on every task of a ps/worker
job spec as a Mode-B cluster over the local backend, forwards the
output of the tasks ``--worker-logs`` names to its stdout, prefixed
``[job:index]``, and polls until the workers finish.  It exits 0 when
they do, 1 with one line ``tfrun: cluster failed: ...`` when the
cluster fails, and 2 on a bad flag, a missing ``-e`` file, or a mesh
axis the port does not have yet (``--mesh`` takes ``dp``, ``fsdp`` and
``tp``).
"""

from __future__ import annotations

import argparse
import json
import os
import selectors
import sys
import time
from typing import Dict, List, Optional

from tfmesos_tpu_torch import wire

__all__ = ["build_parser", "parse_mesh", "parse_volumes", "LogCollector",
           "forward_map", "run_main",
           "build_serve_parser", "parse_role_spec", "parse_class_spec",
           "parse_model_spec", "serve_main", "submit_main", "trace_main",
           "metrics_main", "gateways_main", "rollout_main",
           "swap_adapter_main", "main", "NOT_PORTED_FLAGS",
           "NOT_PORTED_SUBCOMMANDS"]

#: tfserve flags whose machinery waits: (flag, args dest, the default
#: that asks for nothing, ROADMAP item).
NOT_PORTED_FLAGS = (
    ("--gang-size", "gang_size", 1, "A.9"),
    ("--gateway-processes", "gateway_processes", 0, "A.12"),
    ("--http-port", "http_port", None, "A.12"),
    ("--batch-lane", "batch_lane", False, "A.12"),
    ("--master", "master", None, "A.12"),
)

#: tfserve subcommands whose machinery waits -> ROADMAP item.
NOT_PORTED_SUBCOMMANDS = {"batch": "A.12", "simulate": "A.12"}


# -- tfrun ---------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    """tfrun's flag surface, the JAX package's: ``-w`` workers and ``-s``
    servers (ps tasks; with any, the default mesh is all ``fsdp``), the
    per-job resource flags (``-Gw``/``-Gs`` count cards), volumes, the
    containerizer, an extra-config JSON file, ``--worker-logs``,
    ``--gang``, the restart flags and ``--mesh``."""
    p = argparse.ArgumentParser(
        prog="tfrun",
        description="Run a distributed command on every task of a "
                    "ps/worker cluster (local backend).")
    p.add_argument("-w", "--nworker", type=int, required=True,
                   help="number of worker tasks (the data-parallel axis)")
    p.add_argument("-s", "--nserver", type=int, required=True,
                   help="number of server (ps) tasks; with any, the "
                        "default mesh axis is fsdp")
    p.add_argument("-m", "--master", type=str, default=None,
                   help="Mesos master (not ported yet, ROADMAP A.12 (g)); "
                        "default env MESOS_MASTER, else the local backend")
    p.add_argument("-n", "--name", type=str, default=None,
                   help="framework name")
    p.add_argument("-C", "--containerizer_type", choices=["MESOS", "DOCKER"],
                   default=None)
    p.add_argument("-f", "--force_pull_image", action="store_true")
    p.add_argument("-Cw", "--worker_cpus", type=float, default=1.0)
    p.add_argument("-Gw", "--worker_chips", type=int, default=0,
                   help="cards per worker")
    p.add_argument("-Mw", "--worker_mem", type=float, default=1024.0)
    p.add_argument("-Cs", "--server_cpus", type=float, default=1.0)
    p.add_argument("-Gs", "--server_chips", type=int, default=0)
    p.add_argument("-Ms", "--server_mem", type=float, default=1024.0)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-V", "--volume", action="append", default=[],
                   metavar="SRC:DST", help="host->container mount "
                                           "(repeatable)")
    p.add_argument("-r", "--role", type=str, default="*")
    p.add_argument("-e", "--extra_config", type=str, default=None,
                   metavar="FILE.json",
                   help="JSON file with extra config (initializer / "
                        "finalizer hooks etc.)")
    p.add_argument("--worker-logs", type=str, default="0",
                   help="comma-separated worker indices (or '*') whose "
                        "output to collect; default the chief only")
    p.add_argument("--gang", action="store_true",
                   help="all-or-nothing placement")
    p.add_argument("--restarts", type=int, default=0,
                   help="restart the whole cluster up to N times on any "
                        "cluster failure, bring-up or post-start (a "
                        "crashed command and dead infrastructure both "
                        "report TASK_FAILED); pair with checkpoints. "
                        "Default 0: fail fast")
    p.add_argument("--restart-policy", choices=["fail_fast", "elastic"],
                   default="fail_fast", dest="restart_policy",
                   help="post-start failure policy: fail_fast aborts on "
                        "any task death; elastic tears the survivors "
                        "down, bumps the gang generation and re-forms "
                        "from fresh offers with backoff; the tasks rerun "
                        "their command and resume from their checkpoints")
    p.add_argument("--max-cluster-restarts", type=int, default=3,
                   dest="max_cluster_restarts",
                   help="elastic restart budget: at most N re-formations "
                        "per sliding --restart-window, then fatal")
    p.add_argument("--restart-window", type=float, default=600.0,
                   dest="restart_window",
                   help="seconds the elastic restart budget counts over")
    p.add_argument("--mesh", type=str, default=None,
                   help="mesh axes handed to the tasks, e.g. dp=-1, "
                        "fsdp=4 or dp=2,tp=2 (dp, fsdp and tp; sp, pp, ep "
                        "and dcn. axes are not ported yet)")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="command to run on every task (placeholders: "
                        "{ps_hosts} {worker_hosts} {job_name} {task_index} "
                        "{rank} {world_size} {coordinator})")
    return p


def parse_mesh(spec: Optional[str]) -> Optional[Dict[str, int]]:
    """``"dp=4"`` -> ``{"dp": 4}``; ``ValueError`` for a malformed axis
    or one the port does not have yet (``parallel.mesh.check_axes``)."""
    from tfmesos_tpu_torch.parallel.mesh import check_axes

    if not spec:
        return None
    axes = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        if not size:
            raise ValueError(f"bad mesh axis {part!r}; want name=size")
        axes[name.strip()] = int(size)
    return check_axes(axes)


def parse_volumes(volumes: List[str]) -> Dict[str, str]:
    out = {}
    for v in volumes:
        src, _, dst = v.partition(":")
        if not dst:
            raise ValueError(f"bad volume {v!r}; want src:dst")
        out[src] = dst
    return out


class LogCollector:
    """Accepts the connections of the tasks whose logs were asked for
    and splices their lines (already ``[job:index]``-prefixed by the
    node runtime) onto our stdout."""

    def __init__(self) -> None:
        self._listen = wire.bind_ephemeral()
        self.addr = wire.sock_addr(self._listen)
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listen, selectors.EVENT_READ, "accept")

    def pump(self, timeout: float = 0.1) -> None:
        for key, _ in self._sel.select(timeout=timeout):
            if key.data == "accept":
                conn, _ = self._listen.accept()
                conn.setblocking(False)
                self._sel.register(conn, selectors.EVENT_READ, "conn")
                continue
            try:
                data = key.fileobj.recv(65536)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                data = b""
            if not data:
                self._sel.unregister(key.fileobj)
                key.fileobj.close()
                continue
            sys.stdout.buffer.write(data)
            sys.stdout.buffer.flush()

    def close(self) -> None:
        self.pump(timeout=0)  # drain anything already queued
        for key in list(self._sel.get_map().values()):
            if key.data == "conn":
                key.fileobj.close()
        self._sel.close()
        self._listen.close()


def forward_map(worker_logs: str, nworker: int,
                collector_addr: str) -> Dict[str, str]:
    """``--worker-logs`` ``'0'`` | ``'1,3'`` | ``'*'`` -> the
    ``forward_addresses`` of the scheduler."""
    if worker_logs.strip() == "*":
        return {f"worker:{i}": collector_addr for i in range(nworker)}
    out = {}
    for tok in worker_logs.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if not tok.isdigit():
            raise ValueError(f"bad --worker-logs entry {tok!r}; want "
                             f"indices or '*'")
        out[f"worker:{tok}"] = collector_addr
    return out


def run_main(argv: Optional[List[str]] = None) -> int:
    """``tfrun``: exit 0 when the workers finished, 1 when the cluster
    failed (one line on stderr), 2 on a usage or config error."""
    from tfmesos_tpu_torch import cluster
    from tfmesos_tpu_torch.scheduler import ClusterError
    from tfmesos_tpu_torch.spec import Job

    args = build_parser().parse_args(argv)
    cmd_parts = list(args.cmd)
    if cmd_parts and cmd_parts[0] == "--":
        cmd_parts = cmd_parts[1:]
    if not cmd_parts:
        print("tfrun: no command given", file=sys.stderr)
        return 2
    cmd = " ".join(cmd_parts)  # one shell string

    try:
        mesh_axes = parse_mesh(args.mesh)
        volumes = parse_volumes(args.volume)
        forward_map(args.worker_logs, args.nworker, "validate:0")
    except ValueError as e:
        print(f"tfrun: {e}", file=sys.stderr)
        return 2

    extra_config = {}
    if args.extra_config:
        try:
            with open(args.extra_config) as f:
                extra_config = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"tfrun: cannot read extra config "
                  f"{args.extra_config!r}: {e}", file=sys.stderr)
            return 2

    jobs = []
    if args.nserver > 0:
        jobs.append(Job(name="ps", num=args.nserver, cpus=args.server_cpus,
                        mem=args.server_mem, chips=args.server_chips,
                        cmd=cmd))
    jobs.append(Job(name="worker", num=args.nworker, cpus=args.worker_cpus,
                    mem=args.worker_mem, chips=args.worker_chips, cmd=cmd))

    collector = LogCollector()
    forward = forward_map(args.worker_logs, args.nworker, collector.addr)

    def attempt(i):
        with cluster(jobs, master=args.master, name=args.name,
                     quiet=not args.verbose,
                     containerizer_type=args.containerizer_type,
                     force_pull_image=args.force_pull_image,
                     volumes=volumes, forward_addresses=forward,
                     extra_config=extra_config, role=args.role,
                     gang_scheduling=args.gang,
                     restart_policy=args.restart_policy,
                     max_cluster_restarts=args.max_cluster_restarts,
                     restart_window=args.restart_window,
                     mesh_axes=mesh_axes) as c:
            while not c.finished():
                collector.pump(timeout=0.1)
            # a last drain, so lines racing the finish still land
            deadline = time.monotonic() + 1.0
            while time.monotonic() < deadline:
                collector.pump(timeout=0.1)

    try:
        if args.restarts > 0:
            from tfmesos_tpu_torch.train.supervisor import supervise

            supervise(attempt, max_restarts=args.restarts, restart_wait=2.0)
        else:
            attempt(0)
    except ClusterError as e:
        print(f"tfrun: cluster failed: {e}", file=sys.stderr)
        return 1
    except (ValueError, RuntimeError) as e:
        print(f"tfrun: {e}", file=sys.stderr)
        return 2
    finally:
        collector.close()
    return 0


# -- tfserve --------------------------------------------------------------


def _refused(what: str, item: str) -> int:
    print(f"tfserve: not ported yet: {what} (ROADMAP {item})",
          file=sys.stderr)
    return 2


def build_serve_parser() -> argparse.ArgumentParser:
    """``tfserve`` — the online-serving entry point: gateway + N batcher
    replicas scheduled as Mode-B tasks (fleet subsystem,
    docs/SERVING.md "Online serving & the fleet gateway")."""
    p = argparse.ArgumentParser(
        prog="tfserve",
        description="Serve a model online: a fleet gateway fronting N "
                    "continuous-batching replicas of the PyTorch port, "
                    "scheduled as local Mode-B tasks.")
    p.add_argument("-R", "--replicas", type=int, default=2,
                   help="number of UNIFIED serving replicas (with "
                        "--role, the unified fallback tier; 0 with "
                        "--role runs pure disaggregated)")
    p.add_argument("--role", type=str, default=None, metavar="SPEC",
                   help="disaggregated role split, e.g. "
                        "'prefill:2,decode:2': dedicated prefill "
                        "replicas export KV pages that dedicated "
                        "decode replicas import, so long prefills "
                        "never stall decode ticks; --replicas N still "
                        "adds N unified fallback replicas "
                        "(docs/SERVING.md, docs/MIGRATION.md)")
    p.add_argument("-m", "--master", type=str, default=None,
                   help="Mesos master (host:port or zk://...); default env "
                        "MESOS_MASTER, else local backend")
    p.add_argument("-n", "--name", type=str, default=None,
                   help="framework name")
    p.add_argument("-Cr", "--replica-cpus", type=float, default=1.0,
                   help="CPUs per replica task")
    p.add_argument("-Gr", "--replica-chips", type=int, default=0,
                   help="TPU chips per replica task")
    p.add_argument("-Mr", "--replica-mem", type=float, default=1024.0,
                   help="MB of memory per replica task")
    p.add_argument("-p", "--gateway-port", type=int, default=8780,
                   help="gateway listen port (0 = OS-assigned)")
    p.add_argument("--gateway-host", type=str, default="0.0.0.0")
    p.add_argument("-G", "--gateways", type=int, default=1,
                   help="number of stateless gateway front doors over "
                        "the one registry/router view (the first on "
                        "--gateway-port, the rest OS-assigned): each "
                        "is an event-loop process thread serving "
                        "thousands of connections, clients discover "
                        "the set via 'tfserve gateways' and fail over "
                        "between them (docs/SERVING.md 'Front-door "
                        "scaling')")
    p.add_argument("--gateway-processes", type=int, default=0,
                   dest="gateway_processes",
                   help="run N gateway OS PROCESSES instead of "
                        "in-process gateway threads: they share "
                        "--gateway-port via SO_REUSEPORT where the "
                        "platform has it, else take per-process ports "
                        "behind the 'gateways' discovery op; 0 = "
                        "in-process (docs/SERVING.md 'Multi-process "
                        "gateways')")
    p.add_argument("--http-port", type=int, default=None,
                   dest="http_port",
                   help="serve an OpenAI-style HTTP/1.1 edge (POST "
                        "/v1/completions, stream: true = SSE) next to "
                        "the wire port; default off (docs/SERVING.md "
                        "'HTTP/SSE edge')")
    p.add_argument("--rows", type=int, default=8,
                   help="concurrent decode rows per replica")
    p.add_argument("--max-len", type=int, default=None,
                   help="per-request cache positions (default: model max)")
    p.add_argument("--max-queue", type=int, default=256,
                   help="ingress queue bound (per class); past it "
                        "requests shed with an explicit Overloaded "
                        "rejection")
    p.add_argument("--models", type=str, default=None, metavar="SPEC",
                   help="model catalog, e.g. 'chat:2,code:1,draft:0' "
                        "(model_id:replicas[:seed]) — the fleet serves "
                        "MANY models on one replica budget: replicas "
                        "declare their model, the router routes by it "
                        "(unlabeled requests ride the FIRST entry), "
                        "and the trader reallocates replicas between "
                        "models on relative queue pressure, scaling "
                        "idle models to zero; a :0 entry starts scaled "
                        "to zero and cold-starts through --warm-pool "
                        "(docs/SERVING.md 'Model catalog')")
    p.add_argument("--gang-size", type=int, default=1,
                   dest="gang_size", metavar="N",
                   help="members per UNIFIED replica: each replica is "
                        "an N-task GANG (one model sharded across a "
                        "pod slice) placed all-or-nothing and routed "
                        "as ONE replica via its leader; a member's "
                        "death tears the gang down and re-forms it "
                        "whole; 1 = classic single-process replicas "
                        "(docs/SERVING.md 'Gang replicas')")
    p.add_argument("--warm-pool", type=int, default=0,
                   dest="warm_pool", metavar="N",
                   help="with --models: N pre-warmed UNDEDICATED "
                        "replicas that adopt a model at assignment "
                        "time — a scaled-to-zero model's first request "
                        "costs a weight install, not a process launch "
                        "plus compile")
    p.add_argument("--model-budget", type=int, default=None,
                   dest="model_budget", metavar="N",
                   help="with --models: the fleet-wide replica budget "
                        "the trader reallocates within (default: the "
                        "catalog's boot counts + --warm-pool)")
    p.add_argument("--classes", type=str, default=None, metavar="SPEC",
                   help="admission priority classes, highest first, "
                        "e.g. 'interactive:8,background:1' "
                        "(name:weight[:queue_bound[:model_quota]] — "
                        "model_quota bounds one model's queued slots "
                        "within the class on a --models fleet): each "
                        "class gets "
                        "its own bounded ingress queue served "
                        "weighted-fair, and outranking requests may "
                        "preempt lower-class rows inside the replicas; "
                        "unlabeled requests ride the FIRST class "
                        "(docs/SERVING.md 'Priorities, preemption & "
                        "migration')")
    p.add_argument("--batch-lane", action="store_true", dest="batch_lane",
                   help="add a deadline-less 'batch' priority class "
                        "BELOW every interactive class: batch rows fill "
                        "idle decode slots and leftover tick budget, "
                        "dispatch only when every interactive queue is "
                        "empty, and yield within one tick to an "
                        "interactive arrival via preemption; submit "
                        "with 'tfserve batch' (docs/SERVING.md "
                        "'Offline lane')")
    p.add_argument("--no-migrate", action="store_false", dest="migrate",
                   default=True,
                   help="disable drain migration: scale-downs and "
                        "rollouts wait for in-flight work instead of "
                        "suspending it and resuming on survivors")
    p.add_argument("--no-breakers", action="store_false",
                   dest="breakers", default=True,
                   help="disable the router's per-replica circuit "
                        "breakers (consecutive-failure and latency-"
                        "outlier tripping with half-open probe "
                        "recovery — the gray-failure containment; "
                        "docs/SERVING.md 'Deadlines & failure "
                        "containment')")
    p.add_argument("--rate", type=float, default=None,
                   help="token-bucket admission rate, requests/s "
                        "(default: unlimited)")
    p.add_argument("--burst", type=float, default=None,
                   help="token-bucket burst size (default: max(1, rate))")
    p.add_argument("--workers", type=int, default=8,
                   help="gateway dispatcher threads")
    p.add_argument("--retries", type=int, default=2,
                   help="max failovers to a different replica per request")
    p.add_argument("--prefix-cache", type=int, default=64,
                   metavar="PAGES", dest="prefix_cache",
                   help="per-replica cross-request prefix cache budget "
                        "in KV pool pages per mesh data shard (0 "
                        "disables); warm shared-system-prompt requests "
                        "prefill only their uncached tail, and the "
                        "gateway routes shared prefixes to the replica "
                        "already holding them (prefix-affinity)")
    p.add_argument("--pipeline-depth", type=int, default=0,
                   choices=(0, 1), dest="pipeline_depth",
                   help="1 pipelines each replica's decode loop with a "
                        "device-resident carry (dispatch block N+1 "
                        "before syncing block N's tokens; token "
                        "streams identical to 0, the synchronous "
                        "default — docs/SERVING.md)")
    p.add_argument("--fused-prefill", action="store_true",
                   dest="fused_prefill",
                   help="stall-free decode ticks: fuse a token-budgeted "
                        "slice of prefill chunk tokens into the SAME "
                        "device dispatch as the decode rows (Sarathi-"
                        "style), so admitting a long prompt no longer "
                        "stalls live streams; token streams identical "
                        "to the phase-split default (docs/SERVING.md "
                        "'Stall-free fused scheduling')")
    p.add_argument("--tokens-per-tick", type=int, default=None,
                   dest="tokens_per_tick", metavar="T",
                   help="with --fused-prefill: the per-tick token "
                        "budget shared by decode rows and fused "
                        "prefill chunks (default: rows + one chunk)")
    p.add_argument("--kv-placement", type=str, default="rendezvous",
                   dest="kv_placement",
                   choices=("rendezvous", "loaded"),
                   help="replicated-park peer placement policy on the "
                        "cross-host KV fabric: 'rendezvous' (pure "
                        "HRW, the default) or 'loaded' (occupancy-"
                        "bucketed HRW that steers parks away from "
                        "full peers; tune via 'tfserve simulate "
                        "sessions --sweep kv_placement=...')")
    p.add_argument("--draft", action="store_true",
                   help="replicas serve with a DRAFT companion model "
                        "(speculative decoding): each tick commits "
                        "1..n_draft+1 tokens instead of exactly 1 — "
                        "the single-stream latency lever — and it "
                        "composes with --prefix-cache, --kv-tier-mb, "
                        "disagg roles, and migration; the fleet-wide "
                        "draft acceptance rate is the 'spec' gauge in "
                        "'tfserve metrics' (docs/SERVING.md "
                        "'Speculative decoding & composition')")
    p.add_argument("--n-draft", type=int, default=4, dest="n_draft",
                   metavar="K",
                   help="draft proposals per speculative round "
                        "(with --draft)")
    p.add_argument("--kv-tier-mb", type=float, default=0.0,
                   dest="kv_tier_mb", metavar="MB",
                   help="per-replica host-RAM KV tier budget in MB (0 "
                        "disables, the default — zero behavior "
                        "change): prefix pages evicted from the device "
                        "pool spill into it and promote back on the "
                        "next hit, and 'tfserve submit --session ID' "
                        "requests park their conversation KV between "
                        "turns, resuming with only the new tail "
                        "prefilled (docs/SERVING.md 'KV tiering & "
                        "sessions')")
    p.add_argument("--kv-tier-dir", type=str, default=None,
                   dest="kv_tier_dir", metavar="DIR",
                   help="disk tier directory shared by the host's "
                        "replicas (bounded at 4x the RAM budget; "
                        "HMAC-framed entries, stale-version entries "
                        "read as misses); default with --kv-tier-mb: "
                        "a per-run temp directory, so co-located "
                        "replicas resume each other's parked sessions")
    p.add_argument("--kv-replication", type=int, default=1,
                   dest="kv_replication", metavar="K",
                   help="K-way replicated session parking on the "
                        "cross-host KV fabric (1 disables, the "
                        "default): a park acknowledges only after the "
                        "artifact lands on the parker PLUS K-1 peers, "
                        "so a parked session survives its parking "
                        "host's death and resumes token-identical "
                        "elsewhere (docs/SERVING.md 'Cross-host KV "
                        "fabric')")
    p.add_argument("--kv-replicas", type=int, default=0,
                   dest="kv_replicas", metavar="N",
                   help="dedicated KV-role replicas (storage-only "
                        "fabric peers that never serve tokens): "
                        "replicated parks land there first, so "
                        "artifacts survive every serving replica of a "
                        "model scaling to zero; needs --kv-tier-mb")
    p.add_argument("--warmup", action="store_true",
                   help="replicas compile every jitted serving entry "
                        "point at boot before taking traffic: they "
                        "register as 'warming' (never routed), warm, "
                        "then flip alive — and any elastic/Mode-B "
                        "relaunch re-warms the same way, so a cold "
                        "replica's first request never pays a compile")
    p.add_argument("--autoscale", action="store_true",
                   help="run the fleet autoscaler: a control loop that "
                        "grows/shrinks each tier from live load "
                        "signals (queue-wait p99 for prompt tiers, KV "
                        "headroom for decode) within --min/--max-"
                        "replicas, launching with --warmup semantics "
                        "and shrinking by drain-then-kill "
                        "(docs/SERVING.md 'Autoscaling')")
    p.add_argument("--min-replicas", type=int, default=None,
                   dest="min_replicas",
                   help="autoscale floor per tier (default 1; a "
                        "routable tier never scales to zero)")
    p.add_argument("--max-replicas", type=int, default=None,
                   dest="max_replicas",
                   help="autoscale ceiling per tier (default: twice "
                        "the initial count)")
    p.add_argument("--weights-version", type=str, default="v0",
                   dest="weights_version",
                   help="weights version label the boot replicas "
                        "advertise; 'tfserve rollout --version NEW' "
                        "later replaces the fleet blue-green with zero "
                        "downtime (docs/SERVING.md 'Blue-green "
                        "rollout')")
    p.add_argument("--tiny", action="store_true",
                   help="serve the tiny CI model (dev/demo)")
    p.add_argument("--device", type=str, default=None,
                   choices=("cpu",),
                   help="the replicas' device (default: the card; "
                        "'cpu' for development without one)")
    p.add_argument("--metrics-interval", type=float, default=10.0,
                   help="seconds between fleet metrics log lines "
                        "(0 disables)")
    p.add_argument("--metrics-port", type=int, default=None,
                   dest="metrics_port",
                   help="serve Prometheus exposition on this loopback "
                        "port (GET /metrics, stdlib HTTP; "
                        "/metrics.json for the raw snapshot); default: "
                        "no endpoint — the snapshot stays reachable "
                        "through the gateway's authenticated metrics "
                        "op ('tfserve metrics')")
    p.add_argument("--trace-sample", type=float, default=0.05,
                   dest="trace_sample",
                   help="fraction of requests whose trace keeps FULL "
                        "span detail (every request keeps a summary; "
                        "failed/shed/deadline-exceeded/slow requests "
                        "keep detail regardless — tail-based "
                        "retention, docs/SERVING.md 'Observability')")
    p.add_argument("--trace-slow-ms", type=float, default=1000.0,
                   dest="trace_slow_ms",
                   help="requests slower than this keep full span "
                        "detail even when unsampled (the tail rule's "
                        "latency threshold; replicas apply it "
                        "hop-locally too)")
    p.add_argument("-v", "--verbose", action="store_true")
    for action in p._actions:
        item = next((i for f, _, _, i in NOT_PORTED_FLAGS
                     if f in action.option_strings), None)
        if item is not None:
            action.help = f"(not ported yet, ROADMAP {item}) {action.help}"
    return p


def parse_role_spec(spec: Optional[str]) -> dict:
    """``'prefill:2,decode:2'`` → ``{"prefill": 2, "decode": 2}``.
    Both disaggregated tiers must appear (a lone tier cannot serve the
    prefill→decode handoff); counts must be positive ints."""
    if not spec:
        return {}
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        role, _, num = part.partition(":")
        role = role.strip()
        if role not in ("prefill", "decode"):
            raise ValueError(f"bad --role entry {part!r}; want "
                             f"'prefill:N,decode:M'")
        try:
            n = int(num)
        except ValueError:
            raise ValueError(f"bad --role count in {part!r}") from None
        if n < 1:
            raise ValueError(f"--role count must be >= 1 in {part!r}")
        if role in out:
            raise ValueError(f"duplicate --role entry for {role!r}")
        out[role] = n
    if set(out) != {"prefill", "decode"}:
        raise ValueError("--role needs BOTH tiers, e.g. "
                         "'prefill:2,decode:2'")
    return out


def parse_model_spec(spec: Optional[str]):
    """``'chat:2,code:1:7,draft:0'`` → ModelSpec list
    (``model_id:replicas[:seed]``, seed defaulting to the entry's
    index so two entries are two distinct models).  The FIRST entry is
    the default for model-less requests; ``:0`` entries boot scaled to
    zero (cold-started through the warm pool on first demand)."""
    from tfmesos_tpu_torch.fleet.catalog import ModelSpec

    if not spec:
        return None
    out = []
    for i, part in enumerate(p.strip() for p in spec.split(",")
                             if p.strip()):
        bits = part.split(":")
        if len(bits) not in (2, 3) or not bits[0]:
            raise ValueError(f"bad --models entry {part!r}; want "
                             f"model_id:replicas[:seed]")
        try:
            replicas = int(bits[1])
            seed = int(bits[2]) if len(bits) == 3 else i
        except ValueError:
            raise ValueError(
                f"bad --models numbers in {part!r}") from None
        try:
            out.append(ModelSpec(model_id=bits[0], replicas=replicas,
                                 seed=seed))
        except ValueError as e:
            raise ValueError(f"bad --models entry {part!r}: {e}") \
                from None
    if not out:
        raise ValueError("--models is empty")
    if len({s.model_id for s in out}) != len(out):
        raise ValueError("duplicate model_id in --models")
    return out


def parse_class_spec(spec: Optional[str]):
    """``'interactive:8,background:1'`` → PriorityClass list, listed
    highest-priority FIRST: the first class is the default for
    unlabeled requests and gets the highest preemption rank; each entry
    is ``name:weight[:queue_bound]``."""
    from tfmesos_tpu_torch.fleet.admission import PriorityClass

    if not spec:
        return None
    entries = [part.strip() for part in spec.split(",") if part.strip()]
    out = []
    for i, part in enumerate(entries):
        bits = part.split(":")
        if len(bits) not in (2, 3, 4) or not bits[0]:
            raise ValueError(f"bad --classes entry {part!r}; want "
                             f"name:weight[:queue_bound[:model_quota]]")
        try:
            weight = float(bits[1])
            maxq = int(bits[2]) if len(bits) >= 3 else None
            quota = int(bits[3]) if len(bits) == 4 else None
        except ValueError:
            raise ValueError(f"bad --classes numbers in {part!r}") from None
        try:
            out.append(PriorityClass(name=bits[0], weight=weight,
                                     rank=len(entries) - 1 - i,
                                     max_queue=maxq,
                                     model_quota=quota))
        except ValueError as e:
            raise ValueError(f"bad --classes entry {part!r}: {e}") from None
    if len({c.name for c in out}) != len(out):
        raise ValueError("duplicate class name in --classes")
    return out


def build_submit_parser() -> argparse.ArgumentParser:
    """``tfserve submit`` — send one generation request to a RUNNING
    fleet gateway (smoke/debug surface; real clients use
    ``fleet.client.FleetClient``)."""
    p = argparse.ArgumentParser(
        prog="tfserve submit",
        description="Submit one generation request to a running fleet "
                    "gateway and print the completion.")
    p.add_argument("-g", "--gateway", type=str, required=True,
                   metavar="HOST:PORT", help="the running gateway")
    p.add_argument("--prompt", type=str, required=True,
                   help="comma-separated prompt token ids, e.g. '1,2,3'")
    p.add_argument("-n", "--max-new-tokens", type=int, default=16,
                   dest="max_new_tokens")
    p.add_argument("--stop-token", type=int, default=None,
                   dest="stop_token")
    p.add_argument("--priority", type=str, default=None,
                   help="admission class label (e.g. 'background'); "
                        "unlabeled requests ride the fleet's default "
                        "class")
    p.add_argument("--deadline-ms", type=float, default=None,
                   dest="deadline_ms",
                   help="end-to-end deadline in ms from gateway "
                        "receipt: expired work is shed in the "
                        "admission queue, failed fast by the router, "
                        "and cancelled inside the replicas (an "
                        "explicit deadline_exceeded error, never a "
                        "late answer); default: no deadline — the "
                        "fleet's flat request timeout applies "
                        "(docs/MIGRATION.md)")
    p.add_argument("--trace", action="store_true",
                   help="ask the fleet to keep FULL span detail for "
                        "this request's trace; the printed trace_id "
                        "feeds 'tfserve trace -g GW --id ID' (every "
                        "request gets a summary trace regardless)")
    p.add_argument("--session", type=str, default=None,
                   help="multi-turn session id: on a KV-tiered fleet "
                        "(tfserve --kv-tier-mb) the finished request's "
                        "KV parks under this id, and a later submit "
                        "whose --prompt extends the conversation "
                        "(prior prompt + returned tokens + new turn) "
                        "resumes from it, prefilling only the tail "
                        "(docs/SERVING.md 'KV tiering & sessions')")
    p.add_argument("--model", type=str, default=None,
                   help="catalog model this request targets (tfserve "
                        "--models); absent rides the fleet's DEFAULT "
                        "(first-listed) entry — a scaled-to-zero "
                        "model's request cold-starts it through the "
                        "warm pool (docs/SERVING.md 'Model catalog')")
    p.add_argument("--timeout", type=float, default=300.0)
    return p


def submit_main(argv: List[str]) -> int:
    args = build_submit_parser().parse_args(argv)
    from tfmesos_tpu_torch.fleet.client import (FleetClient, Overloaded,
                                                RequestFailed)

    token = wire.load_token()
    if not token:
        print(f"tfserve submit: no cluster token — set {wire.TOKEN_ENV} "
              f"or {wire.TOKEN_FILE_ENV} (tfserve printed the token "
              f"file at startup)", file=sys.stderr)
        return 2
    try:
        prompt = [int(t) for t in args.prompt.split(",") if t.strip()]
    except ValueError:
        print(f"tfserve submit: bad --prompt {args.prompt!r}; want "
              f"comma-separated ints", file=sys.stderr)
        return 2
    if not prompt:
        print("tfserve submit: --prompt is empty", file=sys.stderr)
        return 2
    client = None
    try:
        client = FleetClient(args.gateway, token, timeout=args.timeout)
        out = client.generate(prompt, args.max_new_tokens,
                              stop_token=args.stop_token,
                              priority=args.priority,
                              deadline_ms=args.deadline_ms,
                              trace=args.trace or None,
                              session=args.session,
                              model=args.model)
    except Overloaded as e:
        print(f"tfserve submit: shed ({e.kind}): {e} — back off and "
              f"retry", file=sys.stderr)
        return 1
    except RequestFailed as e:
        print(f"tfserve submit: {e.kind}: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"tfserve submit: cannot reach gateway {args.gateway}: "
              f"{e}", file=sys.stderr)
        return 1
    finally:
        if client is not None:
            client.close()
    print(json.dumps({"tokens": out.get("tokens"),
                      "ttft_ms": out.get("ttft_ms"),
                      "total_ms": out.get("total_ms"),
                      "trace_id": out.get("trace_id")}))
    return 0


def build_trace_parser() -> argparse.ArgumentParser:
    """``tfserve trace`` — fetch request traces from a RUNNING fleet
    gateway and print human-readable waterfalls (docs/SERVING.md
    "Observability")."""
    p = argparse.ArgumentParser(
        prog="tfserve trace",
        description="Fetch request traces from a running fleet "
                    "gateway: one waterfall by id, the N slowest, the "
                    "newest failures, or the recent summaries.")
    p.add_argument("-g", "--gateway", type=str, required=True,
                   metavar="HOST:PORT", help="the running gateway")
    group = p.add_mutually_exclusive_group()
    group.add_argument("--id", type=str, default=None, dest="trace_id",
                       help="one trace by id (as printed on every "
                            "completion/error reply)")
    group.add_argument("--slowest", type=int, default=None, metavar="N",
                       help="the N slowest known traces")
    group.add_argument("--failed", action="store_true",
                       help="the newest failed/shed/deadline-exceeded "
                            "traces")
    p.add_argument("--limit", type=int, default=20,
                   help="max records for the summary/failed listings")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the raw trace records as one JSON array "
                        "instead of waterfalls — the machine-readable "
                        "export `tfserve simulate --replay` consumes "
                        "(docs/SIMULATOR.md), and offline-analysis "
                        "input generally")
    p.add_argument("--timeout", type=float, default=10.0)
    return p


def trace_main(argv: List[str]) -> int:
    args = build_trace_parser().parse_args(argv)
    from tfmesos_tpu_torch.fleet.client import FleetClient
    from tfmesos_tpu_torch.fleet.tracing import format_waterfall

    token = wire.load_token()
    if not token:
        print(f"tfserve trace: no cluster token — set {wire.TOKEN_ENV} "
              f"or {wire.TOKEN_FILE_ENV} (tfserve printed the token "
              f"file at startup)", file=sys.stderr)
        return 2
    client = None
    try:
        client = FleetClient(args.gateway, token, timeout=args.timeout)
        traces = client.trace(trace_id=args.trace_id,
                              slowest=args.slowest, failed=args.failed,
                              limit=args.limit, timeout=args.timeout)
    except OSError as e:
        print(f"tfserve trace: cannot reach gateway {args.gateway}: "
              f"{e}", file=sys.stderr)
        return 1
    finally:
        if client is not None:
            client.close()
    if args.as_json:
        # Machine-readable export, empty result included (an empty
        # book is a valid export, not an error for a pipeline).
        print(json.dumps(traces), flush=True)
        return 0
    if not traces:
        what = (f"trace {args.trace_id!r}" if args.trace_id
                else "matching traces")
        print(f"tfserve trace: no {what} in the gateway's book (the "
              f"book is bounded — detail is retained for sampled, "
              f"failed, and slow requests)", file=sys.stderr)
        return 1
    if args.trace_id or args.slowest or args.failed:
        for rec in traces:
            print(format_waterfall(rec), flush=True)
            print()
    else:
        for rec in traces:     # summary listing: one line each
            summ = rec.get("summary") or {}
            extra = " ".join(f"{k}={v}" for k, v in sorted(summ.items()))
            print(f"{rec.get('trace_id')}  {rec.get('status'):<20} "
                  f"{rec.get('total_ms', 0):>10.1f}ms  "
                  f"{'detail' if rec.get('detailed') else 'summary':<7} "
                  f"{extra}", flush=True)
    return 0


def build_gateways_parser() -> argparse.ArgumentParser:
    """``tfserve gateways`` — list a fleet's registered front doors
    (client-side discovery for multi-gateway failover)."""
    p = argparse.ArgumentParser(
        prog="tfserve gateways",
        description="List the fleet's registered gateway addresses "
                    "(the `gateways` discovery op ANY gateway serves).")
    p.add_argument("-g", "--gateway", type=str, required=True,
                   metavar="HOST:PORT",
                   help="any running gateway of the fleet")
    p.add_argument("--timeout", type=float, default=10.0)
    return p


def gateways_main(argv: List[str]) -> int:
    args = build_gateways_parser().parse_args(argv)
    from tfmesos_tpu_torch.fleet.client import FleetClient

    token = wire.load_token()
    if not token:
        print(f"tfserve gateways: no cluster token — set "
              f"{wire.TOKEN_ENV} or {wire.TOKEN_FILE_ENV} (tfserve "
              f"printed the token file at startup)", file=sys.stderr)
        return 2
    try:
        client = FleetClient(args.gateway, token, timeout=args.timeout)
        try:
            addrs = client.gateways(timeout=args.timeout)
        finally:
            client.close()
    except OSError as e:
        print(f"tfserve gateways: cannot reach gateway "
              f"{args.gateway}: {e}", file=sys.stderr)
        return 1
    if not addrs:
        print("tfserve gateways: none registered (single-gateway "
              "fleet predating discovery, or the registry restarted)")
        return 0
    for addr in addrs:
        print(addr)
    return 0


def build_metrics_parser() -> argparse.ArgumentParser:
    """``tfserve metrics`` — fetch the gateway snapshot and
    pretty-print it (until now the JSON snapshot was only reachable
    from bench code)."""
    p = argparse.ArgumentParser(
        prog="tfserve metrics",
        description="Fetch a running fleet gateway's metrics snapshot "
                    "and print counters/gauges/histograms as tables.")
    p.add_argument("-g", "--gateway", type=str, required=True,
                   metavar="HOST:PORT", help="the running gateway")
    p.add_argument("--json", action="store_true",
                   help="print the raw JSON snapshot instead of tables")
    p.add_argument("--timeout", type=float, default=10.0)
    return p


def metrics_main(argv: List[str]) -> int:
    args = build_metrics_parser().parse_args(argv)
    from tfmesos_tpu_torch.fleet.client import FleetClient

    token = wire.load_token()
    if not token:
        print(f"tfserve metrics: no cluster token — set "
              f"{wire.TOKEN_ENV} or {wire.TOKEN_FILE_ENV} (tfserve "
              f"printed the token file at startup)", file=sys.stderr)
        return 2
    client = None
    try:
        client = FleetClient(args.gateway, token, timeout=args.timeout)
        snap = client.metrics(timeout=args.timeout)
    except OSError as e:
        print(f"tfserve metrics: cannot reach gateway {args.gateway}: "
              f"{e}", file=sys.stderr)
        return 1
    finally:
        if client is not None:
            client.close()
    if args.json:
        print(json.dumps(snap, indent=2, sort_keys=True))
        return 0
    counters = snap.get("counters") or {}
    gauges = snap.get("gauges") or {}
    hists = snap.get("histograms") or {}
    if counters:
        print("counters:")
        width = max(len(k) for k in counters)
        for name in sorted(counters):
            print(f"  {name:<{width}}  {counters[name]}")
    if gauges:
        print("gauges:")
        width = max(len(k) for k in gauges)
        for name in sorted(gauges):
            print(f"  {name:<{width}}  {gauges[name]}")
    if hists:
        print("histograms:")
        width = max(len(k) for k in hists)
        cols = ("count", "mean", "p50", "p90", "p99", "max")
        head = "".join(f"{c:>10}" for c in cols)
        print(f"  {'':<{width}}{head}")
        for name in sorted(hists):
            h = hists[name]
            row = "".join(f"{h.get(c, ''):>10}" for c in cols)
            print(f"  {name:<{width}}{row}")
    if not (counters or gauges or hists):
        print("tfserve metrics: empty snapshot")
    return 0


def build_swap_adapter_parser() -> argparse.ArgumentParser:
    """``tfserve swap-adapter`` — hot-swap a LoRA-style weight delta
    onto every replica of one catalog model with zero downtime
    (docs/SERVING.md 'Model catalog')."""
    p = argparse.ArgumentParser(
        prog="tfserve swap-adapter",
        description="Fold a weight delta (an .npz of param-path -> "
                    "array entries) into one catalog model's replicas "
                    "between generations: in-flight requests finish on "
                    "the old delta, streams stay token-identical per "
                    "delta version, zero downtime.")
    p.add_argument("-g", "--gateway", type=str, required=True,
                   metavar="HOST:PORT", help="the running gateway")
    p.add_argument("--model", type=str, required=True,
                   help="the catalog model_id to swap")
    p.add_argument("--version", type=str, required=True,
                   dest="adapter_version",
                   help="label of the resulting adapter state (same "
                        "charset as model ids)")
    p.add_argument("--npz", type=str, required=True,
                   help=".npz file whose entries map param paths "
                        "(e.g. 'layers/wq') to delta arrays added "
                        "onto the matching leaves")
    p.add_argument("--timeout", type=float, default=900.0,
                   help="seconds to wait (the swap waits for every "
                        "replica's in-flight generations)")
    return p


def swap_adapter_main(argv: List[str]) -> int:
    args = build_swap_adapter_parser().parse_args(argv)
    from tfmesos_tpu_torch.fleet.client import FleetClient, RequestFailed

    token = wire.load_token()
    if not token:
        print(f"tfserve swap-adapter: no cluster token — set "
              f"{wire.TOKEN_ENV} or {wire.TOKEN_FILE_ENV} (tfserve "
              f"printed the token file at startup)", file=sys.stderr)
        return 2
    try:
        import numpy as np

        with np.load(args.npz) as z:
            delta = {k: z[k] for k in z.files}
    except (OSError, ValueError) as e:
        print(f"tfserve swap-adapter: cannot load {args.npz}: {e}",
              file=sys.stderr)
        return 2
    if not delta:
        print(f"tfserve swap-adapter: {args.npz} holds no arrays",
              file=sys.stderr)
        return 2
    client = None
    try:
        client = FleetClient(args.gateway, token, timeout=args.timeout)
        out = client.swap_adapter(args.model, args.adapter_version,
                                  delta, timeout=args.timeout)
    except RequestFailed as e:
        print(f"tfserve swap-adapter: {e.kind}: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"tfserve swap-adapter: cannot reach gateway "
              f"{args.gateway}: {e}", file=sys.stderr)
        return 1
    finally:
        if client is not None:
            client.close()
    print(f"tfserve swap-adapter: model {out.get('model_id')} now "
          f"serves adapter {out.get('adapter_version')} on "
          f"{out.get('replicas')} replica(s)", flush=True)
    return 0


def build_rollout_parser() -> argparse.ArgumentParser:
    """``tfserve rollout`` — drive a blue-green weight rollout on a
    RUNNING fleet through the gateway's authenticated control op."""
    p = argparse.ArgumentParser(
        prog="tfserve rollout",
        description="Shift a running fleet to a new weights version "
                    "with zero downtime: launch a new-version replica "
                    "set, warm it, shift routing, drain and reap the "
                    "old tier (docs/SERVING.md 'Blue-green rollout').")
    p.add_argument("-g", "--gateway", type=str, required=True,
                   metavar="HOST:PORT", help="the running gateway")
    p.add_argument("--version", type=str, required=True,
                   dest="weights_version",
                   help="the new weights version label")
    p.add_argument("--timeout", type=float, default=900.0,
                   help="seconds to wait for completion (a rollout "
                        "spans a full tier warmup plus the old tier's "
                        "drain)")
    return p


def rollout_main(argv: List[str]) -> int:
    args = build_rollout_parser().parse_args(argv)
    from tfmesos_tpu_torch.fleet.client import (CallTimeout, FleetClient,
                                          RequestFailed)

    token = wire.load_token()
    if not token:
        print(f"tfserve rollout: no cluster token — set "
              f"{wire.TOKEN_ENV} or {wire.TOKEN_FILE_ENV} (tfserve "
              f"printed the token file at startup)", file=sys.stderr)
        return 2
    client = None
    try:
        # Inside the try: FleetClient dials the gateway in its
        # constructor, so an unreachable host must land in the OSError
        # branch below, not escape as a traceback.
        client = FleetClient(args.gateway, token, timeout=args.timeout)
        out = client.rollout(args.weights_version, timeout=args.timeout)
    except RequestFailed as e:
        print(f"tfserve rollout: {e.kind}: {e}", file=sys.stderr)
        return 1
    except CallTimeout as e:
        # Before the generic OSError branch (CallTimeout IS an OSError
        # subclass): no reply within --timeout means the rollout may
        # STILL BE RUNNING server-side, not that the gateway is down.
        print(f"tfserve rollout: no reply within {args.timeout:.0f}s — "
              f"the rollout may still be in progress; watch the "
              f"gateway's roles gauge (versions) and raise --timeout "
              f"({e})", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"tfserve rollout: cannot reach gateway "
              f"{args.gateway}: {e}", file=sys.stderr)
        return 1
    finally:
        if client is not None:
            client.close()
    print(f"tfserve rollout: fleet now serves weights_version "
          f"{out.get('new_version')} (was {out.get('old_version')}; "
          f"{out.get('replicas')} replica(s) launched, "
          f"{out.get('reaped')} reaped, generation fence "
          f"{out.get('generation')})", flush=True)
    return 0


def _build_fleet(args, models, roles, classes, token):
    """Construct the FleetServer from parsed ``tfserve`` args; its
    constructor ValueErrors (bad flag combinations) surface to the
    caller for the clean exit-2 path."""
    from tfmesos_tpu_torch.fleet.launcher import FleetServer

    return FleetServer(
        replicas=args.replicas, rows=args.rows, tiny=args.tiny,
        prefill_replicas=roles.get("prefill", 0),
        decode_replicas=roles.get("decode", 0),
        models=models,
        warm_pool=args.warm_pool,
        model_budget=args.model_budget,
        device=args.device,
        weights_version=args.weights_version,
        autoscale=args.autoscale,
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        max_len=args.max_len,
        replica_cpus=args.replica_cpus, replica_mem=args.replica_mem,
        replica_chips=args.replica_chips,
        gateway_host=args.gateway_host, gateway_port=args.gateway_port,
        gateways=args.gateways,
        workers=args.workers, max_queue=args.max_queue, rate=args.rate,
        burst=args.burst, max_retries=args.retries,
        priority_classes=classes, migrate_on_drain=args.migrate,
        breakers=args.breakers,
        prefix_cache_pages=args.prefix_cache,
        pipeline_depth=args.pipeline_depth,
        fused_prefill=args.fused_prefill,
        tokens_per_tick=args.tokens_per_tick,
        kv_tier_mb=args.kv_tier_mb, kv_tier_dir=args.kv_tier_dir,
        kv_replication=args.kv_replication,
        kv_replicas=args.kv_replicas,
        kv_placement=args.kv_placement,
        draft=args.draft, n_draft=args.n_draft,
        warmup=args.warmup,
        report_interval=args.metrics_interval or None,
        metrics_port=args.metrics_port,
        trace_sample=args.trace_sample,
        trace_slow_ms=args.trace_slow_ms,
        quiet=not args.verbose, token=token)


def serve_main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in SUBCOMMANDS:
        return SUBCOMMANDS[argv[0]](argv[1:])
    if argv and argv[0] in NOT_PORTED_SUBCOMMANDS:
        return _refused(argv[0], NOT_PORTED_SUBCOMMANDS[argv[0]])
    args = build_serve_parser().parse_args(argv)
    # The JAX fleet's own range check of a refused flag comes first, so
    # a bad value reads as it does there.
    if args.gang_size < 1:
        print(f"tfserve: gang_size must be >= 1, got {args.gang_size}",
              file=sys.stderr)
        return 2
    for flag, dest, default, item in NOT_PORTED_FLAGS:
        if getattr(args, dest) != default:
            return _refused(flag, item)
    try:
        roles = parse_role_spec(args.role)
        classes = parse_class_spec(args.classes)
        models = parse_model_spec(args.models)
    except ValueError as e:
        print(f"tfserve: {e}", file=sys.stderr)
        return 2
    if models and roles:
        print("tfserve: --models runs unified tiers; drop --role",
              file=sys.stderr)
        return 2
    min_replicas = 0 if (roles or models) else 1
    if args.replicas < min_replicas:
        print(f"tfserve: --replicas must be >= {min_replicas}, got "
              f"{args.replicas}", file=sys.stderr)
        return 2
    if args.rows < 1:
        print(f"tfserve: --rows must be >= 1, got {args.rows}",
              file=sys.stderr)
        return 2
    if args.gateways < 1:
        print(f"tfserve: --gateways must be >= 1, got {args.gateways}",
              file=sys.stderr)
        return 2

    from tfmesos_tpu_torch.scheduler import ClusterError

    # Clients must present the cluster token: honor an operator-supplied
    # one (the standard TPUMESOS_TOKEN / TPUMESOS_TOKEN_FILE contract);
    # otherwise mint one and leave it in a mode-0600 file the operator
    # can point clients at.
    token = wire.load_token() or None
    try:
        fleet = _build_fleet(args, models, roles, classes, token)
    except ValueError as e:
        # Constructor validation (bad flag combinations: --warm-pool
        # without --models, a budget below the boot footprint, ...) is
        # an ARGUMENT error: one clean line, exit 2, never a traceback.
        print(f"tfserve: {e}", file=sys.stderr)
        return 2
    try:
        fleet.start()
    except (ClusterError, ValueError, RuntimeError) as e:
        print(f"tfserve: fleet bring-up failed: {e}", file=sys.stderr)
        return 1
    token_file = None
    if token is None:
        import tempfile

        fd, token_file = tempfile.mkstemp(prefix="tfserve-token-")
        with os.fdopen(fd, "w") as f:   # mkstemp creates mode 0600
            f.write(fleet.token)
        print(f"tfserve: client token file {token_file} (clients set "
              f"{wire.TOKEN_FILE_ENV}={token_file})", flush=True)
    tiers = f"{args.replicas} unified replica(s)"
    if models:
        tiers = (f"{len(models)} catalog model(s) on a "
                 f"{fleet.replica_budget}-replica budget"
                 + (f" + {args.warm_pool} warm-pool"
                    if args.warm_pool else ""))
    if roles:
        tiers += (f" + {roles['prefill']} prefill / {roles['decode']} "
                  f"decode (disaggregated)")
    if args.autoscale:
        tiers += (f", autoscaling within [{fleet.min_replicas}, "
                  f"{fleet.max_replicas}]")
    if args.gateways == 1:
        doors = fleet.addr
    else:
        doors = f"{args.gateways} gateways ({', '.join(fleet.addrs)})"
    print(f"tfserve: gateway on {doors} fronting {tiers}; "
          f"ctrl-c to stop", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("tfserve: shutting down", file=sys.stderr)
    finally:
        fleet.stop()
        if token_file is not None:
            try:
                os.unlink(token_file)
            except OSError:
                pass
    return 0



SUBCOMMANDS = {"submit": submit_main, "trace": trace_main,
               "metrics": metrics_main, "gateways": gateways_main,
               "rollout": rollout_main, "swap-adapter": swap_adapter_main}


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m tfmesos_tpu_torch.cli run|serve|submit|metrics|trace|
    gateways|rollout|swap-adapter ...``: ``run`` is ``tfrun``, ``serve``
    is ``tfserve`` itself, the rest are its subcommands."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "run":
        return run_main(argv[1:])
    if argv and argv[0] == "serve":
        return serve_main(argv[1:])
    if argv and (argv[0] in SUBCOMMANDS
                 or argv[0] in NOT_PORTED_SUBCOMMANDS):
        return serve_main(argv)
    print("usage: python -m tfmesos_tpu_torch.cli "
          "{run,serve,submit,metrics,trace,gateways,rollout,swap-adapter} "
          "...", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
