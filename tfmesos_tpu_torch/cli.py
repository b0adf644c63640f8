"""``tfserve`` for the PyTorch port (port of ``tfmesos_tpu/cli.py``'s
serving entry: ``build_serve_parser``, ``serve_main`` and the ``submit``,
``metrics``, ``trace`` and ``gateways`` subcommands).

    python -m tfmesos_tpu_torch.cli serve [--replicas N] [--tiny] ...
    python -m tfmesos_tpu_torch.cli submit -g HOST:PORT --prompt 1,2,3
    python -m tfmesos_tpu_torch.cli metrics -g HOST:PORT

``serve`` brings up a registry and a gateway in process and launches
port replicas (``tfmesos_tpu_torch.fleet.replica``) as local Mode-B
tasks, on the card unless ``--device cpu``.  It runs until SIGINT
(ctrl-c), then stops the fleet and every replica process.  Every flag
of the JAX ``tfserve`` parses with its default; the ones whose
machinery is not ported yet, and the ``rollout``, ``swap-adapter``,
``batch`` and ``simulate`` subcommands, exit 2 with ``tfserve: not
ported yet: <flag> (ROADMAP A.x)``.  ``tfrun`` (the Mode-B job CLI) is
not ported yet either.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from tfmesos_tpu_torch import wire

__all__ = ["build_serve_parser", "parse_role_spec", "parse_class_spec",
           "serve_main", "submit_main", "trace_main", "metrics_main",
           "gateways_main", "main", "NOT_PORTED_FLAGS",
           "NOT_PORTED_SUBCOMMANDS"]

#: tfserve flags whose machinery waits: (flag, args dest, the default
#: that asks for nothing, ROADMAP item).
NOT_PORTED_FLAGS = (
    ("--autoscale", "autoscale", False, "A.12"),
    ("--min-replicas", "min_replicas", None, "A.12"),
    ("--max-replicas", "max_replicas", None, "A.12"),
    ("--models", "models", None, "A.12"),
    ("--warm-pool", "warm_pool", 0, "A.12"),
    ("--model-budget", "model_budget", None, "A.12"),
    ("--gang-size", "gang_size", 1, "A.9"),
    ("--gateway-processes", "gateway_processes", 0, "A.12"),
    ("--http-port", "http_port", None, "A.12"),
    ("--batch-lane", "batch_lane", False, "A.12"),
    ("--master", "master", None, "A.12"),
)

#: tfserve subcommands whose machinery waits -> ROADMAP item.
NOT_PORTED_SUBCOMMANDS = {"rollout": "A.12", "swap-adapter": "A.12",
                          "batch": "A.12", "simulate": "A.12"}


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


def _build_fleet(args, roles, classes, token):
    """Construct the FleetServer from parsed ``tfserve`` args; its
    constructor ValueErrors (bad flag combinations) surface to the
    caller for the clean exit-2 path."""
    from tfmesos_tpu_torch.fleet.launcher import FleetServer

    return FleetServer(
        replicas=args.replicas, rows=args.rows, tiny=args.tiny,
        prefill_replicas=roles.get("prefill", 0),
        decode_replicas=roles.get("decode", 0),
        device=args.device,
        weights_version=args.weights_version,
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
    except ValueError as e:
        print(f"tfserve: {e}", file=sys.stderr)
        return 2
    min_replicas = 0 if roles else 1
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
        fleet = _build_fleet(args, roles, classes, token)
    except ValueError as e:
        # Constructor validation (bad flag combinations) is an ARGUMENT
        # error: one clean line, exit 2, never a traceback.
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
    if roles:
        tiers += (f" + {roles['prefill']} prefill / {roles['decode']} "
                  f"decode (disaggregated)")
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
               "metrics": metrics_main, "gateways": gateways_main}


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m tfmesos_tpu_torch.cli serve|submit|metrics|trace|
    gateways ...``: ``serve`` is ``tfserve`` itself, the rest are its
    subcommands."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "serve":
        return serve_main(argv[1:])
    if argv and (argv[0] in SUBCOMMANDS
                 or argv[0] in NOT_PORTED_SUBCOMMANDS):
        return serve_main(argv)
    if argv and argv[0] == "run":
        print("tfrun: not ported yet: tfrun (ROADMAP A.12)",
              file=sys.stderr)
        return 2
    print("usage: python -m tfmesos_tpu_torch.cli "
          "{serve,submit,metrics,trace,gateways} ...", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
