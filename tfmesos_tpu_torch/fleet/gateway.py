"""The fleet's TCP front door (port of ``tfmesos_tpu/fleet/gateway.py``:
the ``Gateway`` with its HTTP/SSE ingress, and the registry sidecar and
process entry of multi-process gateways).

The I/O plane is a :class:`~tfmesos_tpu_torch.wire.WireServer` — ONE
selector-driven event loop carries every client connection (accept,
incremental Framer reads, buffered non-blocking writes), which is what
lifts the concurrent-connection ceiling from "one OS thread per client"
to "one fd per client" (docs/SERVING.md "Front-door scaling").  Request
EXECUTION keeps the worker-pool handoff: the loop-thread handler only
applies admission control (a shed costs one queue check, not a
dispatcher slot) and admitted requests wait in the bounded ingress
queue for one of ``workers`` dispatcher threads, which route them to a
replica and relay the completion back through the connection's
thread-safe buffered ``send``.

A fleet may run N gateways over ONE shared registry/router view
(``tfserve --gateways N``): each is stateless — any gateway can serve
any client — and registers its address for the ``gateways`` discovery
op, which clients use to find failover targets
(:class:`~tfmesos_tpu_torch.fleet.client.FleetClient` replays idempotent
in-flight requests on a survivor when its gateway dies mid-stream).

Wire surface (all frames HMAC-authenticated with the cluster token):

* ``{"op": "generate", "id", "prompt", "max_new_tokens", "stop_token",
  "priority", "deadline_ms", "stream"}`` → ``{"op": "completion", "id",
  "tokens", "ttft_ms", "total_ms"}`` or ``{"op": "error", "id", "kind",
  "error"}`` with ``kind`` one of ``overloaded`` / ``rate_limited``
  (admission shed — back off), ``unavailable`` (no replica within the
  retry budget), ``bad_request``, ``deadline_exceeded`` (the request's
  end-to-end budget ran out — shed in the admission queue, failed fast
  by the router, or cancelled inside a replica's batcher; never
  retried).  ``deadline_ms`` (optional) is the request's END-TO-END
  budget in milliseconds from gateway receipt: the gateway stamps an
  absolute deadline, the WFQ queues shed expired work before dispatch,
  the router slices the remainder across its phases, and the replica's
  batcher cancels an expired resident row and frees its pages — no
  deadline preserves the flat ``request_timeout`` behavior exactly
  (docs/SERVING.md "Deadlines & failure containment").
  ``priority`` (optional; ``tenant`` is an alias) is
  the CLASS LABEL: it selects the weighted-fair admission queue the
  request waits in, and the class's preemption rank rides to the
  replica so a higher class can suspend lower-class resident rows under
  allocation pressure (docs/SERVING.md "Priorities, preemption &
  migration").  Unlabeled requests take the first-listed (default)
  class.
  ``stream`` (optional) asks for PER-TOKEN incremental replies: the
  completion's tokens are flushed as the replica's batcher emits them,
  as interleaved ``{"op": "tokens", "id", "off", "tokens"}`` frames
  (``off`` = tokens already streamed — the de-dup key across retries
  and failovers), followed by the usual final completion carrying the
  FULL list.  Old clients that never set it see exactly the old
  one-reply protocol.
  ``trace`` (optional) asks for FULL span detail on this request's
  trace: ``true`` under a gateway-minted id, a string to supply the
  trace id; every request gets an always-on summary trace regardless,
  and every reply (completion or error) carries its ``trace_id`` —
  fetch the waterfall later with the ``trace`` op (docs/SERVING.md
  "Observability").
* ``{"op": "metrics", "id"}`` → ``{"op": "metrics", "id", "snapshot"}``.
* ``{"op": "gateways", "id"}`` → ``{"op": "gateways", "id",
  "gateways": [addr, ...]}`` — the registered front doors of this
  fleet (client-side discovery for multi-gateway failover;
  ``tfserve gateways``).
* ``{"op": "trace", "id", "trace_id"? | "slowest": N? | "failed":
  true?, "limit"?}`` → ``{"op": "trace", "id", "traces": [...]}`` —
  one trace by id (full record), the N slowest, the newest failures,
  or the recent summaries (``tfserve trace``).
* ``{"op": "ping", "id"}`` → ``{"op": "pong", "id"}``.
* ``{"op": "rollout", "id", "weights_version"}`` → ``{"op":
  "rollout", "id", "ok": true, "weights_version", ...}`` (the fleet's
  blue-green rollout summary) or ``{"op": "error", "kind":
  "rollout_failed"}``; it runs on its own thread, never the event
  loop's.
* ``{"op": "swap_adapter", "id", "model_id", "adapter_version",
  "delta"}`` → ``{"op": "swap_adapter", "id", "ok": true, ...}`` or
  ``{"op": "error", "kind": "bad_request" | "swap_failed"}``: the
  adapter hot-swap onto every alive replica of one catalog model (the
  delta in base64, :func:`~tfmesos_tpu_torch.fleet.catalog.
  encode_adapter_fields`), also off the event loop.

Clients multiplex: many requests may be in flight per connection, and
completions return in FINISH order, matched by ``id`` — the same
streaming shape the replicas themselves speak.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from tfmesos_tpu_torch import wire
from tfmesos_tpu_torch.fleet.admission import (AdmissionController,
                                               DeadlineExceeded, Overloaded,
                                               RateLimited)
from tfmesos_tpu_torch.fleet.catalog import decode_adapter_fields
from tfmesos_tpu_torch.fleet.metrics import FleetMetrics
from tfmesos_tpu_torch.fleet.registry import MODEL_ID_RE, validate_model_id
from tfmesos_tpu_torch.fleet.router import Router
from tfmesos_tpu_torch.fleet.tracing import TraceBook
from tfmesos_tpu_torch.utils.logging import get_logger

__all__ = ["Gateway", "RegistrySidecar", "build_parser", "main"]


class Gateway:
    """Accepts streaming requests, admits, routes, relays completions."""

    def __init__(self, router: Router, admission: AdmissionController,
                 metrics: FleetMetrics, token: str = "",
                 host: str = "127.0.0.1", port: int = 0, workers: int = 8,
                 registry=None, tracebook: Optional[TraceBook] = None,
                 clock=time.monotonic, close_router: bool = True,
                 reuseport: bool = False,
                 http_port: Optional[int] = None,
                 http_host: Optional[str] = None):
        self.router = router
        self.admission = admission
        self.metrics = metrics
        # Request tracing is on-by-default at SUMMARY level (every
        # request finishes into the book); span DETAIL is tail-retained
        # per the book's sample/slow/failure rules (docs/SERVING.md
        # "Observability").
        self.tracebook = tracebook if tracebook is not None else TraceBook()
        self.token = token
        self.host = host
        self.port = int(port)
        self.workers = int(workers)
        # The deadline time base, injectable and shared with the router
        # and admission clocks by the caller: the absolute deadline
        # stamped here is compared against the same clock at every later
        # checkpoint.
        self._clock = clock
        self.registry = registry if registry is not None else router.registry
        # SO_REUSEPORT (gateway processes sharing one public port); the
        # HTTP/SSE ingress rides the same event loop when http_port is
        # set (0: OS-assigned, see http_addr after start()).
        self.reuseport = bool(reuseport)
        self.http_port = http_port if http_port is None else int(http_port)
        self.http_host = http_host if http_host is not None else host
        self.http_addr: Optional[str] = None
        # N gateways share ONE router; only the last one standing may
        # close it.  False = the fleet launcher owns the router's
        # lifecycle (multi-gateway); True (default) keeps the
        # single-gateway teardown of old.
        self._close_router = bool(close_router)
        self.log = get_logger("tfmesos_tpu_torch.fleet.gateway")
        self.addr: Optional[str] = None
        # The fleet control plane's rollout entry point (set by
        # FleetServer after bring-up): callable(version) -> info dict,
        # raising on abort.  None = this gateway has no rollout surface.
        self.rollout_fn = None
        # Model catalog, both set by FleetServer on catalog fleets: the
        # catalog resolves/validates the request's ``model`` label
        # (absent -> the default entry; unknown -> bad_request), and
        # swap_adapter_fn is the adapter hot-swap control plane
        # (callable(model_id, version, meta, body) -> info dict).  None
        # = model-less fleet: a ``model`` label is charset-checked and
        # forwarded as-is.
        self.catalog = None
        self.swap_adapter_fn = None
        self._server: Optional[wire.WireServer] = None
        self._stop = threading.Event()
        self._threads = []
        self.killed = False
        metrics.register_gauge("queue_depth", admission.depth)
        # Per-class depths: under a background flood the operator must
        # be able to see WHICH class is backed up (one global depth
        # reads as "overloaded" even while interactive sails through).
        metrics.register_gauge("queue_depths", admission.class_depths)
        metrics.register_gauge("replicas_alive",
                               lambda: len(self.registry.alive()))
        # Replicas registered but still compiling (--warmup): present
        # in the table, invisible to every router tier — surfaced so an
        # operator can tell "warming fleet" from "missing replicas".
        metrics.register_gauge("replicas_warming",
                               lambda: len(self.registry.warming()))
        # Per-role replica counts + aggregate outstanding/headroom, so
        # a disaggregated deployment's snapshot shows each tier served.
        metrics.register_gauge("roles", self.registry.role_summary)
        # Failure containment (docs/SERVING.md "Deadlines & failure
        # containment"): breaker state and the retry-budget level are
        # the on-call's first two questions during a brown-out, so they
        # ride the snapshot AND the periodic report line.
        metrics.register_gauge("breakers", router.breaker_summary)
        metrics.register_gauge("retry_budget", router.retry_budget_level)
        # Trace book occupancy + lifetime finish/detail counts — the
        # "is tracing actually retaining anything" sanity gauge.
        metrics.register_gauge("traces", self.tracebook.describe)
        # Fleet-wide KV-tier aggregate (summed per-replica heartbeat
        # counters: hits/misses/spills/promotions/park/resume + tier
        # occupancy) — the memory-hierarchy gauge, flattened into the
        # Prometheus exposition like every dict gauge.
        if hasattr(self.registry, "kv_tier_summary"):
            metrics.register_gauge("kv_tier",
                                   self.registry.kv_tier_summary)
        # Speculative decoding fleet-wide: replicas serving with a
        # draft and their aggregate acceptance rate — the biggest
        # single-stream latency lever's health number, visible through
        # `tfserve metrics` and Prometheus like every dict gauge.
        if hasattr(self.registry, "spec_summary"):
            metrics.register_gauge("spec", self.registry.spec_summary)
        # Per-model replica counts + adapter-version distribution (the
        # model catalog's membership gauge).
        if hasattr(self.registry, "model_summary"):
            metrics.register_gauge("models",
                                   self.registry.model_summary)
        # Gang replicas fleet-wide: gang count, member slots, joined
        # members, and degraded gangs (fewer joined than the mesh
        # needs) — flat numerics, so the Prometheus exposition carries
        # every field.
        if hasattr(self.registry, "gang_summary"):
            metrics.register_gauge("gangs", self.registry.gang_summary)
        # Items that expired while queued still owe the client an
        # explicit answer — the controller hands them back here from
        # whichever worker's get() swept them.
        admission.on_expired = self._queue_expired

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Gateway":
        self._server = wire.WireServer(
            self._handle, token=self.token, host=self.host,
            port=self.port, name="gateway", reuseport=self.reuseport,
            advertise_host=(None if self.host in ("0.0.0.0", "::")
                            else self.host))
        if self.http_port is not None:
            from tfmesos_tpu_torch.fleet.http import HttpIngress

            self._server.add_ingress(HttpIngress(self),
                                     host=self.http_host,
                                     port=self.http_port)
        self._server.start()
        self.addr = self._server.addr
        if self._server.ingress_addrs:
            self.http_addr = self._server.ingress_addrs[0]
            self.log.info("HTTP/SSE ingress on %s", self.http_addr)
        self.log.info("fleet gateway listening on %s (%d workers, queue "
                      "bound %d, event-loop I/O)", self.addr,
                      self.workers, self.admission.max_queue)
        self._threads = []
        for i in range(self.workers):
            w = threading.Thread(target=self._worker, name=f"gateway-w{i}",
                                 daemon=True)
            w.start()
            self._threads.append(w)
        # Register this front door for client-side discovery (the
        # `gateways` op): stateless gateways over one registry view are
        # interchangeable, so any of them can hand out the full set.
        if hasattr(self.registry, "register_gateway"):
            self.registry.register_gateway(self.addr)
        return self

    def stop(self) -> None:
        """Graceful stop: deregister from discovery, close the event
        loop (clients see EOF), join the workers."""
        if hasattr(self.registry, "unregister_gateway") \
                and self.addr is not None:
            self.registry.unregister_gateway(self.addr)
        self._shutdown()
        if self._close_router:
            self.router.close()

    def kill(self) -> None:
        """Abrupt death (the bench's gateway 'SIGKILL'): connections
        slam shut mid-stream, nothing deregisters — exactly what peers
        of a SIGKILLed process observe.  The shared router/registry are
        untouched (they belong to the surviving gateways)."""
        self.killed = True
        self._shutdown()

    def _shutdown(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.stop()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []

    # -- ingress (runs on the event-loop thread: admit, never block) -------

    def _handle(self, client: "wire.WireConn", msg: Any) -> None:
        # Raw frames never reach here: the gateway's WireServer rejects
        # the raw bit at the length prefix (allow_raw defaults False),
        # which both keeps the public port's pre-auth buffering bound
        # at MAX_FRAME and fails a misdirected call_raw fast
        # (connection drop, never a timeout hang).
        if not isinstance(msg, dict):
            return
        op = msg.get("op")
        cid = msg.get("id")
        if op == "ping":
            client.send({"op": "pong", "id": cid})
            return
        if op == "metrics":
            out = {"op": "metrics", "id": cid,
                   "snapshot": self.metrics.snapshot()}
            if msg.get("raw"):
                # Mergeable state for the multi-process scrape fan-in:
                # histogram bucket vectors (not summaries), so a
                # fleet-level scraper can Histogram.merge() across N
                # gateway processes without losing percentiles.
                out["raw"] = self.metrics.raw_state()
            client.send(out)
            return
        if op == "gateways":
            reg = self.registry
            if hasattr(reg, "gateway_addrs"):
                addrs = reg.gateway_addrs()
            else:
                addrs = [self.addr] if self.addr else []
            client.send({"op": "gateways", "id": cid,
                         "gateways": addrs})
            return
        if op == "trace":
            # Authenticated read of the trace book: one trace by id,
            # the N slowest, the N newest failures, or the recent
            # summaries — the `tfserve trace` surface.
            book = self.tracebook
            limit = msg.get("limit")
            limit = int(limit) if isinstance(limit, (int, float)) \
                and not isinstance(limit, bool) and limit > 0 else 20
            tid = msg.get("trace_id")
            if isinstance(tid, str) and tid:
                rec = book.get(tid)
                traces = [rec] if rec is not None else []
            elif msg.get("failed"):
                traces = book.failed(limit)
            elif msg.get("slowest"):
                n = msg.get("slowest")
                traces = book.slowest(int(n) if isinstance(n, (int, float))
                                      and not isinstance(n, bool)
                                      and n > 0 else 5)
            else:
                traces = book.recent(limit)
            client.send({"op": "trace", "id": cid, "traces": traces})
            return
        if op == "rollout":
            fn = self.rollout_fn
            version = msg.get("weights_version")
            if fn is None:
                client.send({"op": "error", "id": cid,
                             "kind": "bad_request",
                             "error": "no rollout control plane attached "
                                      "to this gateway"})
                return
            if not isinstance(version, str) or not version:
                client.send({"op": "error", "id": cid,
                             "kind": "bad_request",
                             "error": "rollout needs a non-empty "
                                      "weights_version"})
                return

            def run_rollout() -> None:
                # Off the event-loop thread: a rollout takes as long as
                # a fleet's worth of warmups and drains, and blocking
                # here would stall EVERY connection, not just one.
                try:
                    info = fn(version)
                except Exception as e:
                    client.send({"op": "error", "id": cid,
                                 "kind": "rollout_failed",
                                 "error": str(e)})
                    return
                out = {"op": "rollout", "id": cid, "ok": True,
                       "weights_version": version}
                if isinstance(info, dict):
                    out.update(info)
                client.send(out)

            threading.Thread(target=run_rollout, name="gateway-rollout",
                             daemon=True).start()
            return
        if op == "swap_adapter":
            # Adapter hot-swap control op.  The public port rejects raw
            # frames at the length prefix, so the delta arrives base64
            # in JSON and the control plane re-ships it to the replicas
            # as raw HMAC frames.  Validation here is an INGRESS
            # boundary: model_id/adapter_version are charset-checked
            # before they touch anything.
            fn = self.swap_adapter_fn
            if fn is None:
                client.send({"op": "error", "id": cid,
                             "kind": "bad_request",
                             "error": "no model catalog attached to "
                                      "this gateway"})
                return
            try:
                model_id = validate_model_id(msg.get("model_id"))
                version = validate_model_id(msg.get("adapter_version"))
                meta, body = decode_adapter_fields(msg.get("delta"))
            except (TypeError, ValueError) as e:
                client.send({"op": "error", "id": cid,
                             "kind": "bad_request", "error": str(e)})
                return

            def run_swap() -> None:
                # Off the event-loop thread: the swap waits for every
                # replica's in-flight generations to finish on the old
                # delta, and blocking here would stall EVERY
                # connection.
                try:
                    info = fn(model_id, version, meta, body)
                except KeyError as e:
                    client.send({"op": "error", "id": cid,
                                 "kind": "bad_request",
                                 "error": str(e)})
                    return
                except Exception as e:
                    client.send({"op": "error", "id": cid,
                                 "kind": "swap_failed",
                                 "error": str(e)})
                    return
                out = {"op": "swap_adapter", "id": cid, "ok": True}
                if isinstance(info, dict):
                    out.update(info)
                client.send(out)

            threading.Thread(target=run_swap, name="gateway-swap",
                             daemon=True).start()
            return
        if op != "generate":
            client.send({"op": "error", "id": cid, "kind": "bad_request",
                         "error": f"unknown op {op!r}"})
            return
        self.metrics.inc("received")
        # Tracing begins at receipt: a client-supplied string is the
        # trace id (and asks for full detail), any other truthy value
        # asks for detail under a gateway-minted id, absence still gets
        # the always-on summary + tail-based retention.
        traw = msg.get("trace")
        tr = self.tracebook.begin(
            trace_id=traw if isinstance(traw, str) and traw else None,
            want_detail=bool(traw))
        # The class label ("priority"; "tenant" is an alias) picks the
        # weighted-fair admission queue; the class's preemption RANK —
        # not the label — rides to the replica, so batcher-side
        # preemption and gateway-side fair-share stay one coherent
        # policy defined in one place (the class table).
        label = msg.get("priority")
        if not isinstance(label, str):
            label = msg.get("tenant")
        spec = self.admission.resolve(
            label if isinstance(label, str) else None)
        # The model tier: the label is charset-validated at THIS
        # ingress (it reaches metric names and the routing filter),
        # resolved against the catalog when one is attached — absent
        # rides the default entry, unknown is an explicit bad_request
        # (there are no weights to serve it, and billing it to the
        # default would be silently wrong).  Model-less fleets forward
        # a validated label as-is and route by exact replica match.
        mraw = msg.get("model")
        model = None
        if mraw is not None:
            if not (isinstance(mraw, str)
                    and MODEL_ID_RE.fullmatch(mraw)):
                self.metrics.inc("failed")
                self.tracebook.finish(tr, "bad_request", cls=spec.name)
                client.send({"op": "error", "id": cid,
                             "kind": "bad_request",
                             "error": f"invalid model label {mraw!r}",
                             "trace_id": tr.trace_id})
                return
            model = mraw
        if self.catalog is not None:
            try:
                model = self.catalog.resolve(model)
            except KeyError as e:
                self.metrics.inc("failed")
                self.tracebook.finish(tr, "bad_request", cls=spec.name)
                client.send({"op": "error", "id": cid,
                             "kind": "bad_request", "error": str(e),
                             "trace_id": tr.trace_id})
                return
        prompt = msg.get("prompt")
        tr.event("gateway", "recv", cls=spec.name, rank=spec.rank,
                 model=model or "",
                 prompt_len=(len(prompt)
                             if isinstance(prompt, (list, tuple)) else 0))
        # End-to-end deadline: the client ships a RELATIVE budget
        # (clocks do not agree across hosts); the gateway stamps the
        # absolute expiry the whole serving path measures against.
        # A malformed or non-positive value costs the field, never the
        # request — no deadline is today's flat-timeout behavior.
        dl = msg.get("deadline_ms")
        deadline = None
        if isinstance(dl, (int, float)) and not isinstance(dl, bool) \
                and dl > 0:
            deadline = self._clock() + float(dl) / 1000.0
        forward = {"op": "generate", "prompt": msg.get("prompt"),
                   "max_new_tokens": msg.get("max_new_tokens"),
                   "stop_token": msg.get("stop_token"),
                   "priority": spec.rank,
                   # Internal (stripped before the wire, like
                   # "deadline"): the router records its attempts here
                   # and stitches replica hop spans back in.
                   "_trace": tr}
        if getattr(spec, "batch", False):
            # Internal routing hint: batch-lane work seeks IDLE
            # capacity, so the router prefers replicas with free
            # slots over the plain p2c draw (docs/SERVING.md
            # "Offline lane").
            forward["_background"] = True
        if msg.get("stream"):
            # Per-token streaming: the flag rides to the replica (whose
            # batcher flushes token frames per block) and the worker
            # installs the de-duplicating relay at dispatch.
            forward["stream"] = True
        sid = msg.get("session")
        if isinstance(sid, str) and sid:
            # Multi-turn session label (docs/SERVING.md "KV tiering &
            # sessions"): the router steers it at the replica holding
            # the parked KV, and the replica's batcher parks/resumes
            # under it.  Malformed values cost the field.
            forward["session"] = sid
        if model is not None:
            # Internal like "deadline"/"_trace": the router's model
            # tier filters on it (and re-stamps it onto the wire as
            # ``model`` for the replica's own cross-check).
            forward["_model"] = model
        if deadline is not None:
            forward["deadline"] = deadline
        try:
            self.admission.admit((client, cid, forward,
                                  time.perf_counter(), spec.name, tr),
                                 cls=spec.name, deadline=deadline,
                                 model=model)
        except DeadlineExceeded as e:
            self.metrics.inc("shed_deadline")
            self.metrics.inc(f"shed_deadline_{spec.name}")
            tr.event("admission", "shed", kind=e.kind, cls=spec.name)
            self.tracebook.finish(tr, e.kind, cls=spec.name)
            client.send({"op": "error", "id": cid, "kind": e.kind,
                         "error": str(e), "trace_id": tr.trace_id})
        except RateLimited as e:
            self.metrics.inc("shed_rate_limited")
            self.metrics.inc(f"shed_rate_limited_{spec.name}")
            tr.event("admission", "shed", kind=e.kind, cls=spec.name)
            self.tracebook.finish(tr, e.kind, cls=spec.name)
            client.send({"op": "error", "id": cid, "kind": e.kind,
                         "error": str(e), "trace_id": tr.trace_id})
        except Overloaded as e:
            self.metrics.inc("shed_queue")
            self.metrics.inc(f"shed_queue_{spec.name}")
            tr.event("admission", "shed", kind=e.kind, cls=spec.name)
            self.tracebook.finish(tr, e.kind, cls=spec.name)
            client.send({"op": "error", "id": cid, "kind": e.kind,
                         "error": str(e), "trace_id": tr.trace_id})
        else:
            self.metrics.inc("admitted")
            tr.event("admission", "enqueue", cls=spec.name)

    def handle_ingress(self, client, msg: Dict[str, Any]) -> None:
        """Submit one request for an ingress adapter (the HTTP/SSE edge):
        ``client`` is any object with a thread-safe ``send(dict)`` and a
        ``closed`` property.  It takes the wire connection's path through
        admission, tracing and routing, so the adapter gets WFQ,
        deadlines, metering and the exactly-once stream relay."""
        self.metrics.inc("http_requests")
        self._handle(client, msg)

    def _queue_expired(self, item) -> None:
        """One admitted request expired while waiting in its class
        queue (AdmissionController.get shed it before dispatch): the
        client still gets its explicit answer, and the books stay
        consistent — it was admitted, so it counts as failed too."""
        client, cid, _forward, t_enq, cls, tr = item
        self.metrics.inc("shed_deadline")
        self.metrics.inc(f"shed_deadline_{cls}")
        self.metrics.inc("failed")
        tr.add("admission", "queue_wait", tr.rel_ms(t_enq),
               (time.perf_counter() - t_enq) * 1000.0, cls=cls,
               expired=True)
        self.tracebook.finish(tr, "deadline_exceeded", cls=cls,
                              where="queued")
        client.send({"op": "error", "id": cid,
                     "kind": "deadline_exceeded",
                     "error": "request deadline expired while queued "
                              "at the gateway",
                     "trace_id": tr.trace_id})

    # -- dispatch ----------------------------------------------------------

    def _stream_relay(self, client: "wire.WireConn", cid):
        """The per-request partial-frame relay: forwards each replica
        ``tokens`` frame to the client re-keyed to ITS request id,
        de-duplicated by stream offset — a retried/resumed attempt
        re-streams from 0 (deterministic completions), and only tokens
        past the high-water mark go out, each exactly once."""
        sent = [0]

        def emit(frame) -> None:
            if isinstance(frame, wire.RawFrame):
                return              # never a token frame
            toks = frame.get("tokens")
            if not isinstance(toks, list) or not toks:
                return
            off = frame.get("off")
            off = int(off) if isinstance(off, (int, float)) \
                and not isinstance(off, bool) else 0
            prev = sent[0]
            new = toks[max(0, prev - off):]
            if not new or off + len(toks) <= prev:
                return
            sent[0] = off + len(toks)
            self.metrics.inc("stream_chunks")
            client.send({"op": "tokens", "id": cid,
                         "off": prev, "tokens": new})

        # Disconnect probe (docs/SERVING.md "HTTP/SSE edge"): the
        # router polls this per relayed frame and, once the client is
        # gone, cancels the replica-side row with a one-way ``cancel``
        # op — a walked-away SSE client (or a dropped wire conn) frees
        # its pages within a decode tick instead of decoding to the
        # bitter end.
        emit.cancelled = lambda: bool(getattr(client, "closed", False))
        return emit

    def _worker(self) -> None:
        while not self._stop.is_set():
            item = self.admission.get(timeout=0.2)
            if item is None:
                continue
            client, cid, forward, t_enq, cls, tr = item
            # Queue wait is ITS OWN histogram, never folded into TTFT:
            # TTFT measures the serving path (prefill + transfer), and
            # conflating admission backlog with it would mask exactly
            # the stalls disaggregation removes.  The per-class variant
            # is what the priority bench (and an SLO dashboard) reads —
            # the global one stays the autoscaler's signal.
            wait_ms = (time.perf_counter() - t_enq) * 1000.0
            self.metrics.observe("queue_wait_ms", wait_ms)
            self.metrics.observe(f"queue_wait_ms_{cls}", wait_ms)
            model = forward.get("_model")
            if model:
                # The per-MODEL queue-wait histogram is the model
                # trader's relative-pressure signal (windowed p99 per
                # model is what decides who trades replicas to whom).
                self.metrics.observe(f"queue_wait_ms_model_{model}",
                                     wait_ms)
            # The WFQ dequeue closes the queue-wait span — the first
            # hop of every waterfall.
            tr.add("admission", "queue_wait", tr.rel_ms(t_enq), wait_ms,
                   cls=cls)
            if forward.get("stream"):
                forward["_emit"] = self._stream_relay(client, cid)
            try:
                reply = self.router.route(forward)
            except Exception as e:
                # Any routing failure (RoutingError or unexpected)
                # becomes an explicit client error; a gateway worker
                # must survive everything.
                self.metrics.inc("failed")
                self.tracebook.finish(tr, "unavailable", cls=cls,
                                      error=str(e)[:200])
                client.send({"op": "error", "id": cid,
                             "kind": "unavailable", "error": str(e),
                             "trace_id": tr.trace_id})
                continue
            out = dict(reply) if isinstance(reply, dict) else {
                "op": "error", "kind": "internal",
                "error": f"malformed replica reply {reply!r}"}
            out["id"] = cid
            out["trace_id"] = tr.trace_id
            # Belt-and-braces: the router absorbs piggybacked replica
            # spans into the trace and pops them, but a reply that
            # bypassed absorption must not leak span payloads to the
            # client.
            out.pop("trace", None)
            if out.get("op") == "completion":
                self.metrics.inc("completed")
                n_out = len(out.get("tokens") or ())
                self.metrics.inc("tokens_out", n_out)
                # Billing-grade metering: prompt and decode tokens per
                # tenant-class x model (docs/SERVING.md "Model
                # catalog").  Plain counters, so they ride the
                # snapshot AND the Prometheus exposition (names
                # sanitized there); counted only on DELIVERED
                # completions — failed work is not billable.
                suffix = f"{cls}_{model}" if model else cls
                self.metrics.inc(f"metering_prompt_tokens_{suffix}",
                                 len(forward.get("prompt") or ()))
                self.metrics.inc(f"metering_decode_tokens_{suffix}",
                                 n_out)
                if "decode_ms" in out:      # disaggregated completions
                    # Their TTFT is router-measured (route start to
                    # prefill reply) — a different clock base than the
                    # replica-measured TTFT of unified completions, so
                    # it gets its own histogram instead of skewing
                    # ttft_ms percentiles in a mixed fleet.
                    self.metrics.observe("disagg_ttft_ms",
                                         out.get("ttft_ms"))
                    self.metrics.observe("decode_ms",
                                         out.get("decode_ms"))
                else:
                    self.metrics.observe("ttft_ms", out.get("ttft_ms"))
                self.metrics.observe("latency_ms", out.get("total_ms"))
                self.tracebook.finish(
                    tr, "completed", cls=cls,
                    tokens=len(out.get("tokens") or ()),
                    ttft_ms=out.get("ttft_ms"))
            else:
                self.metrics.inc("failed")
                if out.get("kind") == "deadline_exceeded":
                    # Router fail-fast or an in-batcher cancel: either
                    # way the deadline did its job — visible as its own
                    # counter, not buried in generic failures.
                    self.metrics.inc("deadline_exceeded")
                self.tracebook.finish(
                    tr, str(out.get("kind") or "error"), cls=cls)
            client.send(out)


# -- multi-process gateways --------------------------------------------------


class RegistrySidecar:
    """A gateway PROCESS's registry client (docs/SERVING.md
    "Multi-process gateways"): polls the central registry's
    ``registry_view`` op over one persistent wire connection and
    replays the table into a process-LOCAL
    :class:`~tfmesos_tpu_torch.fleet.registry.ReplicaRegistry` — constructed
    but never ``start()``ed (no listener socket, no sweeper thread) —
    which this process's router and admission WFQ read exactly as the
    in-process launcher path would.  No shared-memory hacks: the
    sidecar rides the same heartbeat/wire surface replicas use, so N
    gateway processes scale like N more wire peers.

    Per poll it also re-LEASES this gateway's own address into central
    discovery (``register_gateway`` with a TTL), so a SIGKILLed
    process expires out of the ``gateways`` op on its own, and syncs
    the central discovery set back into the local registry so any
    gateway process answers discovery with the full fleet set.

    State translation per replayed entry: ALIVE/WARMING arrive as
    plain heartbeats (``status: warming`` preserved), DRAINING as a
    heartbeat plus a ``drain`` op, DEAD as :meth:`mark_dead`.  The
    local sweeper (called inline per poll) ages out whatever the
    central view stops listing — and if the central registry itself
    becomes unreachable, the local table goes stale and drains on its
    own clocks: fail-safe, never fail-frozen."""

    def __init__(self, registry_addr: str, token: str = "",
                 poll_interval: float = 0.25, metrics=None,
                 clock=time.monotonic):
        from tfmesos_tpu_torch.fleet.registry import ReplicaRegistry

        self.registry_addr = registry_addr
        self.token = token
        self.poll_interval = float(poll_interval)
        self.lease_ttl = min(30.0, max(2.0, 8.0 * self.poll_interval))
        self._clock = clock
        # Liveness thresholds scale with the poll cadence the same way
        # the central registry's scale with the heartbeat interval: a
        # slow poll must not flap mirrored entries between refreshes.
        self.local = ReplicaRegistry(
            token=token, metrics=metrics, clock=clock,
            suspect_after=max(1.5, 6.0 * self.poll_interval),
            dead_after=max(3.0, 12.0 * self.poll_interval),
            evict_after=max(10.0, 24.0 * self.poll_interval))
        # The address this process leases into discovery; set by main()
        # once its Gateway has bound.  scrape_addr is the PRIVATE
        # per-process listener (metrics fan-in + lease identity under
        # a shared REUSEPORT public addr).
        self.gateway_addr: Optional[str] = None
        self.scrape_addr: Optional[str] = None
        self.polls = 0
        self.poll_failures = 0
        self.log = get_logger("tfmesos_tpu_torch.fleet.gateway")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if metrics is not None:
            metrics.register_gauge("sidecar_polls", lambda: self.polls)
            metrics.register_gauge("sidecar_poll_failures",
                                   lambda: self.poll_failures)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "RegistrySidecar":
        self._thread = threading.Thread(target=self._loop,
                                        name="gateway-sidecar",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def wait_for_replicas(self, n: int, timeout: float = 60.0) -> bool:
        """Block until the LOCAL view mirrors >= n alive replicas."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.local.alive()) >= n:
                return True
            if self._stop.wait(0.05):
                return False
        return len(self.local.alive()) >= n

    # -- the poll loop ------------------------------------------------------

    def _loop(self) -> None:
        sock = None
        it = None
        logged_down = False
        while not self._stop.is_set():
            try:
                if sock is None:
                    sock = wire.connect(self.registry_addr, timeout=5.0)
                    framer = wire.Framer(self.token)
                    it = wire.iter_msgs(sock, framer)
                if self.gateway_addr:
                    lease = {"op": "register_gateway",
                             "addr": self.gateway_addr,
                             "ttl": self.lease_ttl}
                    if self.scrape_addr:
                        lease["scrape"] = self.scrape_addr
                    wire.send_msg(sock, lease, self.token)
                    next(it)            # gateway_registered ack
                wire.send_msg(sock, {"op": "registry_view"}, self.token)
                self._apply(next(it))
                self.polls += 1
                logged_down = False
            except (OSError, wire.WireError, StopIteration) as e:
                self.poll_failures += 1
                if not logged_down:
                    logged_down = True
                    self.log.warning(
                        "registry poll to %s failed (%s); local view "
                        "will age out until it recovers",
                        self.registry_addr, e)
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                sock = it = None
            # Liveness over the MIRROR: entries the central view stops
            # listing (evicted there) stop being refreshed here and age
            # out through the standard sweep ladder.
            self.local.sweep()
            self._stop.wait(self.poll_interval)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _apply(self, view: Any) -> None:
        if not isinstance(view, dict) \
                or view.get("op") != "registry_view":
            return
        from tfmesos_tpu_torch.fleet import registry as registry_mod

        for d in view.get("replicas") or []:
            if not isinstance(d, dict) or not d.get("addr"):
                continue
            state = d.get("state")
            if state == registry_mod.DEAD:
                self.local.mark_dead(d["addr"],
                                     why="dead in central registry view")
                continue
            beat = {k: v for k, v in d.items() if k != "state"}
            self.local.observe(beat)
            if state == registry_mod.DRAINING:
                self.local.observe({"op": "drain", "addr": d["addr"]})
        gws = view.get("gateways")
        if isinstance(gws, list):
            self.local.set_gateways([a for a in gws
                                     if isinstance(a, str)])


def build_parser():
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m tfmesos_tpu_torch.fleet.gateway",
        description="One fleet gateway PROCESS: Gateway + admission "
                    "WFQ + router over a registry-view sidecar — the "
                    "multi-process front door (jax-free).")
    p.add_argument("--registry", type=str, required=True,
                   help="central registry host:port (the same address "
                        "replicas heartbeat)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="wire listen port (0 = OS-assigned); with "
                        "--reuseport every gateway process passes the "
                        "SAME port and the kernel load-balances "
                        "accepts across them")
    p.add_argument("--reuseport", action="store_true",
                   help="bind with SO_REUSEPORT (multi-process "
                        "gateways sharing one public port; fails "
                        "explicitly where unsupported)")
    p.add_argument("--http-port", type=int, default=None,
                   dest="http_port",
                   help="serve the HTTP/1.1+SSE ingress adapter on "
                        "this port (0 = OS-assigned; default: no HTTP "
                        "listener)")
    p.add_argument("--http-host", type=str, default=None,
                   dest="http_host")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--max-queue", type=int, default=None,
                   dest="max_queue")
    p.add_argument("--classes-json", type=str, default=None,
                   dest="classes_json",
                   help="the fleet's priority classes, a JSON list of "
                        "PriorityClass fields (name, weight, rank, "
                        "max_queue, model_quota, batch); default: one "
                        "default class")
    p.add_argument("--rate", type=float, default=None,
                   help="token-bucket admission rate (req/s)")
    p.add_argument("--burst", type=float, default=None)
    p.add_argument("--max-retries", type=int, default=2,
                   dest="max_retries")
    p.add_argument("--request-timeout", type=float, default=120.0,
                   dest="request_timeout")
    p.add_argument("--poll-interval", type=float, default=0.25,
                   dest="poll_interval",
                   help="registry-view sidecar poll cadence in seconds")
    p.add_argument("--metrics-port", type=int, default=None,
                   dest="metrics_port",
                   help="per-process Prometheus exposition port (falls "
                        "back to an OS-assigned port when taken; see "
                        "the metrics_http_port gauge)")
    return p


def main(argv=None) -> int:
    import signal

    args = build_parser().parse_args(argv)
    token = wire.load_token()
    metrics = FleetMetrics()
    sidecar = RegistrySidecar(args.registry, token=token,
                              poll_interval=args.poll_interval,
                              metrics=metrics)
    router = Router(sidecar.local, metrics, token=token,
                    max_retries=args.max_retries,
                    request_timeout=args.request_timeout)
    adm_kwargs: Dict[str, Any] = {}
    if args.max_queue is not None:
        adm_kwargs["max_queue"] = args.max_queue
    if args.classes_json:
        # Without the table every label resolves to the default class:
        # the offline lane's ``batch`` class would neither wait behind
        # interactive work here nor rank below it at the replicas.
        import json

        from tfmesos_tpu_torch.fleet.admission import PriorityClass

        adm_kwargs["classes"] = [PriorityClass(**d)
                                 for d in json.loads(args.classes_json)]
    admission = AdmissionController(rate=args.rate, burst=args.burst,
                                    **adm_kwargs)
    gw = Gateway(router, admission, metrics, token=token,
                 host=args.host, port=args.port, workers=args.workers,
                 registry=sidecar.local, reuseport=args.reuseport,
                 http_port=args.http_port,
                 http_host=args.http_host).start()

    # Private per-process listener: with SO_REUSEPORT a dial to the
    # shared public addr lands on a KERNEL-chosen process, so the
    # launcher's metrics fan-in (and the lease identity that keeps N
    # same-addr processes distinct in discovery) needs an address that
    # reaches THIS process deterministically.
    def on_scrape(conn, msg) -> None:
        op = msg.get("op") if isinstance(msg, dict) else None
        mid = msg.get("id") if isinstance(msg, dict) else None
        if op == "metrics":
            out: Dict[str, Any] = {"op": "metrics", "id": mid,
                                   "metrics": metrics.snapshot()}
            if msg.get("raw"):
                out["raw"] = metrics.raw_state()
            conn.send(out)
        elif op == "ping":
            conn.send({"op": "pong", "id": mid})
        elif op == "status":
            # Mirror-convergence probe: how much of the fleet THIS
            # process's sidecar view can already route to.  The
            # launcher polls this at bring-up so a client's first
            # request never lands on a gateway that mirrors nothing.
            conn.send({"op": "status", "id": mid,
                       "alive": len(sidecar.local.alive()),
                       "polls": sidecar.polls})
        else:
            conn.send({"op": "error", "id": mid,
                       "error": {"kind": "bad_request",
                                 "message": "scrape listener serves "
                                            "metrics/ping/status "
                                            "only"}})

    scrape_srv = wire.WireServer(on_scrape, token=token, host=args.host,
                                 port=0, name="gateway-scrape").start()
    sidecar.gateway_addr = gw.addr
    sidecar.scrape_addr = scrape_srv.addr
    sidecar.start()
    if args.metrics_port is not None:
        metrics.start_http_server(args.metrics_port)
    line = f"gateway serving on {gw.addr}"
    if gw.http_addr:
        line += f" (http {gw.http_addr})"
    print(line, flush=True)
    stop = threading.Event()

    def on_signal(signum, frame) -> None:
        stop.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    stop.wait()
    sidecar.stop()
    scrape_srv.stop()
    gw.stop()
    return 0


if __name__ == "__main__":       # pragma: no cover - process entry
    import sys

    sys.exit(main())
