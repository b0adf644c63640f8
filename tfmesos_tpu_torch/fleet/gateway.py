"""The fleet's TCP front door (port of ``tfmesos_tpu/fleet/gateway.py:1-720``,
the in-process ``Gateway``; the registry sidecar of gateway processes
and the HTTP edge are not ported yet).

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
from typing import Any, Optional

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

__all__ = ["Gateway"]


class Gateway:
    """Accepts streaming requests, admits, routes, relays completions."""

    def __init__(self, router: Router, admission: AdmissionController,
                 metrics: FleetMetrics, token: str = "",
                 host: str = "127.0.0.1", port: int = 0, workers: int = 8,
                 registry=None, tracebook: Optional[TraceBook] = None,
                 close_router: bool = True):
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
        self.registry = registry if registry is not None else router.registry
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
            port=self.port, name="gateway",
            advertise_host=(None if self.host in ("0.0.0.0", "::")
                            else self.host))
        self._server.start()
        self.addr = self._server.addr
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
            deadline = time.monotonic() + float(dl) / 1000.0
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
