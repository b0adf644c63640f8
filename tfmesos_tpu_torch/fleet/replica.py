"""A serving replica: one ``ContinuousBatcher`` behind a TCP server
(port of ``tfmesos_tpu/fleet/replica.py:53-960, 1037-1112, 1162-1217,
1220-1646``).

    python -m tfmesos_tpu_torch.fleet.replica [--registry HOST:PORT] \\
        [--tiny] [--device cpu] [--rows 4] [--warmup] [--role ROLE] ...

It builds the model, runs the batcher's incremental serve loop on a
thread of its own, accepts multiplexed ``generate`` requests over the
authenticated wire (``wire.py``, byte-compatible with the JAX
package's) and sends each completion back on the connection it came
from as soon as the batcher finishes it.  The port's ``FleetServer``
(:mod:`~tfmesos_tpu_torch.fleet.launcher`) launches it as a Mode-B task
and its registry, router and gateway front it.  It speaks the same
messages, replies and heartbeats as the JAX replica, so it also serves
behind the JAX registry, router and gateway, a JAX replica serves
behind the port's, and KV artifacts move between the two frameworks
(drain migration, disaggregated prefill/decode) in either direction.

The cluster token comes from ``TPUMESOS_TOKEN_FILE`` /
``TPUMESOS_TOKEN`` (:func:`~tfmesos_tpu_torch.wire.load_token`).  A
heartbeat thread streams ``{op: heartbeat, addr, capacity,
outstanding, ...}`` to the registry on one persistent connection; on
SIGTERM the replica announces a drain, stops accepting and exits.
With ``--warmup`` it registers as ``status: warming`` (never routed),
captures every serving shape (``ContinuousBatcher.warmup``: CUDA
graphs on the card), and only then drops the status.

Runs on the card unless ``--device cpu``; a missing card is an error.
Weights are the port preset's (``models/presets.py``) drawn from
``--seed``; :func:`build_batcher` takes other weights in process
(``params=``).  ``--kv-tier-mb`` / ``--kv-tier-dir`` give the batcher a
KV tier (``fleet/kvtier.py``: spilled prefix pages and parked
sessions); behind ``--registry`` the tier is wrapped in the KV fabric
(``--kv-replication`` copies of each park, fetch from peers on a miss)
and the replica serves ``kv_put`` / ``kv_fetch``.  ``--role kv`` is a
dedicated holder: a bare tier behind the wire, with no model, no batcher
and no torch import, so it never touches the card.  ``--draft`` serves
speculatively with the preset's draft model (``--n-draft`` proposals a
round; the acceptance rate rides every heartbeat as ``spec``).  The
``swap_adapter`` op folds a weight delta (a raw frame,
``fleet/catalog.py``'s codec) once no row is resident and answers when
it has applied; ``--warm-pool`` starts the replica undedicated, and the
``adopt`` op installs a catalog model's preset weights (``set_weights``)
and gives it that ``model_id``.  Not ported yet, refused with exit code
2: a gang launch env.  One op is the port's own: ``stats`` answers the
replica's pid, device, the device memory it holds, its kernels' launch
counts, the batcher's dispatch and speculative counters and its tier's
counters (a holder: that torch is not even imported, and its tier's
summary).

:class:`ReplicaServer` serves whatever ``handler(msg, reply)`` it is
given; only :func:`batcher_handler`, :func:`prefill_handler` and the
build import the model stack.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import queue as _queue
import re
import signal
import socket
import sys
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

from tfmesos_tpu_torch import wire
from tfmesos_tpu_torch.fleet import tracing
from tfmesos_tpu_torch.utils.logging import get_logger

__all__ = ["ReplicaServer", "BatcherServing", "batcher_handler",
           "prefill_handler", "fabric_handler", "rid_seed_for_node",
           "build_batcher", "build_parser", "start_replica",
           "start_kv_holder", "main", "ReplicaRefused"]

_LOG = "tfmesos_tpu_torch.fleet.replica"
#: The gang launch env (``tfmesos_tpu/fleet/gang.py``): a replica launched
#: as one task of a gang.
GANG_ENV_ID = "TPUMESOS_GANG_ID"
#: The registry's model-id charset (``tfmesos_tpu/fleet/registry.py``).
MODEL_ID_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,63}")
#: The batcher's dispatch counters the ``stats`` op reports.
STATS_COUNTERS = ("prefills", "tail_prefills", "prefill_chunks",
                  "decode_ticks", "fused_ticks", "spec_rounds",
                  "spec_row_rounds", "spec_committed", "weight_swaps")


class ReplicaRefused(ValueError):
    """A replica option this port refuses (not ported yet, or
    invalid): the entry point exits with code 2."""


def _hop_trace(head) -> Optional[tracing.TraceContext]:
    """The replica-side hop context of a request carrying a
    ``trace_id``; a malformed field costs the trace, never the
    request."""
    tid = head.get("trace_id")
    if not isinstance(tid, str) or not tid:
        return None
    slow = head.get("trace_slow_ms")
    return tracing.TraceContext(
        trace_id=tid, detailed=bool(head.get("trace_detail")),
        slow_ms=(float(slow) if isinstance(slow, (int, float))
                 and not isinstance(slow, bool) and slow > 0 else None))


def _attach_trace(out: Dict[str, Any], tr, failed: bool = False
                  ) -> Dict[str, Any]:
    """Piggyback the hop's spans on a reply dict by the tail rule:
    detail was asked for, the hop failed, or it ran slow."""
    if tr is not None and tr.should_export(failed=failed):
        out["trace"] = tr.export()
    return out


def _error(mid, kind: str, error: str) -> Dict[str, Any]:
    return {"op": "error", "id": mid, "kind": kind, "error": error}


def _worker_context(batcher) -> Callable[[], Any]:
    """A context factory for a worker thread of ``batcher``: on the card,
    the device and stream current in the calling thread (the one that
    warms the batcher up, so replays run where the captures ran:
    PyTorch's current stream is per thread)."""
    dev = getattr(batcher, "device", None)
    if dev is None or dev.type != "cuda":
        return contextlib.nullcontext
    import torch

    stream = torch.cuda.current_stream(dev)
    return lambda: torch.cuda.stream(stream)


class ReplicaServer:
    """Threaded request server and registry heartbeater.

    ``handler(msg, reply)`` serves one message; it may call
    ``reply(dict)`` at once or later from another thread (the batcher's
    completion loop).  ``reply`` is single-shot and keeps the server's
    outstanding count; ``reply.partial`` sends streaming partial frames.
    """

    def __init__(self, handler: Callable[[Dict[str, Any], Callable], None],
                 token: str = "", capacity: int = 0,
                 host: str = "127.0.0.1", port: int = 0,
                 registry_addr: Optional[str] = None,
                 heartbeat_interval: float = 0.3,
                 extra_info: Optional[Callable[[], Dict[str, Any]]] = None,
                 status: Optional[str] = None,
                 stats: Optional[Callable[[Dict[str, Any]],
                                          Dict[str, Any]]] = None):
        self.handler = handler
        self.token = token
        self.capacity = int(capacity)
        self.host = host
        self.port = int(port)
        self.registry_addr = registry_addr
        self.heartbeat_interval = float(heartbeat_interval)
        # Fields merged into every heartbeat (cheap, never raising): the
        # role, KV headroom and prefix-cache summary the router reads.
        self.extra_info = extra_info
        # Lifecycle status on the hello and every beat ("warming" while
        # the batcher captures its shapes; None = routable).
        self._status = status
        # The ``stats`` op's answer (None: the op is unknown, as on the
        # JAX replica).
        self.stats = stats
        self.log = get_logger(_LOG)
        self.addr: Optional[str] = None
        self._listen: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._conns: set = set()
        self._outstanding = 0
        self._olock = threading.Lock()

    @property
    def outstanding(self) -> int:
        with self._olock:
            return self._outstanding

    def set_status(self, status: Optional[str]) -> None:
        """Change the advertised status; the next beat carries it."""
        self._status = status

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ReplicaServer":
        self._listen = wire.bind_ephemeral(self.host, port=self.port)
        self.addr = wire.sock_addr(
            self._listen, advertise_host=(
                None if self.host in ("0.0.0.0", "::") else self.host))
        self.log.info("replica serving on %s (capacity %d)", self.addr,
                      self.capacity)
        t = threading.Thread(target=self._accept_loop,
                             name="replica-accept", daemon=True)
        t.start()
        self._threads = [t]
        if self.registry_addr:
            hb = threading.Thread(target=self._heartbeat_loop,
                                  name="replica-heartbeat", daemon=True)
            hb.start()
            self._threads.append(hb)
        return self

    def stop(self) -> None:
        self._stop.set()
        # close() alone does not interrupt a blocked accept().
        wire.wake_listener(self._listen)
        if self._listen is not None:
            try:
                self._listen.close()
            except OSError:
                pass
        with self._olock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:  # wake the readers; peers see EOF at once
            wire.shutdown_socket(conn)
            try:
                conn.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2.0)

    # -- request serving ---------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listen.accept()
            except OSError:
                return
            with self._olock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="replica-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        # Replica links carry multi-MB raw KV frames (imports, stages):
        # the one listener that opts in.
        framer = wire.Framer(self.token, allow_raw=True)
        send_lock = threading.Lock()
        try:
            conn.settimeout(None)
            for msg in wire.iter_msgs(conn, framer):
                self._handle(conn, send_lock, msg)
        except wire.WireError as e:
            self.log.warning("rejecting connection: %s", e)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._olock:
                self._conns.discard(conn)

    def _send(self, conn: socket.socket, lock: threading.Lock,
              msg) -> None:
        try:
            with lock:
                if isinstance(msg, wire.RawFrame):
                    wire.send_raw_msg(conn, msg.meta, msg.body, self.token)
                else:
                    wire.send_msg(conn, msg, self.token)
        except OSError:
            pass    # peer gone; its requests died with it

    def _handle(self, conn: socket.socket, send_lock: threading.Lock,
                msg: Any) -> None:
        # A raw frame carries its op/id in the meta; the handler gets
        # the whole frame so the body is never re-encoded.
        if isinstance(msg, wire.RawFrame):
            head = msg.meta if isinstance(msg.meta, dict) else {}
        elif isinstance(msg, dict):
            head = msg
        else:
            return
        op = head.get("op")
        mid = head.get("id")
        if op == "ping":
            self._send(conn, send_lock, {"op": "pong", "id": mid})
            return
        if op == "stats" and self.stats is not None:
            self._send(conn, send_lock,
                       {"op": "stats", "id": mid, **self.stats(head)})
            return
        if op not in ("generate", "prefill", "migrate", "adopt",
                      "swap_adapter", "kv_put", "kv_fetch", "kv_stage",
                      "cancel"):
            self._send(conn, send_lock,
                       _error(mid, "bad_request", f"unknown op {op!r}"))
            return
        with self._olock:
            self._outstanding += 1
        done = threading.Event()    # single-shot guard

        def reply(out) -> None:
            if done.is_set():
                return
            done.set()
            with self._olock:
                self._outstanding -= 1
            self._send(conn, send_lock, out)

        def partial(out) -> None:
            # Partial frames (op: tokens) share the connection's send
            # lock but never consume the single-shot guard.
            if done.is_set():
                return
            self._send(conn, send_lock, out)

        reply.partial = partial
        # A cancel names its target by call id, unique only per router
        # connection: the in-flight registry keys on (conn, id).
        reply.conn_key = id(conn)
        try:
            self.handler(msg, reply)
        except Exception as e:      # handler bug: fail THIS request only
            self.log.exception("handler failed: %s", e)
            reply(_error(mid, "internal", repr(e)))

    # -- heartbeats --------------------------------------------------------

    def _merge_extra(self, beat: Dict[str, Any]) -> None:
        status = self._status
        if status is not None:
            beat["status"] = status
        if self.extra_info is None:
            return
        try:
            beat.update(self.extra_info())
        except Exception:
            # A broken callback costs its fields, never the beat.
            self.log.exception("heartbeat extra_info failed; beat "
                               "sent bare")

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            sock = None
            try:
                sock = wire.connect(self.registry_addr, timeout=5.0)
                hello = {"op": "hello", "addr": self.addr,
                         "capacity": self.capacity}
                self._merge_extra(hello)    # the role lands before any
                wire.send_msg(sock, hello, self.token)  # routing decision
                while not self._stop.wait(self.heartbeat_interval):
                    beat = {"op": "heartbeat", "addr": self.addr,
                            "capacity": self.capacity,
                            "outstanding": self.outstanding}
                    self._merge_extra(beat)
                    wire.send_msg(sock, beat, self.token)
                # Graceful exit: the registry stops routing here before
                # the process dies.
                wire.send_msg(sock, {"op": "drain", "addr": self.addr},
                              self.token)
            except OSError as e:
                self.log.warning("registry %s unreachable: %s; retrying",
                                 self.registry_addr, e)
                self._stop.wait(self.heartbeat_interval)
            finally:
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass


class BatcherServing:
    """Bridge from the request/reply surface to the batcher's online
    submission API: :meth:`submit` registers a completion callback, a
    thread of its own drains ``batcher.serve()`` and fires callbacks in
    finish order.  Only :meth:`submit`, the batcher's ``preempt_all``
    and :meth:`close` cross threads; everything the loop touches on the
    device (graph replays, pinned staging buffers, events) stays on the
    loop's thread, on the stream current where :meth:`start` ran."""

    def __init__(self, batcher):
        self.batcher = batcher
        self._callbacks: Dict[int, Callable] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "BatcherServing":
        context = _worker_context(self.batcher)
        self._thread = threading.Thread(target=self._loop, args=(context,),
                                        name="batcher-serve", daemon=True)
        self._thread.start()
        return self

    def _loop(self, context) -> None:
        try:
            with context():
                for comp in self.batcher.serve():
                    with self._lock:
                        cb = self._callbacks.pop(id(comp.request), None)
                    if cb is not None:
                        cb(comp, None)
        except BaseException as e:  # loop died: fail every waiter loudly
            with self._lock:
                cbs = list(self._callbacks.values())
                self._callbacks.clear()
            for cb in cbs:
                cb(None, f"batcher serve loop died: {e!r}")
            raise

    def submit(self, request, on_done: Callable,
               prefilled: Optional[dict] = None) -> None:
        """``on_done(completion, error)``, exactly one of the two set; a
        completion may also be a ``Suspended`` (drain migration) or an
        ``Expired`` (deadline).  ``prefilled`` takes the KV-import
        admission (disaggregated decode, or a migrated resume)."""
        with self._lock:
            self._callbacks[id(request)] = on_done
        if prefilled is not None:
            self.batcher.submit(request, prefilled=prefilled)
        else:
            self.batcher.submit(request)

    def close(self) -> None:
        self.batcher.close()
        if self._thread is not None:
            self._thread.join(timeout=30.0)


def _deadline_ms(head) -> Optional[float]:
    """The remaining end-to-end budget the router forwarded (ms), or
    None: a malformed or non-positive value costs the field, never the
    request."""
    dl = head.get("deadline_ms")
    if isinstance(dl, (int, float)) and not isinstance(dl, bool) \
            and dl > 0:
        return float(dl)
    return None


def _push(addr: str, meta: Dict[str, Any], body, token: str,
          self_addr: Optional[Callable[[], str]]) -> Any:
    """One direct KV push (a ``kv_stage`` raw frame) to ``addr``."""
    from tfmesos_tpu_torch.fleet.kvtier import fabric_rpc

    return fabric_rpc(addr, meta, body, token=token, timeout=30.0,
                      self_addr=self_addr() if self_addr else "")


def _handle_swap_adapter(batcher, msg, reply: Callable) -> None:
    """Serve one ``swap_adapter`` raw frame: unpack the delta, queue the
    fold behind the batcher's weight-update fence, and reply once it has
    applied (in-flight requests finish on the old delta first, so the
    reply means every later stream runs the new one).  A prefill-role
    batcher has no serve loop: its fold applies, and replies, at once."""
    from tfmesos_tpu_torch.fleet import catalog
    from tfmesos_tpu_torch.fleet.registry import validate_model_id

    head = msg.meta if isinstance(msg, wire.RawFrame) else msg
    mid = head.get("id")
    if not isinstance(msg, wire.RawFrame):
        reply(_error(mid, "bad_request",
                     "swap_adapter ships its delta as a raw frame"))
        return
    try:
        version = validate_model_id(head.get("adapter_version"))
        delta = catalog.unpack_adapter(head, msg.body)
    except (TypeError, ValueError) as e:
        reply(_error(mid, "bad_request", str(e)))
        return

    def applied() -> None:
        reply({"op": "adapter_swapped", "id": mid,
               "adapter_version": version, "swaps": batcher.weight_swaps})

    try:
        batcher.swap_adapter(delta, version, on_applied=applied)
    except ValueError as e:
        reply(_error(mid, "bad_request", str(e)))


def batcher_handler(serving: BatcherServing, generation: int = 0,
                    weights_version: str = "",
                    model_state: Optional[Dict[str, Any]] = None,
                    adopt_fn: Optional[Callable] = None,
                    token: str = "",
                    self_addr: Optional[Callable[[], str]] = None
                    ) -> Callable:
    """The model-backed handler of the unified and decode roles:
    validate, submit, send the completion back when the batcher
    finishes it.  A plain ``generate`` takes the local prefill; a RAW
    ``generate`` frame (meta + KV body), or one naming a ``kv_ref``
    staged here by ``kv_stage``, takes the KV-import path (a mid-stream
    suspended artifact resumes where it stopped).  ``stream`` requests
    get ``tokens`` partial frames with their offsets.

    ``swap_adapter`` folds a weight delta (:func:`_handle_swap_adapter`);
    ``adopt`` goes to ``adopt_fn`` (a ``--warm-pool`` replica's weight
    install), refused without one.

    ``migrate`` asks the batcher to suspend every in-flight request:
    each pending generate then gets a ``suspended`` reply, a raw frame
    with the row's artifact stamped with ``generation``,
    ``weights_version`` and the model id (or a requeue marker when the
    request held no exportable state).  With ``push_to`` each artifact
    goes straight to that replica as a ``kv_stage`` frame and only a
    small ``pushed`` reply goes back.  ``cancel`` stamps an in-flight
    request's deadline into the past, so the batcher's own expiry check
    frees its row."""
    import numpy as np

    from tfmesos_tpu_torch import serving as serving_mod
    from tfmesos_tpu_torch.serving import (Expired, Prefilled, Request,
                                           Suspended)

    batcher = serving.batcher
    log = get_logger(_LOG)
    # The direct-stream staging area: bounded and TTL'd, so an abandoned
    # transfer cannot pin host memory.
    staged: Dict[str, tuple] = {}
    stage_lock = threading.Lock()
    stage_max = 8
    stage_ttl_s = 120.0
    push_state: Dict[str, Any] = {"to": None}
    # In-flight requests by (connection, call id), for cancel.
    inflight: Dict[tuple, Any] = {}
    inflight_lock = threading.Lock()

    def handler(msg, reply: Callable) -> None:
        raw = isinstance(msg, wire.RawFrame)
        head = msg.meta if raw else msg
        mid = head.get("id")
        op = head.get("op")
        if op == "cancel":
            key = (getattr(reply, "conn_key", None), head.get("target"))
            with inflight_lock:
                req = inflight.get(key)
            if req is not None:
                req.deadline = time.perf_counter()
            # The router sends cancels one-way and drops this reply; it
            # keeps the outstanding count balanced.
            reply({"op": "cancelled", "id": mid, "found": req is not None})
            return
        if op == "kv_stage":
            if not raw:
                reply(_error(mid, "bad_request",
                             "kv_stage ships its artifact as a raw frame"))
                return
            xfer = head.get("xfer")
            if not isinstance(xfer, str) or not xfer:
                reply(_error(mid, "bad_request",
                             "kv_stage needs a string xfer id"))
                return
            now = time.monotonic()
            with stage_lock:
                for k in [k for k, (t, _m, _b) in staged.items()
                          if now - t > stage_ttl_s]:
                    del staged[k]
                if len(staged) >= stage_max:
                    reply(_error(mid, "overloaded",
                                 f"kv stage full ({stage_max} transfers "
                                 f"pending)"))
                    return
                staged[xfer] = (now, dict(head), msg.body)
            reply({"op": "kv_staged", "id": mid, "xfer": xfer,
                   "bytes": len(msg.body)})
            return
        if op == "migrate":
            # Ack at once: the suspensions come back as the in-flight
            # requests' own replies on the loop's next tick.
            pt = head.get("push_to")
            push_state["to"] = pt if isinstance(pt, str) and pt else None
            batcher.preempt_all()
            reply({"op": "migrated", "id": mid})
            return
        if op == "swap_adapter":
            _handle_swap_adapter(batcher, msg, reply)
            return
        if op == "adopt":
            if adopt_fn is None:
                reply(_error(mid, "bad_request",
                             "this replica has no model-adoption surface "
                             "(started without a warm-pool role)"))
            else:
                adopt_fn(head, reply)
            return
        if op == "prefill":
            reply(_error(mid, "bad_request",
                         "this replica does not serve the prefill op "
                         "(role: decode/unified); route prefill to a "
                         "prefill-role replica"))
            return
        staged_body = None
        if not raw and head.get("kv_ref") is not None:
            # The artifact landed here as a kv_stage frame; its meta under
            # the call's own fields is the head a relayed raw frame has.
            kv_ref = head.get("kv_ref")
            with stage_lock:
                ent = staged.pop(kv_ref, None) \
                    if isinstance(kv_ref, str) else None
            if ent is None:
                reply(_error(mid, "bad_request",
                             f"unknown kv_ref {kv_ref!r}: staged transfer "
                             f"expired or never landed"))
                return
            _t0, smeta, staged_body = ent
            merged = {k: v for k, v in smeta.items()
                      if k not in ("op", "id", "xfer", "trace",
                                   "prefill_ms")}
            merged.update(head)
            head = merged
        want_model = head.get("model")
        if isinstance(want_model, str) and want_model \
                and model_state is not None \
                and model_state.get("model_id") != want_model:
            reply(_error(mid, "wrong_model",
                         f"this replica serves model "
                         f"{model_state.get('model_id') or '(none)'!r}, "
                         f"not {want_model!r}"))
            return
        tr = _hop_trace(head)
        if tr is not None:
            tr.event("replica", "recv", op="generate", raw=raw)
        prefilled = None
        try:
            prio = head.get("priority")
            sid = head.get("session")
            req = Request(
                prompt=np.asarray(head.get("prompt"), np.int32),
                max_new_tokens=int(head.get("max_new_tokens") or 0),
                stop_token=head.get("stop_token"),
                priority=int(prio) if prio is not None else 0,
                deadline_ms=_deadline_ms(head),
                session_id=(str(sid) if isinstance(sid, str) and sid
                            else None))
            req.trace = tr      # the batcher records its events here
            send_partial = getattr(reply, "partial", None)
            if head.get("stream") and send_partial is not None:
                def on_tokens(toks, off, _mid=mid):
                    send_partial({"op": "tokens", "id": _mid,
                                  "off": int(off), "tokens": toks})

                req.on_tokens = on_tokens
            body = msg.body if raw else staged_body
            if body is not None:
                prefilled = serving_mod.unpack_prefilled(head, body)
                batcher.validate(Prefilled(req, prefilled))
            else:
                # Refuse an unservable request now: the loop's own
                # invalid-request path raises only after it drains.
                batcher.validate(req)
        except (TypeError, ValueError, KeyError) as e:
            reply(_attach_trace(_error(mid, "bad_request", str(e)), tr,
                                failed=True))
            return

        ckey = (getattr(reply, "conn_key", None), mid)
        with inflight_lock:
            inflight[ckey] = req

        def on_done(comp, err) -> None:
            with inflight_lock:
                inflight.pop(ckey, None)
            if comp is None:
                reply(_attach_trace(
                    _error(mid, "internal", err or "request dropped"), tr,
                    failed=True))
                return
            if isinstance(comp, Expired):
                reply(_attach_trace(
                    _error(mid, "deadline_exceeded",
                           "request deadline expired in the batcher; row "
                           "cancelled"), tr, failed=True))
                return
            if isinstance(comp, Suspended):
                _suspended(comp)
                return
            reply(_attach_trace(
                {"op": "completion", "id": mid,
                 "tokens": [int(t) for t in comp.tokens],
                 "ttft_ms": round(comp.ttft_s * 1000.0, 3),
                 "total_ms": round(comp.total_s * 1000.0, 3)}, tr))

        def _suspended(comp) -> None:
            # The model identity rides the export: the router resumes it
            # only on a replica serving the same model and weights.  A
            # migration hop's spans always go back (failed=True).
            model_id = (model_state or {}).get("model_id") or ""
            adapter = getattr(batcher, "adapter_version", "")
            stamp = {"gen": generation, "weights_version": weights_version}
            if comp.artifact is None:
                out = {"op": "suspended", "id": mid, "requeue": True,
                       **stamp}
                if model_id:
                    out["model_id"] = model_id
                reply(_attach_trace(out, tr, failed=True))
                return
            meta, body = serving_mod.pack_prefilled(comp.artifact)
            meta.update(op="suspended", id=mid, adapter_version=adapter,
                        **stamp)
            if model_id:
                meta["model_id"] = model_id
            pt = push_state["to"]
            if pt:
                # One bounded attempt; a failed push relays instead.
                xfer = f"mig-{mid}"
                ack = None
                try:
                    ack = _push(pt, dict(meta, op="kv_stage", xfer=xfer),
                                body, token, self_addr)
                except (OSError, wire.WireError) as e:
                    log.warning("direct KV push of %s to %s failed: %s; "
                                "relaying through the router", xfer, pt, e)
                if isinstance(ack, dict) and ack.get("op") == "kv_staged":
                    out = {"op": "suspended", "id": mid, "pushed": True,
                           "xfer": xfer, "push_to": pt, "bytes": len(body),
                           "adapter_version": adapter, **stamp}
                    if model_id:
                        out["model_id"] = model_id
                    reply(_attach_trace(out, tr, failed=True))
                    return
            _attach_trace(meta, tr, failed=True)
            reply(wire.RawFrame(meta, body))

        serving.submit(req, on_done, prefilled=prefilled)

    return handler


def prefill_handler(batcher, max_queue: int = 8, token: str = "",
                    self_addr: Optional[Callable[[], str]] = None
                    ) -> Callable:
    """The prefill-role handler: run the prompt through prefill only
    (``export_kv``) and send the KV artifact back as one raw
    ``prefilled`` frame, or with ``push_to``/``xfer`` push it straight
    to the decode replica and reply with a small reference.  Admitted
    work drains through one worker thread off a bounded FIFO; a full
    queue answers ``overloaded`` at once.  ``generate`` is refused: a
    prefill-role replica never decodes and never starts a serve loop
    (``export_kv`` raises while one runs)."""
    import numpy as np

    from tfmesos_tpu_torch import serving as serving_mod
    from tfmesos_tpu_torch.serving import Request

    log = get_logger(_LOG)
    work_q: "_queue.Queue" = _queue.Queue(maxsize=max_queue)

    def prefill_one(req, mid, reply, t_enq, push) -> None:
        tr = req.trace
        if tr is not None:
            tr.add("replica", "prefill_queue", tr.rel_ms(t_enq),
                   (time.perf_counter() - t_enq) * 1000.0)
        if req.expired:
            # Shed without spending a prompt's prefill.
            batcher.deadline_cancels += 1
            reply(_attach_trace(
                _error(mid, "deadline_exceeded",
                       "request deadline expired in the prefill queue"),
                tr, failed=True))
            return
        try:
            t0 = time.perf_counter()
            meta, body = serving_mod.pack_prefilled(batcher.export_kv(req))
            prefill_ms = round((time.perf_counter() - t0) * 1000.0, 3)
            meta.update(op="prefilled", id=mid, prefill_ms=prefill_ms)
            if tr is not None:
                tr.add("replica", "prefill_export", tr.rel_ms(t0),
                       prefill_ms)
                _attach_trace(meta, tr)
            if push is not None:
                daddr, xfer = push
                ack = None
                try:
                    ack = _push(daddr, dict(meta, op="kv_stage", xfer=xfer),
                                body, token, self_addr)
                except (OSError, wire.WireError) as e:
                    log.warning("direct KV push of %s to %s failed: %s; "
                                "relaying through the router", xfer, daddr,
                                e)
                if isinstance(ack, dict) and ack.get("op") == "kv_staged":
                    out = {"op": "prefilled", "id": mid, "pushed": True,
                           "xfer": xfer, "bytes": len(body),
                           "prefill_ms": prefill_ms}
                    reply(_attach_trace(out, tr))
                    return
            reply(wire.RawFrame(meta, body))
        except Exception as e:
            log.exception("prefill failed: %s", e)
            reply(_attach_trace(_error(mid, "internal", repr(e)), tr,
                                failed=True))

    def drain(context) -> None:
        with context():
            while True:
                prefill_one(*work_q.get())

    threading.Thread(target=drain, args=(_worker_context(batcher),),
                     name="replica-prefill", daemon=True).start()

    def handler(msg, reply: Callable) -> None:
        raw = isinstance(msg, wire.RawFrame)
        head = msg.meta if raw else msg
        mid = head.get("id")
        if not raw and head.get("op") == "migrate":
            # No resident rows to suspend; ack so a tier-blind drain
            # migrates every member the same way.
            reply({"op": "migrated", "id": mid})
            return
        if head.get("op") == "swap_adapter":
            # Prefill replicas compute KV with the weights too; with no
            # serve loop the fold applies at once.
            _handle_swap_adapter(batcher, msg, reply)
            return
        if raw or head.get("op") != "prefill":
            reply(_error(mid, "bad_request",
                         "this replica serves only the prefill op (role: "
                         "prefill); route generate to a decode or unified "
                         "replica"))
            return
        tr = _hop_trace(head)
        if tr is not None:
            tr.event("replica", "recv", op="prefill")
        try:
            prio = head.get("priority")
            req = Request(
                prompt=np.asarray(head.get("prompt"), np.int32),
                max_new_tokens=int(head.get("max_new_tokens") or 0),
                stop_token=head.get("stop_token"),
                priority=int(prio) if prio is not None else 0,
                deadline_ms=_deadline_ms(head))
            req.trace = tr
            batcher.validate(req)
        except (TypeError, ValueError) as e:
            reply(_attach_trace(_error(mid, "bad_request", str(e)), tr,
                                failed=True))
            return
        push = None
        pt, xf = head.get("push_to"), head.get("xfer")
        if isinstance(pt, str) and pt and isinstance(xf, str) and xf:
            push = (pt, xf)
        try:
            work_q.put_nowait((req, mid, reply, time.perf_counter(), push))
        except _queue.Full:
            reply(_attach_trace(
                _error(mid, "overloaded",
                       f"prefill queue full ({max_queue} pending)"),
                tr, failed=True))

    return handler


def fabric_handler(fabric, inner: Optional[Callable] = None) -> Callable:
    """Wrap a replica handler with the KV fabric's wire ops: ``kv_put``
    lands a peer's replicated park, ``kv_fetch`` serves a peer's resume
    from this replica's tier; everything else goes to ``inner``.  With
    no ``inner`` (a ``--role kv`` holder) ``migrate`` is acknowledged
    (nothing to suspend) and every other op refused: a holder never
    decodes."""

    def handler(msg, reply: Callable) -> None:
        raw = isinstance(msg, wire.RawFrame)
        head = msg.meta if raw else msg
        op = head.get("op")
        mid = head.get("id")
        if op == "kv_put":
            if not raw:
                reply(_error(mid, "bad_request",
                             "kv_put ships its artifact as a raw frame"))
                return
            out = fabric.handle_put(msg)
            out.setdefault("id", mid)
            reply(out)
            return
        if op == "kv_fetch":
            out = fabric.handle_fetch(head)
            (out.meta if isinstance(out, wire.RawFrame)
             else out).setdefault("id", mid)
            reply(out)
            return
        if inner is not None:
            inner(msg, reply)
            return
        if op == "migrate":
            reply({"op": "migrated", "id": mid})
            return
        reply(_error(mid, "bad_request",
                     f"this replica holds KV state only (role: kv); it "
                     f"does not serve {op!r}"))

    return handler


# -- batcher assembly --------------------------------------------------------


def rid_seed_for_node(node: str) -> int:
    """Per-replica request-id base from the fleet node id ("job:index"):
    sampled draws fold (rid, step), so two replicas must never share
    rids.  A 20-bit CRC of the node shifted 10 bits gives each node its
    own 1024-rid block; no node gives 0."""
    if not node:
        return 0
    return (zlib.crc32(node.encode("utf-8")) & 0xFFFFF) << 10


def build_batcher(args, node: str = "", params=None, token: str = "",
                  generation: int = 0, draft_params=None):
    """The model and ``ContinuousBatcher`` one replica runs, from the
    parsed flags: the port's tiny or flagship preset drawn from
    ``--model-seed`` (default ``--seed``), or ``params`` (the same
    preset's shapes, e.g. ``convert.params_from_jax`` of the JAX
    preset's weights), on ``--device`` (default: the card).  ``--draft``
    adds the preset's draft (``tiny_draft_model`` at its default seed,
    or ``flagship_draft_model`` at ``--seed`` + 1, as the JAX replica
    builds them; ``draft_params`` replaces its weights) with
    ``--n-draft`` proposals a round.  ``node`` ("job:index") sets the
    request-id base.  ``--kv-tier-mb`` /
    ``--kv-tier-dir`` give it a :class:`~tfmesos_tpu_torch.fleet.kvtier.
    KVTierStore` keyed by ``token`` and stamped with the rollout
    identity (``--weights-version``, composed with ``--model-id``, and
    ``generation``), so another version's parked KV reads as a miss."""
    from tfmesos_tpu_torch.device import resolve_device
    from tfmesos_tpu_torch.fleet.kvtier import KVTierStore
    from tfmesos_tpu_torch.models import presets
    from tfmesos_tpu_torch.serving import ContinuousBatcher

    refuse_unported(args, environ={})
    device = resolve_device(args.device)
    seed = args.model_seed if args.model_seed is not None else args.seed
    cfg, drawn = (presets.tiny_model(seed) if args.tiny
                  else presets.flagship_model(seed,
                                              max_len=args.max_len or 1024))
    draft_cfg = None
    if args.draft:
        max_len = args.max_len or int(cfg.max_seq_len)
        draft_cfg, ddrawn = (
            presets.tiny_draft_model(max_len=max_len, n_draft=args.n_draft)
            if args.tiny else presets.flagship_draft_model(
                seed=args.seed + 1, max_len=max_len, n_draft=args.n_draft))
        draft_params = ddrawn if draft_params is None else draft_params
    kv_tier = None
    if args.kv_tier_mb > 0 or args.kv_tier_dir:
        wv_stamp = args.weights_version
        if args.model_id:
            wv_stamp = f"{args.weights_version or 'v0'}@{args.model_id}"
        kv_tier = KVTierStore(
            ram_bytes=int(max(0.0, args.kv_tier_mb) * 1e6),
            disk_dir=args.kv_tier_dir, token=token,
            stamp={"weights_version": wv_stamp, "gen": generation})
    return ContinuousBatcher(
        cfg, drawn if params is None else params, rows=args.rows,
        max_len=args.max_len, page_size=args.page_size,
        prefill_bucket=args.prefill_bucket, multi_step=args.multi_step,
        prefix_cache_pages=args.prefix_cache_pages,
        pipeline_depth=args.pipeline_depth,
        # Fused scheduling serves chunked, the bucket doubling as the
        # chunk width.
        prefill_chunk=args.prefill_bucket if args.fused_prefill else None,
        fused_prefill=args.fused_prefill,
        tokens_per_tick=args.tokens_per_tick, kv_tier=kv_tier,
        draft_cfg=draft_cfg,
        draft_params=draft_params if draft_cfg is not None else None,
        n_draft=args.n_draft, rid_seed=rid_seed_for_node(node),
        device=device)


def refuse_unported(args, environ=None) -> None:
    """Raise :class:`ReplicaRefused` for an option whose surface this
    port does not have yet (or an invalid ``--model-id`` /
    ``--kv-replication``), naming the ROADMAP item it waits for."""
    environ = os.environ if environ is None else environ
    if not 1 <= args.kv_replication <= 8:
        raise ReplicaRefused("--kv-replication must be in [1, 8]")
    if environ.get(GANG_ENV_ID):
        raise ReplicaRefused(f"not ported yet: a gang launch ({GANG_ENV_ID} "
                             f"set; the mesh, ROADMAP A.9)")
    if args.model_id and not MODEL_ID_RE.fullmatch(args.model_id):
        raise ReplicaRefused(
            f"model_id {args.model_id!r} is not a valid label: want 1-64 "
            f"chars of [A-Za-z0-9._-] starting alphanumeric")


# -- process entry ----------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    """The JAX replica's flags, plus ``--device``."""
    p = argparse.ArgumentParser(
        prog="python -m tfmesos_tpu_torch.fleet.replica",
        description="One fleet serving replica: a ContinuousBatcher "
                    "behind an authenticated TCP server.")
    p.add_argument("--registry", type=str, default=None,
                   help="registry host:port to heartbeat (none = serve "
                        "unregistered)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="listen port (0 = OS-assigned)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu runs the plain "
                        "PyTorch path)")
    p.add_argument("--rows", type=int, default=4,
                   help="concurrent decode rows (= advertised capacity)")
    p.add_argument("--max-len", type=int, default=None)
    p.add_argument("--page-size", type=int, default=64)
    p.add_argument("--prefill-bucket", type=int, default=64)
    p.add_argument("--multi-step", type=int, default=1)
    p.add_argument("--fused-prefill", action="store_true",
                   dest="fused_prefill",
                   help="serve in chunked-prefill mode (chunk width = "
                        "--prefill-bucket) with each tick's chunk slots "
                        "in the decode block's dispatch")
    p.add_argument("--tokens-per-tick", type=int, default=None,
                   dest="tokens_per_tick",
                   help="the fused tick's token budget (default: rows x "
                        "multi_step + one chunk)")
    p.add_argument("--prefix-cache-pages", type=int, default=0,
                   help="cross-request prefix cache budget in pool pages "
                        "(0 disables); its summary rides the heartbeats")
    p.add_argument("--kv-tier-mb", type=float, default=0.0,
                   dest="kv_tier_mb",
                   help="host-RAM KV tier budget in MB (0 disables): "
                        "prefix pages the device pool evicts spill here "
                        "and promote back on the next hit, and "
                        "session-labelled requests park their KV "
                        "between turns")
    p.add_argument("--kv-tier-dir", type=str, default=None,
                   dest="kv_tier_dir",
                   help="disk tier directory (default: RAM only): "
                        "RAM-evicted entries spill into HMAC-framed "
                        "files, and replicas sharing the directory "
                        "resume each other's parked sessions (bounded "
                        "at 4x the RAM budget)")
    p.add_argument("--role", choices=("unified", "prefill", "decode", "kv"),
                   default="unified",
                   help="'unified' serves whole requests; 'prefill' only "
                        "exports prompts' KV; 'decode' also imports "
                        "exported KV; 'kv' serves no model: a holder of "
                        "the KV fabric's replicated parks, which never "
                        "imports torch (needs --kv-tier-mb or "
                        "--kv-tier-dir)")
    p.add_argument("--kv-replication", type=int, default=1,
                   dest="kv_replication",
                   help="K-way replicated session parking (default 1, "
                        "local only): a park lands here and on K-1 "
                        "fabric peers, so it survives this replica; "
                        "needs --registry and a KV tier")
    p.add_argument("--kv-placement", choices=("rendezvous", "loaded"),
                   default="rendezvous", dest="kv_placement",
                   help="fabric peer choice for replicated parks: "
                        "'rendezvous' (hash order) or 'loaded' (the same "
                        "order re-scored by the peers' tier occupancy)")
    p.add_argument("--pipeline-depth", type=int, default=0,
                   choices=(0, 1), dest="pipeline_depth",
                   help="1 keeps the decode carry on the device, block N "
                        "synced one block behind")
    p.add_argument("--draft", action="store_true",
                   help="serve with the preset's draft model (speculative "
                        "decoding): a row commits 1..n_draft+1 tokens a "
                        "round, and the acceptance rate rides every "
                        "heartbeat as 'spec'")
    p.add_argument("--n-draft", type=int, default=4, dest="n_draft",
                   help="draft proposals a speculative round (with "
                        "--draft)")
    p.add_argument("--warmup", action="store_true",
                   help="capture every serving shape before taking "
                        "traffic, registered as 'warming' meanwhile")
    p.add_argument("--tiny", action="store_true",
                   help="serve the tiny CI model instead of the flagship")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--heartbeat-interval", type=float, default=0.3)
    p.add_argument("--model-id", type=str, default="", dest="model_id",
                   help="model-catalog identity this replica serves "
                        "(rides every heartbeat)")
    p.add_argument("--model-seed", type=int, default=None,
                   dest="model_seed",
                   help="weight seed (default: --seed)")
    p.add_argument("--warm-pool", action="store_true", dest="warm_pool",
                   help="register as an undedicated warm-pool member: "
                        "warmed and alive, serving no model until the "
                        "'adopt' op installs one (a weight copy: nothing "
                        "is relaunched or recaptured)")
    p.add_argument("--weights-version", type=str, default="",
                   dest="weights_version",
                   help="weights version label; rides the hello and every "
                        "heartbeat")
    return p


def _identity(environ) -> tuple:
    """(launch generation, node "job:index") from the task env."""
    try:
        generation = int(environ.get("TPUMESOS_GENERATION", "0") or 0)
    except ValueError:
        generation = 0
    job = environ.get("TPUMESOS_JOB_NAME", "")
    idx = environ.get("TPUMESOS_TASK_INDEX", "")
    return generation, (f"{job}:{idx}" if job and idx != "" else "")


def start_replica(args, token: Optional[str] = None, params=None,
                  environ=None, draft_params=None) -> tuple:
    """Build, register and start one replica from parsed flags; returns
    ``(server, serving, batcher)`` (``serving`` None for the prefill
    role, which never runs a serve loop; ``--role kv`` is
    :func:`start_kv_holder`'s, returned as ``(server, None, fabric)``).
    Registers (as ``warming`` under ``--warmup``) before warming up,
    then prints ``replica warmed ...`` and ``replica serving on ADDR
    (role R)``.  ``token`` defaults to the task env's, ``params`` to the
    preset's draw, ``draft_params`` the draft preset's (with
    ``--draft``).  Behind ``--registry`` a KV tier is wrapped in a
    :class:`~tfmesos_tpu_torch.fleet.kvtier.KVFabric` (the batcher's
    ``kv_tier`` becomes the fabric) and the replica serves ``kv_put`` /
    ``kv_fetch``.  Raises :class:`ReplicaRefused` for an option not
    ported yet."""
    environ = os.environ if environ is None else environ
    refuse_unported(args, environ)
    token = wire.load_token(environ) if token is None else token
    if args.role == "kv":
        server, fabric = start_kv_holder(args, token=token, environ=environ)
        return server, None, fabric
    log = get_logger(_LOG)
    generation, node = _identity(environ)
    model_state: Dict[str, Any] = {"model_id": args.model_id or "",
                                   "warm_pool": bool(args.warm_pool),
                                   "pool_capable": bool(args.warm_pool)}
    batcher = build_batcher(args, node=node, params=params, token=token,
                            generation=generation, draft_params=draft_params)
    fabric = None
    if args.registry and batcher.kv_tier is not None \
            and batcher.kv_tier_bypass_reason is None:
        from tfmesos_tpu_torch.fleet.kvtier import KVFabric

        fabric = KVFabric(batcher.kv_tier, token=token,
                          registry_addr=args.registry,
                          replication=args.kv_replication,
                          placement=args.kv_placement)
        batcher.kv_tier = fabric
    srv_cell: List[ReplicaServer] = []

    def self_addr() -> str:
        return (srv_cell[0].addr or "") if srv_cell else ""

    def adopt_fn(head, reply) -> None:
        """The ``adopt`` op: install one catalog model's preset weights
        (``seed``) on this undedicated replica and take its
        ``model_id``.  The same preset and max_len as the boot build,
        so the shapes are the captured graphs' own: a weight copy, no
        relaunch and no recapture.  Only a warm-pool member adopts, and
        only once."""
        from tfmesos_tpu_torch.fleet.registry import validate_model_id
        from tfmesos_tpu_torch.models import presets

        mid = head.get("id")
        try:
            model_id = validate_model_id(head.get("model_id"))
            seed = int(head.get("seed") or 0)
        except (TypeError, ValueError) as e:
            reply(_error(mid, "bad_request", str(e)))
            return
        if model_state["model_id"] or model_state.get("adopting"):
            reply(_error(mid, "bad_request",
                         f"already serving model "
                         f"{model_state['model_id'] or '(adopting)'!r}; "
                         f"adoption is a warm-pool-only transition"))
            return
        model_state["adopting"] = True
        _, new_params = (presets.tiny_model(seed) if args.tiny
                         else presets.flagship_model(
                             seed, max_len=args.max_len or 1024))

        def applied() -> None:
            model_state["model_id"] = model_id
            model_state["warm_pool"] = False
            model_state["adopting"] = False
            log.info("adopted model %s (seed %d)", model_id, seed)
            reply({"op": "adopted", "id": mid, "model_id": model_id})

        batcher.set_weights(
            new_params, version=f"{args.weights_version or 'v0'}@{model_id}",
            on_applied=applied)

    serving = None
    if args.role == "prefill":
        handler = prefill_handler(batcher, token=token, self_addr=self_addr)
    else:
        # Not started yet: warmup runs before the loop owns the rows.
        serving = BatcherServing(batcher)
        handler = batcher_handler(serving, generation=generation,
                                  weights_version=args.weights_version,
                                  model_state=model_state,
                                  adopt_fn=adopt_fn, token=token,
                                  self_addr=self_addr)
    if fabric is not None:
        handler = fabric_handler(fabric, handler)
    tiered = batcher.kv_tier is not None \
        and batcher.kv_tier_bypass_reason is None

    def extra() -> Dict[str, Any]:
        beat: Dict[str, Any] = {"role": args.role,
                                "kv_headroom": batcher.kv_headroom(),
                                "gen": generation}
        if args.weights_version:
            beat["weights_version"] = args.weights_version
        if node:
            beat["node"] = node
        if model_state["model_id"]:
            beat["model_id"] = model_state["model_id"]
        if model_state["pool_capable"]:
            # Always sent once pool-capable, so an adoption's False
            # overwrites the registry's True.
            beat["warm_pool"] = bool(model_state["warm_pool"])
        # Sent even when "": a set after a fold resets it.
        beat["adapter_version"] = batcher.adapter_version
        if batcher.prefix_cache_active:
            beat["prefix_cache"] = batcher.prefix_cache_summary()
        if tiered:
            # Parked session ids (the router's session affinity), spilled
            # prefix digests, counters and occupancy.
            beat["kv_tier"] = batcher.kv_tier.summary()
        if batcher.d_side is not None:
            # Speculative health: the acceptance rate (None before the
            # first round) and the sums the registry re-aggregates.
            beat["spec"] = {"acceptance_rate": batcher.acceptance_rate,
                            "rounds": batcher.spec_rounds,
                            "row_rounds": batcher.spec_row_rounds,
                            "committed": batcher.spec_committed,
                            "n_draft": batcher.n_draft}
        return beat

    def stats(msg: Dict[str, Any]) -> Dict[str, Any]:
        """Where this replica runs, the device memory it holds, its
        kernels' launch counts (zeroed first when ``reset_launches`` is
        set), how many step graphs its batcher has captured, the
        batcher's dispatch counters and its KV tier's counters: how a
        launcher in another process sees that the replica is on the
        card, which kernels its requests ran and that none of them
        captured a graph after warmup."""
        import torch

        from tfmesos_tpu_torch import graphs

        if msg.get("reset_launches"):
            graphs.zero_launches()
        dev = batcher.device
        return {"pid": os.getpid(), "device": str(dev),
                "memory_allocated": (torch.cuda.memory_allocated(dev)
                                     if dev.type == "cuda" else 0),
                "launches": graphs.launch_counts(),
                "graphs": len(batcher._graphs.keys()),
                "multi_step": batcher.multi_step,
                "counters": {k: getattr(batcher, k) for k in STATS_COUNTERS},
                "kv_tier": batcher.kv_tier.stats() if tiered else None}

    server = ReplicaServer(
        handler, token=token, capacity=args.rows, host=args.host,
        port=args.port, registry_addr=args.registry,
        heartbeat_interval=args.heartbeat_interval, extra_info=extra,
        status="warming" if args.warmup else None, stats=stats)
    srv_cell.append(server)
    server.start()
    if fabric is not None:
        fabric.self_addr = server.addr or ""
    if args.warmup:
        # A role replica warms only the surface it serves.
        info = batcher.warmup(decode=args.role != "prefill",
                              prefill=args.role != "decode")
        log.info("warmup captured %s in %.1fs", info["compiled"],
                 info["seconds"])
        print(f"replica warmed in {info['seconds']:.1f}s "
              f"({len(info['compiled'])} entry points)", flush=True)
    if serving is not None:
        serving.start()
    server.set_status(None)     # routable: the next beat drops 'warming'
    print(f"replica serving on {server.addr} (role {args.role})",
          flush=True)
    return server, serving, batcher


def start_kv_holder(args, token: Optional[str] = None,
                    environ=None) -> tuple:
    """Start a ``--role kv`` replica: a bare KV tier behind the replica
    wire (``kv_put`` / ``kv_fetch``), heartbeating as role ``kv`` with
    capacity 0, so the router never sends it tokens.  It builds no model
    and no batcher and imports no torch, so it never holds card memory;
    its ``stats`` op says so and lists its tier.  Its store has an empty
    stamp: it keeps other replicas' artifacts verbatim, and the replica
    that fetches one judges the writer's stamp.  Returns ``(server,
    fabric)``; raises :class:`ReplicaRefused` without a tier."""
    from tfmesos_tpu_torch.fleet.kvtier import KVFabric, KVTierStore

    environ = os.environ if environ is None else environ
    refuse_unported(args, environ)
    if args.kv_tier_mb <= 0 and not args.kv_tier_dir:
        raise ReplicaRefused("--role kv needs a tier to hold "
                             "(--kv-tier-mb and/or --kv-tier-dir)")
    token = wire.load_token(environ) if token is None else token
    generation, node = _identity(environ)
    store = KVTierStore(ram_bytes=int(max(0.0, args.kv_tier_mb) * 1e6),
                        disk_dir=args.kv_tier_dir, token=token, stamp={})
    fabric = KVFabric(store, token=token, registry_addr=args.registry,
                      replication=1, placement=args.kv_placement)

    def extra() -> Dict[str, Any]:
        beat: Dict[str, Any] = {"role": "kv", "gen": generation,
                                "kv_tier": store.summary()}
        if args.weights_version:
            beat["weights_version"] = args.weights_version
        if node:
            beat["node"] = node
        return beat

    def stats(msg: Dict[str, Any]) -> Dict[str, Any]:
        torch = sys.modules.get("torch")
        cuda = bool(torch is not None and torch.cuda.is_initialized())
        return {"pid": os.getpid(), "device": None, "role": "kv",
                "torch_imported": torch is not None,
                "cuda_initialized": cuda,
                "memory_allocated": (torch.cuda.memory_allocated()
                                     if cuda else 0),
                "kv_tier": store.stats(), "summary": store.summary()}

    server = ReplicaServer(
        fabric_handler(fabric), token=token, capacity=0, host=args.host,
        port=args.port, registry_addr=args.registry,
        heartbeat_interval=args.heartbeat_interval, extra_info=extra,
        stats=stats)
    server.start()
    fabric.self_addr = server.addr or ""
    print(f"replica serving on {server.addr} (role kv)", flush=True)
    return server, fabric


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    log = get_logger(_LOG)
    try:
        server, serving, _ = start_replica(args)
    except ReplicaRefused as e:
        print(f"replica: {e}", file=sys.stderr)
        return 2
    stop = threading.Event()

    def on_signal(signum, frame) -> None:
        log.info("signal %d: draining", signum)
        stop.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    stop.wait()
    server.stop()
    if serving is not None:
        serving.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
