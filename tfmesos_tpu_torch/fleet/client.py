"""Multiplexed request/reply over the authenticated wire (port of
``tfmesos_tpu/fleet/client.py``; the ``rollout`` and ``swap_adapter``
control calls wait with the fleet features they drive).

One persistent connection carries many in-flight calls, matched by a
connection-local ``id`` the caller assigns: the router's link to a
replica (:class:`MuxConnection`, whose ``outstanding`` count is what
least-outstanding routing balances on) and the caller's link to the
gateway (:class:`FleetClient`).  A reply stream may interleave PARTIAL
frames (``{"op": "tokens", "id", "off", "tokens"}``) before the final
reply; they go to the call's ``on_partial`` callback without resolving
it.

When the peer closes or the socket fails, every pending call fails at
once with :class:`ConnectionLost`; a reader-thread death that is not a
transport failure fails them with :class:`ReaderDied`.  Nothing waits
out a timeout for a reply nobody can deliver.

Multi-gateway failover: :class:`FleetClient` takes a list of gateway
addresses.  ``generate`` is idempotent (completions are deterministic
and nothing was delivered when a gateway died mid-call), so a
:class:`ConnectionLost` mid-generate re-resolves the gateway list (the
``gateways`` discovery op) and replays the request on a surviving
gateway; streamed tokens are de-duplicated by offset, so ``on_tokens``
sees each token exactly once even across a replay.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from tfmesos_tpu_torch import wire
from tfmesos_tpu_torch.fleet.admission import Overloaded, RateLimited
from tfmesos_tpu_torch.utils.logging import get_logger

__all__ = ["ConnectionLost", "ReaderDied", "CallTimeout", "RequestFailed",
           "Overloaded", "RateLimited", "MuxConnection", "FleetClient"]


class ConnectionLost(OSError):
    """The peer went away (EOF, reset, or bad frame) with calls pending."""


class ReaderDied(ConnectionLost):
    """The mux reader thread died on an unexpected error (not a clean
    EOF or socket failure): a client-side bug, not replica health."""


class CallTimeout(TimeoutError):
    """No reply within the caller's deadline (the connection is still up)."""


class RequestFailed(RuntimeError):
    """The peer replied with an error (``kind`` names which)."""

    def __init__(self, message: str, kind: str = "error"):
        super().__init__(message)
        self.kind = kind


class MuxConnection:
    """Thread-safe multiplexed calls over one authenticated socket.

    ``call()`` may run on any number of threads; a reader thread hands
    replies to their waiters by ``id``.  ``outstanding`` is the number
    of calls awaiting replies."""

    def __init__(self, addr: str, token: str = "",
                 connect_timeout: float = 10.0):
        self.addr = addr
        self._token = token
        self._sock = wire.connect(addr, timeout=connect_timeout)
        # Idle links are normal; per-call deadlines live in call().
        self._sock.settimeout(None)
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()
        # id -> [Event, reply|None, on_partial|None]
        self._slots: Dict[int, list] = {}
        self._next_id = 0
        self._closed = False
        self._error: Optional[str] = None
        self._reader_died = False
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"mux-{addr}", daemon=True)
        self._reader.start()

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def outstanding(self) -> int:
        with self._lock:
            return len(self._slots)

    def _lost(self) -> ConnectionLost:
        why = self._error or "connection closed"
        return ReaderDied(why) if self._reader_died \
            else ConnectionLost(why)

    def call(self, msg: Dict[str, Any],
             timeout: Optional[float] = None,
             on_partial: Optional[Callable[[Any], None]] = None) -> Any:
        """Send ``msg`` (its ``id`` replaced by ours) and block for the
        matching reply: a dict, or a :class:`~tfmesos_tpu_torch.wire.
        RawFrame` when the peer answers with a raw frame (a KV export).
        ``on_partial`` receives the call's partial frames on the reader
        thread and must not block."""
        return self._call(msg, None, timeout, on_partial)

    def call_raw(self, meta: Dict[str, Any], body,
                 timeout: Optional[float] = None,
                 on_partial: Optional[Callable[[Any], None]] = None
                 ) -> Any:
        """Like :meth:`call`, shipping ``meta`` + ``body`` as one raw
        frame (the KV handoff into a decode replica)."""
        return self._call(meta, body, timeout, on_partial)

    def notify(self, msg: Dict[str, Any]) -> bool:
        """One-way send with ``id`` 0 (call ids start at 1, so a reply
        matches no slot and is dropped): advisory traffic such as
        ``cancel``.  Returns False instead of raising on a send
        failure."""
        out = dict(msg)
        out["id"] = 0
        try:
            with self._send_lock:
                wire.send_msg(self._sock, out, self._token)
            return True
        except (OSError, wire.WireError):
            return False

    def _call(self, msg: Dict[str, Any], raw_body,
              timeout: Optional[float] = None,
              on_partial: Optional[Callable[[Any], None]] = None) -> Any:
        with self._lock:
            if self._closed:
                raise self._lost()
            self._next_id += 1
            mid = self._next_id
            slot = [threading.Event(), None, on_partial]
            self._slots[mid] = slot
        out = dict(msg)
        out["id"] = mid
        try:
            with self._send_lock:
                if raw_body is not None:
                    wire.send_raw_msg(self._sock, out, raw_body,
                                      self._token)
                else:
                    wire.send_msg(self._sock, out, self._token)
        except wire.WireError:
            # Refused at encode time, before any byte was sent: the link
            # is fine, only this payload is at fault.
            with self._lock:
                self._slots.pop(mid, None)
            raise
        except OSError as e:
            with self._lock:
                self._slots.pop(mid, None)
            self._fail(f"send failed: {e}")
            raise ConnectionLost(str(e)) from e
        if not slot[0].wait(timeout):
            with self._lock:
                self._slots.pop(mid, None)
                # A reply that raced the timeout is stored under this
                # lock: honour it.
                if slot[1] is not None:
                    return slot[1]
            raise CallTimeout(f"no reply from {self.addr} "
                              f"within {timeout}s")
        if slot[1] is None:     # woken by _fail, not by a reply
            raise self._lost()
        return slot[1]

    def _read_loop(self) -> None:
        framer = wire.Framer(self._token, allow_raw=True)
        try:
            for msg in wire.iter_msgs(self._sock, framer):
                if isinstance(msg, wire.RawFrame):
                    head = msg.meta if isinstance(msg.meta, dict) else {}
                elif isinstance(msg, dict):
                    head = msg
                else:
                    continue
                mid = head.get("id")
                if head.get("op") == "tokens":
                    with self._lock:
                        slot = self._slots.get(mid)
                        cb = slot[2] if slot is not None else None
                    if cb is not None:
                        try:
                            cb(msg)
                        except Exception:
                            pass    # a broken consumer costs its stream
                    continue
                with self._lock:
                    slot = self._slots.pop(mid, None)
                    if slot is not None:
                        slot[1] = msg
                if slot is not None:
                    slot[0].set()
            self._fail("EOF from peer")
        except (OSError, wire.WireError) as e:
            self._fail(str(e))
        except BaseException as e:  # noqa: BLE001 - reader must not die
            self._fail(f"reader thread died: {e!r}", died=True)
            raise

    def _fail(self, why: str, died: bool = False) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._error = why
            self._reader_died = died
            pending: List[list] = list(self._slots.values())
            self._slots.clear()
        # shutdown before close: the reader may be blocked in recv.
        wire.shutdown_socket(self._sock)
        try:
            self._sock.close()
        except OSError:
            pass
        for slot in pending:    # wake every waiter; slot[1] stays None
            slot[0].set()

    def close(self) -> None:
        self._fail("closed by caller")


class FleetClient:
    """Caller-side handle on a fleet gateway (or a SET of them).

    Thread-safe: many threads may ``generate()`` concurrently over the
    one multiplexed connection.  Overload rejections surface as
    :class:`~tfmesos_tpu_torch.fleet.admission.Overloaded` — the explicit
    backpressure signal callers are expected to handle (back off,
    retry later, or spill).

    ``addr`` may be one ``host:port`` or a list of them (a
    multi-gateway fleet, ``tfserve --gateways N``): the client connects
    to the first reachable gateway, refreshes the full set through the
    ``gateways`` discovery op, and — when its gateway dies mid-stream —
    fails over by REPLAYING idempotent in-flight ``generate`` calls on
    a survivor (streamed tokens de-duplicated by offset, so
    ``on_tokens`` sees each token exactly once).  ``max_failovers``
    bounds the replays per call; 0 disables failover entirely (the
    single-gateway behavior of old)."""

    def __init__(self, addr: Union[str, Sequence[str]], token: str = "",
                 timeout: float = 120.0, connect_timeout: float = 10.0,
                 max_failovers: int = 2):
        addrs = [addr] if isinstance(addr, str) else list(addr)
        if not addrs:
            raise ValueError("FleetClient needs at least one gateway "
                             "address")
        self.addr = addrs[0]
        self.timeout = timeout
        self.connect_timeout = float(connect_timeout)
        self.max_failovers = int(max_failovers)
        self._token = token
        self.log = get_logger("tfmesos_tpu_torch.fleet.client")
        self._mlock = threading.Lock()
        self._addrs: List[str] = addrs
        self._mux: Optional[MuxConnection] = None
        self._closed = False
        # Dial eagerly (constructor-raises-on-unreachable is the
        # contract tests and tfserve rely on), trying each address.
        self._connection()

    # -- connection management ---------------------------------------------

    @property
    def addrs(self) -> List[str]:
        """The currently known gateway set (discovery-refreshed)."""
        with self._mlock:
            return list(self._addrs)

    def _connection(self) -> MuxConnection:
        """The live mux, dialing down the known-gateway list if the
        current one is gone.  Raises the last dial error when every
        address fails.  Dials happen OUTSIDE the lock: a blocked
        connect (up to connect_timeout per dead address) must not
        stall every other caller — including close() — on the lock; a
        dial race keeps the first registered connection and closes the
        loser."""
        with self._mlock:
            if self._closed:
                raise ConnectionLost("client closed")
            mux = self._mux
            if mux is not None and not mux.closed:
                return mux
            addrs = list(self._addrs)
        last: Optional[Exception] = None
        for a in addrs:
            try:
                mux = MuxConnection(a, self._token,
                                    connect_timeout=self.connect_timeout)
            except OSError as e:
                last = e
                continue
            with self._mlock:
                if self._closed:
                    mux.close()
                    raise ConnectionLost("client closed")
                cur = self._mux
                if cur is not None and not cur.closed:
                    mux.close()     # lost the race; use the winner
                    return cur
                self._mux = mux
                self.addr = a
            return mux
        raise ConnectionLost(
            f"no gateway reachable among {addrs}: {last}")

    def _drop(self, mux: MuxConnection) -> None:
        """Forget a dead connection and rotate its address to the back
        of the list so the next dial tries a different gateway first."""
        with self._mlock:
            if self._mux is mux:
                self._mux = None
            if mux.addr in self._addrs and len(self._addrs) > 1:
                self._addrs.remove(mux.addr)
                self._addrs.append(mux.addr)
        mux.close()

    def _refresh_gateways(self) -> None:
        """Best-effort discovery: merge the gateway's own view of the
        fleet's front doors into ours (new gateways become failover
        targets without a client restart)."""
        try:
            mux = self._connection()
            reply = mux.call({"op": "gateways"}, timeout=5.0)
        except Exception:
            return
        if not isinstance(reply, dict):
            return
        got = reply.get("gateways")
        if not isinstance(got, list):
            return
        fresh = [a for a in got if isinstance(a, str) and a]
        if not fresh:
            return
        with self._mlock:
            known = set(self._addrs)
            self._addrs.extend(a for a in fresh if a not in known)

    def gateways(self, timeout: float = 10.0) -> List[str]:
        """The fleet's registered gateway addresses (the ``gateways``
        discovery op — ``tfserve gateways``)."""
        reply = self._connection().call({"op": "gateways"},
                                        timeout=timeout)
        if isinstance(reply, dict) and isinstance(
                reply.get("gateways"), list):
            return [a for a in reply["gateways"] if isinstance(a, str)]
        return []

    # -- requests ----------------------------------------------------------

    def generate(self, prompt, max_new_tokens: int,
                 stop_token: Optional[int] = None,
                 timeout: Optional[float] = None,
                 priority: Optional[str] = None,
                 deadline_ms: Optional[float] = None,
                 trace=None,
                 session: Optional[str] = None,
                 model: Optional[str] = None,
                 on_tokens: Optional[Callable[[List[int]], None]] = None
                 ) -> Dict[str, Any]:
        """One generation request; returns the completion dict
        (``tokens``, ``ttft_ms``, ``total_ms``, ``trace_id``).  Raises
        ``Overloaded`` on shed, :class:`RequestFailed` on any other
        error reply.  ``priority`` names the gateway admission class
        this request rides in (e.g. ``"background"``); unlabeled
        requests take the fleet's default (first-listed) class.
        ``deadline_ms`` is the END-TO-END budget from gateway receipt:
        expired work is shed in the admission queue, failed fast by the
        router, and cancelled inside the replicas (surfacing here as
        :class:`RequestFailed` with kind ``deadline_exceeded``); no
        deadline preserves the flat server-side timeout behavior.
        ``trace`` asks the fleet to retain FULL span detail for this
        request's trace: ``True`` under a gateway-minted id, a string
        to supply the trace id yourself; every request is
        summary-traced regardless, and the reply's ``trace_id`` (also
        set on raised ``Overloaded``/``RequestFailed`` exceptions)
        fetches the waterfall via :meth:`trace` / ``tfserve trace``.
        ``session`` names a multi-turn conversation: on a KV-tiered
        fleet (``tfserve --kv-tier-mb``) the finished request's KV
        parks under the id and a later call whose prompt EXTENDS the
        conversation (prior prompt + returned tokens + the new turn)
        resumes from it — prefilling only the new tail — routed to the
        replica holding the parked state (session affinity).  The
        completion is byte-identical either way; the label is purely a
        latency hint (docs/SERVING.md "KV tiering & sessions").
        ``on_tokens(new_tokens)`` streams the completion INCREMENTALLY:
        called (from the reader thread — do not block) with each fresh
        chunk as the replica's batcher emits it, exactly-once per token
        even across a mid-stream gateway failover; the returned
        completion still carries the full list."""
        msg = {"op": "generate", "prompt": [int(t) for t in prompt],
               "max_new_tokens": int(max_new_tokens),
               "stop_token": stop_token}
        if priority is not None:
            msg["priority"] = str(priority)
        if deadline_ms is not None:
            if not deadline_ms > 0:
                raise ValueError(f"deadline_ms must be > 0, got "
                                 f"{deadline_ms}")
            msg["deadline_ms"] = float(deadline_ms)
        if trace is not None and trace is not False:
            msg["trace"] = str(trace) if isinstance(trace, str) else True
        if session is not None:
            if not isinstance(session, str) or not session:
                raise ValueError(f"session must be a non-empty string, "
                                 f"got {session!r}")
            msg["session"] = session
        if model is not None:
            # Model-catalog label (docs/SERVING.md "Model catalog"):
            # names the catalog entry this request targets; absent
            # rides the fleet's DEFAULT entry, so model-less callers
            # need no change against a catalog fleet.
            if not isinstance(model, str) or not model:
                raise ValueError(f"model must be a non-empty string, "
                                 f"got {model!r}")
            msg["model"] = model

        on_partial = None
        if on_tokens is not None:
            msg["stream"] = True
            # Exactly-once across retries/replays: a replayed request
            # re-streams from offset 0 (deterministic completions), so
            # only tokens past the high-water mark reach the caller.
            seen = [0]
            lock = threading.Lock()

            def on_partial(frame) -> None:
                toks = frame.get("tokens")
                if not isinstance(toks, list) or not toks:
                    return
                off = frame.get("off")
                off = int(off) if isinstance(off, (int, float)) \
                    and not isinstance(off, bool) else 0
                with lock:
                    start = max(0, seen[0] - off)
                    new = toks[start:]
                    if not new:
                        return
                    seen[0] = max(seen[0], off + len(toks))
                    # Deliver INSIDE the lock: it is this stream's own
                    # lock (never contended across requests), and
                    # releasing first would let a failover's new reader
                    # overtake a preempted old one — out-of-order
                    # chunks at the caller.
                    on_tokens([int(t) for t in new])

        timeout = timeout if timeout is not None else self.timeout
        reply = None
        for attempt in range(self.max_failovers + 1):
            mux = self._connection()
            try:
                reply = mux.call(msg, timeout=timeout,
                                 on_partial=on_partial)
                break
            except ConnectionLost as e:
                # The gateway died with this call in flight (or before
                # it could be sent).  generate is idempotent — nothing
                # was delivered, completions are deterministic, and
                # streamed tokens de-dup by offset — so REPLAY it on a
                # surviving gateway.  A deliberate client close() is
                # NOT a gateway death: never replay a cancelled call.
                if self._closed:
                    raise
                self._drop(mux)
                if attempt >= self.max_failovers:
                    raise
                self.log.warning(
                    "gateway %s lost mid-request (%s); failing over "
                    "(attempt %d/%d)", mux.addr, e, attempt + 1,
                    self.max_failovers)
                self._refresh_gateways()
        if isinstance(reply, dict) and reply.get("op") == "completion":
            if on_partial is not None:
                # The final completion carries the FULL token list;
                # feeding it through the same offset de-dup emits
                # exactly the not-yet-streamed tail (a row that
                # finishes inside a decode block streams its last
                # chunk only here — and an old non-streaming replica
                # degenerates to one on_tokens call with everything).
                on_partial({"tokens": reply.get("tokens") or [],
                            "off": 0})
            return reply
        kind = reply.get("kind", "error") if isinstance(reply, dict) else "error"
        error = reply.get("error", repr(reply)) if isinstance(reply, dict) \
            else repr(reply)
        tid = reply.get("trace_id") if isinstance(reply, dict) else None
        if kind == "rate_limited":
            exc: Exception = RateLimited(error)
        elif kind == "overloaded":
            exc = Overloaded(error)
        else:
            exc = RequestFailed(error, kind=kind)
        exc.trace_id = tid
        raise exc

    def trace(self, trace_id: Optional[str] = None,
              slowest: Optional[int] = None, failed: bool = False,
              limit: int = 20, timeout: float = 10.0) -> list:
        """Fetch trace records from the gateway's book: one by id (full
        waterfall), the N ``slowest``, the newest ``failed``, or the
        recent summaries (docs/SERVING.md "Observability")."""
        msg: Dict[str, Any] = {"op": "trace", "limit": int(limit)}
        if trace_id:
            msg["trace_id"] = str(trace_id)
        elif slowest:
            msg["slowest"] = int(slowest)
        elif failed:
            msg["failed"] = True
        reply = self._connection().call(msg, timeout=timeout)
        if isinstance(reply, dict):
            return reply.get("traces") or []
        return []

    def metrics(self, timeout: float = 10.0) -> Dict[str, Any]:
        """The gateway's live metrics snapshot."""
        reply = self._connection().call({"op": "metrics"},
                                        timeout=timeout)
        return reply.get("snapshot", {})

    def rollout(self, weights_version: str,
                timeout: float = 900.0) -> Dict[str, Any]:
        """Drive a blue-green weight rollout through the gateway's
        control op and block until it completes (a rollout spans a full
        tier's warmup plus the old tier's drain — size ``timeout``
        accordingly).  Returns the gateway's summary dict; raises
        :class:`RequestFailed` (kind ``rollout_failed``) on abort.
        NEVER replayed on failover: a rollout is not idempotent (the
        second attempt would race the first's drains)."""
        reply = self._connection().call(
            {"op": "rollout", "weights_version": str(weights_version)},
            timeout=timeout)
        if isinstance(reply, dict) and reply.get("op") == "rollout":
            return reply
        kind = reply.get("kind", "error") if isinstance(reply, dict) \
            else "error"
        error = reply.get("error", repr(reply)) if isinstance(reply, dict) \
            else repr(reply)
        raise RequestFailed(error, kind=kind)

    def swap_adapter(self, model_id: str, adapter_version: str,
                     delta: Dict[str, Any],
                     timeout: float = 900.0) -> Dict[str, Any]:
        """Hot-swap a LoRA-style weight delta onto every replica of
        one catalog model through the gateway's control op and block
        until every replica has folded it (in-flight requests finish
        on the old delta first — size ``timeout`` for a generation's
        tail).  ``delta`` maps param paths to numpy arrays; it ships
        base64 to the gateway and as raw HMAC frames to the replicas.
        NEVER replayed on failover (like rollout — the second attempt
        would race the first's folds)."""
        from tfmesos_tpu_torch.fleet.catalog import encode_adapter_fields

        reply = self._connection().call(
            {"op": "swap_adapter", "model_id": str(model_id),
             "adapter_version": str(adapter_version),
             "delta": encode_adapter_fields(delta)},
            timeout=timeout)
        if isinstance(reply, dict) and reply.get("op") == "swap_adapter":
            return reply
        kind = reply.get("kind", "error") if isinstance(reply, dict) \
            else "error"
        error = reply.get("error", repr(reply)) \
            if isinstance(reply, dict) else repr(reply)
        raise RequestFailed(error, kind=kind)

    @property
    def outstanding(self) -> int:
        with self._mlock:
            mux = self._mux
        return mux.outstanding if mux is not None else 0

    def close(self) -> None:
        """Terminal: in-flight calls fail with ConnectionLost (never
        replayed — a cancelled call must not resurrect the
        connection), and later calls raise instead of re-dialing."""
        with self._mlock:
            self._closed = True
            mux = self._mux
            self._mux = None
        if mux is not None:
            mux.close()

    def __enter__(self) -> "FleetClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
