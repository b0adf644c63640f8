"""HTTP/1.1 + SSE ingress for the fleet gateway (port of
``tfmesos_tpu/fleet/http.py``; docs/SERVING.md "HTTP/SSE edge").

The wire protocol is the fleet's native tongue, but every standard
load-generation and client tool speaks HTTP.  :class:`HttpIngress` is a
minimal OpenAI-style adapter that rides the SAME ``WireServer`` event
loop as the wire port (``WireServer.add_ingress``): one selector
thread, the same write-buffer backpressure, and the same
slow-loris/byte-bound discipline the wire path enforces pre-auth —
except here the bounds are HTTP-shaped (request-head and body caps,
header/body receive deadlines swept by the loop).

Surface::

    GET  /healthz            -> 200 {"ok": true}
    POST /v1/completions     -> one generation request

The JSON body maps onto the gateway's internal ``generate`` op — the
same admission, WFQ, tracing, routing, and metering path wire clients
take (the adapter IS a gateway client, not a second front door):

- ``prompt``: a list of token ids, or a string (encoded to its UTF-8
  bytes — the demo-model convention; real deployments front a
  tokenizer).
- ``max_tokens`` (or ``max_new_tokens``): decode budget.
- ``stream``: ``true`` answers ``text/event-stream`` SSE frames off the
  exactly-once token relay; ``false``/absent answers one JSON body.
- ``stop_token``, ``model``, ``session``, ``priority``,
  ``deadline_ms``, ``trace``: as in ``FleetClient.generate``.  The
  ``x-model`` / ``x-session`` / ``x-priority`` / ``x-deadline-ms``
  headers are body-absent fallbacks (proxy-injectable routing).

Error mapping: admission/routing error kinds become HTTP statuses
(``overloaded``/``rate_limited`` -> 429 with Retry-After,
``deadline_exceeded`` -> 504, ``unavailable``/``wrong_model`` -> 503,
``bad_request`` -> 400, else 500).  Mid-stream errors arrive as a final
SSE ``error`` event — the status line already went out.

Connections are KEPT ALIVE across requests (HTTP/1.1 default;
HTTP/1.0 opts in with ``Connection: keep-alive``, either side opts out
with ``Connection: close``): after a JSON response the parser re-arms
for the next request head on the same socket, so a load tool's pooled
connection pays the TCP+dial cost once, not per request.  SSE streams
and error responses stay terminal — a stream has no delimiter to
re-sync past, and an error leaves parser state ambiguous.  An idle
keep-alive connection is swept by the same header-deadline discipline
as a fresh one.  A client disconnect mid-stream is observed by the
token relay (``closed`` below) and cancels the replica-side row
through the router's one-way ``cancel`` op — a walked-away user stops
billing and frees pages within a decode tick.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Optional, Tuple

from tfmesos_tpu_torch.utils.logging import get_logger

__all__ = ["HttpIngress", "MAX_HEADER_BYTES", "MAX_BODY_BYTES"]

# Pre-auth byte bounds (the HTTP analog of wire.MAX_FRAME): nothing
# past these ever buffers for an unauthenticated peer.
MAX_HEADER_BYTES = 16 * 1024
MAX_BODY_BYTES = 8 * 1024 * 1024

# Receive deadlines (the slow-loris discipline): a peer that trickles
# its request head/body is swept closed by the event loop.
HEADER_TIMEOUT_S = 10.0
BODY_TIMEOUT_S = 30.0

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 411: "Length Required",
    413: "Payload Too Large", 429: "Too Many Requests",
    431: "Request Header Fields Too Large",
    500: "Internal Server Error", 503: "Service Unavailable",
    504: "Gateway Timeout",
}

# Gateway error ``kind`` -> HTTP status.
_KIND_STATUS = {
    "bad_request": 400,
    "not_found": 404,
    "overloaded": 429,
    "rate_limited": 429,
    "deadline_exceeded": 504,
    "unavailable": 503,
    "wrong_model": 503,
    "internal": 500,
}


def _response_bytes(status: int, body_obj: Any,
                    content_type: str = "application/json",
                    extra: Tuple[Tuple[str, str], ...] = (),
                    keep: bool = False) -> bytes:
    body = json.dumps(body_obj).encode("utf-8")
    head = (f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: {'keep-alive' if keep else 'close'}\r\n"
            + "".join(f"{k}: {v}\r\n" for k, v in extra)
            + "\r\n")
    return head.encode("latin-1") + body


def _sse_event(obj: Any) -> bytes:
    data = obj if isinstance(obj, str) else json.dumps(obj)
    return f"data: {data}\n\n".encode("utf-8")


_SSE_HEAD = (b"HTTP/1.1 200 OK\r\n"
             b"Content-Type: text/event-stream\r\n"
             b"Cache-Control: no-cache\r\n"
             b"Connection: close\r\n\r\n")


class _BadRequest(Exception):
    """Parse-level rejection carrying its HTTP status."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class _HttpReply:
    """Duck-typed stand-in for the gateway's wire-client connection.

    The gateway's handler/worker path only ever calls ``send(dict)``
    and (through the stream relay's cancel probe) reads ``closed`` —
    this shim translates those reply dicts into HTTP bytes on the
    ingress connection: token partials become SSE frames, the final
    completion becomes the JSON body (or the SSE tail + ``[DONE]``),
    errors become statuses.  ``send`` is called from gateway worker
    threads AND the event loop (synchronous admission rejections), so
    it serializes under its own lock; the byte writes ride
    ``WireConn.send_bytes`` which is thread-safe and buffered."""

    def __init__(self, conn, stream: bool, keep: bool = False,
                 on_done=None):
        self._conn = conn
        self.stream = bool(stream)
        # Keep-alive: a non-stream completion re-arms the connection
        # for the next request via ``on_done`` instead of closing.
        self._keep = bool(keep) and not self.stream
        self._on_done = on_done
        self.peer = getattr(conn, "peer", "http")
        self._lock = threading.Lock()
        self._started = False       # SSE status line sent
        self._done = False
        self._sent = 0              # token high-water mark (dedup)

    @property
    def closed(self) -> bool:
        # The stream relay's disconnect probe: True once the HTTP
        # client went away (the loop closed the WireConn) — upstream
        # this cancels the replica-side row.
        return bool(self._conn.closed)

    # -- gateway-facing ----------------------------------------------------

    def send(self, obj: Any) -> bool:
        if not isinstance(obj, dict) or self._conn.closed:
            return False
        op = obj.get("op")
        with self._lock:
            if self._done:
                return False
            if op == "tokens":
                return self._tokens(obj)
            if op == "completion":
                return self._completion(obj)
            if op == "error":
                return self._error(obj)
        return False

    # -- internals (all under self._lock) ----------------------------------

    def _new_tokens(self, obj: Dict[str, Any]) -> list:
        toks = obj.get("tokens")
        if not isinstance(toks, list) or not toks:
            return []
        off = obj.get("off")
        off = int(off) if isinstance(off, (int, float)) \
            and not isinstance(off, bool) else 0
        if off + len(toks) <= self._sent:
            return []
        new = toks[max(0, self._sent - off):]
        self._sent = off + len(toks)
        return new

    def _ensure_sse(self) -> None:
        if not self._started:
            self._started = True
            self._conn.send_bytes(_SSE_HEAD)

    def _tokens(self, obj: Dict[str, Any]) -> bool:
        if not self.stream:
            return True             # relay installed only for streams
        new = self._new_tokens(obj)
        if not new:
            return True
        off = self._sent - len(new)
        self._ensure_sse()
        return self._conn.send_bytes(_sse_event(
            {"tokens": [int(t) for t in new], "off": off}))

    def _completion(self, obj: Dict[str, Any]) -> bool:
        self._done = True
        toks = [int(t) for t in (obj.get("tokens") or [])]
        meta = {"ttft_ms": obj.get("ttft_ms"),
                "total_ms": obj.get("total_ms"),
                "trace_id": obj.get("trace_id")}
        if self.stream:
            # The completion carries the FULL list; the high-water
            # dedup emits exactly the not-yet-streamed tail.
            tail = self._new_tokens({"tokens": toks, "off": 0})
            self._ensure_sse()
            if tail:
                self._conn.send_bytes(_sse_event(
                    {"tokens": tail, "off": self._sent - len(tail)}))
            done = dict(meta)
            done["done"] = True
            done["n_tokens"] = len(toks)
            ok = self._conn.send_bytes(_sse_event(done)
                                       + _sse_event("[DONE]"))
        else:
            body = {"object": "completion", "tokens": toks}
            body.update(meta)
            ok = self._conn.send_bytes(
                _response_bytes(200, body, keep=self._keep))
            if ok and self._keep and self._on_done is not None:
                # Connection reuse: hand the socket back to the parser
                # for the next request instead of closing.
                self._on_done()
                return ok
        self._conn.close()
        return ok

    def _error(self, obj: Dict[str, Any]) -> bool:
        self._done = True
        kind = str(obj.get("kind") or "internal")
        status = _KIND_STATUS.get(kind, 500)
        err = {"error": {"type": kind,
                         "message": str(obj.get("error") or kind),
                         "trace_id": obj.get("trace_id")}}
        if self._started:
            # SSE already underway: the status line is history — the
            # error arrives as the stream's terminal event.
            ok = self._conn.send_bytes(_sse_event(err)
                                       + _sse_event("[DONE]"))
        else:
            extra = (("Retry-After", "1"),) if status == 429 else ()
            ok = self._conn.send_bytes(
                _response_bytes(status, err, extra=extra))
        self._conn.close()
        return ok


class HttpIngress:
    """Factory wired into ``WireServer.add_ingress``: one
    :class:`_HttpConn` protocol object per accepted connection,
    dispatching parsed requests into ``gateway.handle_ingress``."""

    def __init__(self, gateway, max_body: int = MAX_BODY_BYTES,
                 max_header: int = MAX_HEADER_BYTES,
                 header_timeout: float = HEADER_TIMEOUT_S,
                 body_timeout: float = BODY_TIMEOUT_S):
        self.gateway = gateway
        self.max_body = int(max_body)
        self.max_header = int(max_header)
        self.header_timeout = float(header_timeout)
        self.body_timeout = float(body_timeout)
        self.log = get_logger("tfmesos_tpu_torch.fleet.http")

    def __call__(self, conn) -> "_HttpConn":
        return _HttpConn(self, conn)


class _HttpConn:
    """Per-connection incremental HTTP/1.1 parser (request head ->
    Content-Length body -> dispatch), KEPT ALIVE across requests: a
    finished JSON response re-arms the parser for the next head on the
    same socket (bytes a pipelining client sent early are held,
    bounded, until then).  Parsing runs on the event-loop thread and —
    for the re-arm after a worker-thread reply — on that worker, so
    every state transition holds ``_plock``.  Rejection is either an
    explicit error response + close, or a raise (the loop drops the
    connection)."""

    def __init__(self, ingress: HttpIngress, conn):
        self.ingress = ingress
        self.conn = conn
        self._buf = bytearray()
        self._state = "head"
        self._need = 0
        self._keep = False          # this request's keep-alive verdict
        self._headers: Dict[str, str] = {}
        self._reply: Optional[_HttpReply] = None
        # RLock: a reply that completes synchronously inside
        # _dispatch (an admission rejection on the loop thread)
        # re-enters through _request_done.
        self._plock = threading.RLock()
        # Slow-loris bound on the request head, swept by the loop.
        conn.deadline = time.monotonic() + ingress.header_timeout
        conn._server._watch(conn)

    # -- WireServer protocol interface -------------------------------------

    def data_received(self, data: bytes) -> None:
        with self._plock:
            self._buf += data
            if self._state == "done":
                # A reply is in flight: hold the pipelined next
                # request (bounded) until _request_done re-arms.
                if len(self._buf) > (self.ingress.max_header
                                     + self.ingress.max_body):
                    self.conn.close()
                return
            self._process()

    def _process(self) -> None:
        """Drive the parse over whatever is buffered (``_plock``
        held).  Loops so a keep-alive healthz — or a pipelined next
        request — completes without waiting for more socket bytes."""
        while True:
            if self._state == "head":
                idx = self._buf.find(b"\r\n\r\n")
                if idx < 0:
                    if len(self._buf) > self.ingress.max_header:
                        self._reject(431,
                                     "request head exceeds "
                                     f"{self.ingress.max_header} bytes")
                    return
                head = bytes(self._buf[:idx])
                del self._buf[:idx + 4]
                try:
                    self._parse_head(head)
                except _BadRequest as e:
                    self._reject(e.status, str(e))
                    return
                continue    # head may have answered and re-armed
            if self._state == "body":
                if len(self._buf) < self._need:
                    return
                # Slice EXACTLY the declared body; trailing bytes are
                # the pipelined next request, not an error.
                body = bytes(self._buf[:self._need])
                del self._buf[:self._need]
                self._state = "done"
                self.conn.deadline = None
                self._dispatch(body)
            return

    def _request_done(self) -> None:
        """A keep-alive response finished (worker thread or loop):
        re-arm for the next request and drain anything pipelined."""
        with self._plock:
            if self.conn.closed or self._state != "done":
                return
            self._next_request()
            self._process()

    def _next_request(self) -> None:
        """Reset per-request parser state (``_plock`` held)."""
        self._state = "head"
        self._need = 0
        self._keep = False
        self._headers = {}
        self._reply = None
        self.conn.deadline = (time.monotonic()
                              + self.ingress.header_timeout)
        self.conn._server._watch(self.conn)

    def on_close(self) -> None:
        # Nothing to release here: the reply shim reads conn.closed,
        # and the stream relay's cancel probe does the row release.
        pass

    # -- parsing -----------------------------------------------------------

    def _parse_head(self, head: bytes) -> None:
        try:
            text = head.decode("latin-1")
        except UnicodeDecodeError:      # pragma: no cover - latin-1 total
            raise _BadRequest(400, "undecodable request head")
        lines = text.split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3 or not parts[0].isalpha() \
                or not parts[1].startswith("/") \
                or parts[2] not in ("HTTP/1.1", "HTTP/1.0"):
            raise _BadRequest(400, f"malformed request line "
                                   f"{lines[0][:80]!r}")
        method, path = parts[0].upper(), parts[1]
        headers: Dict[str, str] = {}
        for ln in lines[1:]:
            if not ln:
                continue
            name, sep, value = ln.partition(":")
            if not sep or not name or name != name.strip() \
                    or any(c in name for c in " \t"):
                raise _BadRequest(400, f"malformed header {ln[:80]!r}")
            headers[name.lower()] = value.strip()
        self._headers = headers
        # Keep-alive verdict: HTTP/1.1 defaults on, HTTP/1.0 defaults
        # off; either side's ``Connection: close`` wins.
        conn_tok = headers.get("connection", "").lower()
        if parts[2] == "HTTP/1.1":
            self._keep = "close" not in conn_tok
        else:
            self._keep = "keep-alive" in conn_tok
        path = path.split("?", 1)[0]
        if path == "/healthz":
            self._respond(200, {"ok": True}, keep=self._keep)
            return
        if path != "/v1/completions":
            raise _BadRequest(404, f"unknown path {path[:80]!r}")
        if method != "POST":
            raise _BadRequest(405, f"{method} not allowed on {path}")
        if "transfer-encoding" in headers:
            raise _BadRequest(400, "chunked bodies are not supported")
        cl = headers.get("content-length")
        if cl is None:
            raise _BadRequest(411, "Content-Length required")
        try:
            need = int(cl)
        except ValueError:
            raise _BadRequest(400, f"bad Content-Length {cl!r}") from None
        if need <= 0:
            raise _BadRequest(400, "empty body")
        if need > self.ingress.max_body:
            # The pre-auth bound: reject on the DECLARED size, before a
            # single body byte buffers.
            raise _BadRequest(413, f"body of {need} bytes exceeds the "
                                   f"{self.ingress.max_body} byte bound")
        self._need = need
        self._state = "body"
        self.conn.deadline = time.monotonic() + self.ingress.body_timeout

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, body: bytes) -> None:
        try:
            obj = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            self._reject(400, "body is not valid JSON")
            return
        if not isinstance(obj, dict):
            self._reject(400, "body must be a JSON object")
            return
        try:
            msg = self._build_generate(obj)
        except _BadRequest as e:
            self._reject(e.status, str(e))
            return
        self._reply = _HttpReply(self.conn, stream=bool(msg.get("stream")),
                                 keep=self._keep,
                                 on_done=self._request_done)
        # Same internal submit path as a wire client's generate: the
        # gateway's admission/tracing/routing/metering see no
        # difference, and every reply rides the shim back out as HTTP.
        self.ingress.gateway.handle_ingress(self._reply, msg)

    def _build_generate(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        h = self._headers
        prompt = obj.get("prompt")
        if isinstance(prompt, str) and prompt:
            prompt = list(prompt.encode("utf-8"))
        if not isinstance(prompt, list) or not prompt:
            raise _BadRequest(400, "prompt must be a non-empty list of "
                                   "token ids or a string")
        try:
            prompt = [int(t) for t in prompt]
        except (TypeError, ValueError):
            raise _BadRequest(400, "prompt tokens must be ints") from None
        mt = obj.get("max_tokens", obj.get("max_new_tokens", 16))
        if not isinstance(mt, int) or isinstance(mt, bool) or mt < 1:
            raise _BadRequest(400, f"max_tokens must be a positive int, "
                                   f"got {mt!r}")
        msg: Dict[str, Any] = {"op": "generate", "id": 1,
                               "prompt": prompt, "max_new_tokens": mt,
                               "stop_token": obj.get("stop_token")}
        if obj.get("stream"):
            msg["stream"] = True
        prio = obj.get("priority", h.get("x-priority"))
        if isinstance(prio, str) and prio:
            msg["priority"] = prio
        dl = obj.get("deadline_ms")
        if dl is None and "x-deadline-ms" in h:
            try:
                dl = float(h["x-deadline-ms"])
            except ValueError:
                dl = None           # a malformed header costs the field
        if isinstance(dl, (int, float)) and not isinstance(dl, bool) \
                and dl > 0:
            msg["deadline_ms"] = float(dl)
        sid = obj.get("session", h.get("x-session"))
        if isinstance(sid, str) and sid:
            msg["session"] = sid
        model = obj.get("model", h.get("x-model"))
        if isinstance(model, str) and model:
            msg["model"] = model
        tr = obj.get("trace")
        if tr:
            msg["trace"] = tr if isinstance(tr, str) else True
        return msg

    # -- responses ---------------------------------------------------------

    def _respond(self, status: int, body_obj: Any,
                 keep: bool = False) -> None:
        """Answer in-parse (``_plock`` held): healthz keeps the
        connection when the client does; rejections always close —
        after a parse error the stream position is ambiguous."""
        if keep:
            if self.conn.send_bytes(
                    _response_bytes(status, body_obj, keep=True)):
                self._state = "done"
                self._next_request()
                return
        self._state = "done"
        self.conn.deadline = None
        self.conn.send_bytes(_response_bytes(status, body_obj))
        self.conn.close()

    def _reject(self, status: int, message: str) -> None:
        self._respond(status, {"error": {"type": "http",
                                         "message": message}})
