"""Authenticated control-plane wire protocol (port of
``tfmesos_tpu/wire.py``: the frames, the token contract, the blocking
socket helpers and the event-loop ``WireConn`` / ``WireServer`` that
serve the gateway and the registry, with the ingress listeners the
HTTP/SSE edge rides).

Frames are byte-compatible with the JAX package's both ways, so a port
replica sits behind the JAX registry, router and gateway unchanged.

JSON frame::

    +----------------+----------------------+------------------+
    | 4B len (BE)    | 32B HMAC-SHA256 tag  | JSON body (UTF8) |
    +----------------+----------------------+------------------+

``len`` counts tag + body; with an empty ``token`` the tag is computed
with the empty key, so the layout never changes.

RAW frames carry multi-MB KV payloads (the disaggregated handoff and
drain migration) without a text encoding: the length prefix's top bit
marks the frame raw (JSON frames cap at ``MAX_FRAME`` = 64 MiB, so the
bit is never set on one), and the payload is::

    +----------------------+--------------+-----------+------+
    | 32B HMAC-SHA256 tag  | 4B meta len  | JSON meta | body |
    +----------------------+--------------+-----------+------+

The tag covers everything after it and is checked before the meta is
decoded.  The meta is JSON, never pickle: a token holder gains request
injection at most, not code execution.  Raw decoding is opt-in per
stream (``Framer(allow_raw=True)`` / ``recv_msg(allow_raw=True)``):
only links that carry KV payloads widen their pre-auth buffering bound
from ``MAX_FRAME`` to ``MAX_RAW_FRAME`` (1 GiB); every other stream
rejects the raw bit at the 4-byte prefix.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import selectors
import socket
import struct
import threading
import time
import weakref
from typing import Any, Callable, List, Optional

__all__ = ["WireError", "RawFrame", "MAX_FRAME", "MAX_RAW_FRAME",
           "MAX_RAW_META", "new_token", "load_token", "encode", "send_msg",
           "encode_raw", "send_raw_msg", "recv_msg", "Framer", "iter_msgs",
           "connect", "bind_ephemeral", "wake_listener", "shutdown_socket",
           "sock_addr", "tag_socket", "sock_ident", "set_chaos",
           "reuseport_available", "WireConn", "WireServer"]

_LEN = struct.Struct(">I")
TAG_SIZE = hashlib.sha256().digest_size  # 32
MAX_FRAME = 64 * 1024 * 1024  # sanity bound; control messages are tiny
# Raw (binary) frames: top bit of the length prefix set; bound sized for
# KV-page payloads.
RAW_FLAG = 0x80000000
MAX_RAW_FRAME = 1 << 30  # 1 GiB
MAX_RAW_META = 1 << 20   # JSON metadata is a small dict

TOKEN_ENV = "TPUMESOS_TOKEN"
TOKEN_FILE_ENV = "TPUMESOS_TOKEN_FILE"


class WireError(Exception):
    """Malformed, oversized, or unauthenticated frame."""


class RawFrame:
    """A decoded raw binary frame: a small JSON ``meta`` (in practice a
    dict with ``op``/``id`` like the JSON messages) plus a zero-copy
    ``body`` (bytes).  An ``allow_raw`` reader yields one wherever a
    JSON message could appear, so both kinds interleave on one
    authenticated stream."""

    __slots__ = ("meta", "body")

    def __init__(self, meta: Any, body: bytes):
        self.meta = meta
        self.body = body

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"RawFrame(meta={self.meta!r}, body=<{len(self.body)}B>)"


# Fault-injection hooks: consulted per framed send/recv when set, so a
# test can sever, delay, truncate or drop traffic on a live connection.
# ``None`` (the default) costs one attribute load per message.
_chaos_send = None      # Optional[Callable[[socket, bytes], bool]]
_chaos_recv = None      # Optional[Callable[[socket], None]]


def set_chaos(send=None, recv=None) -> None:
    """Install (or clear, with Nones) the process-global wire fault hooks.

    ``send(sock, frame) -> bool`` runs before every framed send — it may
    sleep (delay), raise OSError after closing the socket (sever), write
    a partial frame then raise (truncate), or return True to swallow the
    frame (drop).  ``recv(sock)`` runs before every blocking read and
    may sleep or sever."""
    global _chaos_send, _chaos_recv
    _chaos_send = send
    _chaos_recv = recv


# Socket identity tags: a dialer acting for a named endpoint (a direct KV
# push) tags its socket with that endpoint's advertised addr, so the
# fault hooks can match "frames between peers A and B" without the
# ephemeral local port lying about who is talking.  Sockets take no new
# attributes, hence the side table; weak keys let closed sockets vanish.
_sock_idents: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def tag_socket(sock, ident: str) -> None:
    """Record that ``sock`` speaks for the endpoint ``ident``
    (``host:port``); objects without weakref support are ignored."""
    try:
        _sock_idents[sock] = str(ident)
    except TypeError:
        pass


def sock_ident(sock) -> Optional[str]:
    """The advertised endpoint ``sock`` was tagged with, or None."""
    try:
        return _sock_idents.get(sock)
    except TypeError:
        return None


def new_token() -> str:
    """Fresh per-cluster auth token."""
    return os.urandom(16).hex()


def load_token(environ=os.environ) -> str:
    """The cluster token a task was launched with: the mode-0600 file
    named by ``TPUMESOS_TOKEN_FILE`` first (env vars leak through process
    listings), else ``TPUMESOS_TOKEN``, else empty."""
    path = environ.get(TOKEN_FILE_ENV)
    if path:
        with open(path, "r", encoding="utf-8") as f:
            return f.read().strip()
    return environ.get(TOKEN_ENV, "")


def _tag(token: str, body) -> bytes:
    return hmac.new(token.encode("utf-8"), body, hashlib.sha256).digest()


def encode(obj: Any, token: str = "") -> bytes:
    body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    return _LEN.pack(TAG_SIZE + len(body)) + _tag(token, body) + body


def _decode_body(payload: bytes, token: str) -> Any:
    if len(payload) < TAG_SIZE:
        raise WireError("frame shorter than auth tag")
    tag, body = payload[:TAG_SIZE], payload[TAG_SIZE:]
    if not hmac.compare_digest(tag, _tag(token, body)):
        raise WireError("bad auth tag")
    try:
        return json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"bad JSON body: {e}") from e


def send_msg(sock: socket.socket, obj: Any, token: str = "") -> None:
    data = encode(obj, token)
    hook = _chaos_send      # snapshot against a concurrent uninstall
    if hook is not None and hook(sock, data):
        return              # frame swallowed (chaos drop)
    sock.sendall(data)


def _decode_raw(payload: bytes, token: str) -> RawFrame:
    if len(payload) < TAG_SIZE + _LEN.size:
        raise WireError("raw frame shorter than tag + meta length")
    tag, rest = payload[:TAG_SIZE], memoryview(payload)[TAG_SIZE:]
    if not hmac.compare_digest(tag, _tag(token, rest)):
        raise WireError("bad auth tag on raw frame")
    (meta_len,) = _LEN.unpack(rest[:_LEN.size])
    if meta_len > MAX_RAW_META or _LEN.size + meta_len > len(rest):
        raise WireError(f"bad raw meta length {meta_len}")
    try:
        meta = json.loads(
            bytes(rest[_LEN.size:_LEN.size + meta_len]).decode("utf-8"))
    except Exception as e:
        raise WireError(f"bad raw meta: {e!r}") from e
    return RawFrame(meta, bytes(rest[_LEN.size + meta_len:]))


def encode_raw(meta: Any, body, token: str = "") -> bytes:
    """One raw frame as contiguous bytes (tests; the hot path is
    :func:`send_raw_msg`, which never concatenates the body)."""
    header, mv = _raw_parts(meta, body, token)
    return header + bytes(mv)


def _raw_parts(meta: Any, body, token: str):
    """(header bytes, body memoryview) of one raw frame."""
    meta_b = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    if len(meta_b) > MAX_RAW_META:
        raise WireError(f"raw meta of {len(meta_b)} bytes exceeds limit")
    mv = memoryview(body).cast("B") if not isinstance(body, bytes) \
        else memoryview(body)
    length = TAG_SIZE + _LEN.size + len(meta_b) + len(mv)
    if length > MAX_RAW_FRAME:
        raise WireError(f"raw frame of {length} bytes exceeds limit")
    ml = _LEN.pack(len(meta_b))
    mac = hmac.new(token.encode("utf-8"), ml, hashlib.sha256)
    mac.update(meta_b)
    mac.update(mv)
    header = _LEN.pack(RAW_FLAG | length) + mac.digest() + ml + meta_b
    return header, mv


def send_raw_msg(sock: socket.socket, meta: Any, body,
                 token: str = "") -> None:
    """Send one raw frame: ``meta`` (a JSON-encodable header) and
    ``body`` (bytes or any buffer), the body written to the socket
    straight from the caller's buffer."""
    header, mv = _raw_parts(meta, body, token)
    hook = _chaos_send      # snapshot against a concurrent uninstall
    if hook is not None:
        data = header + bytes(mv)   # fault-injection path: copies are fine
        if hook(sock, data):
            return
        sock.sendall(data)
        return
    sock.sendall(header)
    sock.sendall(mv)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise WireError("connection closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket, token: str = "",
             allow_raw: bool = False) -> Any:
    """Next message: a decoded JSON object, or (with ``allow_raw``) a
    :class:`RawFrame`."""
    hook = _chaos_recv      # snapshot against a concurrent uninstall
    if hook is not None:
        hook(sock)
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if length & RAW_FLAG:
        if not allow_raw:
            raise WireError("raw frame not accepted on this stream")
        length &= ~RAW_FLAG
        if length > MAX_RAW_FRAME:
            raise WireError(f"raw frame of {length} bytes exceeds limit")
        return _decode_raw(_recv_exact(sock, length), token)
    if length > MAX_FRAME:
        raise WireError(f"frame of {length} bytes exceeds limit")
    return _decode_body(_recv_exact(sock, length), token)


class Framer:
    """Incremental decoder: feed bytes in, take complete decoded
    messages out.  ``allow_raw`` opts the stream into raw frames (only
    links that carry KV payloads: the replica listener, mux links)."""

    def __init__(self, token: str = "", allow_raw: bool = False) -> None:
        self._token = token
        self._buf = bytearray()
        self._allow_raw = allow_raw

    def feed(self, data: bytes) -> List[Any]:
        self._buf.extend(data)
        out = []
        while len(self._buf) >= _LEN.size:
            (length,) = _LEN.unpack(bytes(self._buf[:_LEN.size]))
            raw = bool(length & RAW_FLAG)
            if raw:
                if not self._allow_raw:
                    raise WireError("raw frame not accepted on this "
                                    "stream")
                length &= ~RAW_FLAG
                if length > MAX_RAW_FRAME:
                    raise WireError(f"raw frame of {length} bytes "
                                    f"exceeds limit")
            elif length > MAX_FRAME:
                raise WireError(f"frame of {length} bytes exceeds limit")
            end = _LEN.size + length
            if len(self._buf) < end:
                break
            payload = bytes(self._buf[_LEN.size:end])
            del self._buf[:end]
            out.append(_decode_raw(payload, self._token) if raw
                       else _decode_body(payload, self._token))
        return out


def iter_msgs(sock: socket.socket, framer: Framer):
    """Decoded messages from a blocking socket until EOF ends the
    generator; a bad frame raises :class:`WireError`, socket errors
    propagate.  The fault hook runs before every blocking read, so a test
    can sever or delay the fleet's long-lived links mid-stream."""
    while True:
        hook = _chaos_recv  # snapshot against a concurrent uninstall
        if hook is not None:
            hook(sock)
        data = sock.recv(65536)
        if not data:
            return
        yield from framer.feed(data)


def connect(addr: str, timeout: Optional[float] = 30.0) -> socket.socket:
    """Dial a ``host:port`` string, Nagle off (every exchange is a small
    request waiting on a small reply)."""
    host, port = addr.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)), timeout=timeout)
    sock.settimeout(timeout)
    _nodelay(sock)
    return sock


def _nodelay(sock: socket.socket) -> None:
    """Nagle off: every exchange is a small framed request waiting on a
    small framed reply, where Nagle plus the peer's delayed ACK stalls
    each round trip ~40 ms.  A transport without the option skips it."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except (OSError, AttributeError):
        pass


def reuseport_available() -> bool:
    """Whether this platform has ``SO_REUSEPORT`` (N processes sharing
    one listening port)."""
    return hasattr(socket, "SO_REUSEPORT")


def bind_ephemeral(host: str = "0.0.0.0", port: int = 0,
                   reuseport: bool = False) -> socket.socket:
    """A listening socket on ``port`` (0: one the OS assigns).
    ``reuseport`` also sets ``SO_REUSEPORT`` (raises ``OSError`` where
    the platform lacks it)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    if reuseport:
        if not reuseport_available():
            sock.close()
            raise OSError("SO_REUSEPORT is not available on this platform")
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    sock.bind((host, port))
    sock.listen(128)
    return sock


def wake_listener(sock: Optional[socket.socket]) -> None:
    """Wake a thread blocked in ``accept()`` on this listening socket:
    ``close()`` alone leaves the syscall parked until the next real
    connection, so a throwaway self-connection makes it return.  Call
    after setting the stop flag and before closing the socket."""
    if sock is None:
        return
    try:
        host, port = sock.getsockname()[:2]
        if host == "0.0.0.0":
            host = "127.0.0.1"
        elif host == "::":
            host = "::1"
        socket.create_connection((host, port), timeout=0.5).close()
    except OSError:
        pass


def shutdown_socket(sock: Optional[socket.socket]) -> None:
    """End a connection another thread may be blocked reading:
    ``close()`` alone neither wakes that ``recv`` nor sends the peer its
    FIN, ``shutdown(SHUT_RDWR)`` does both.  Call before ``close()``."""
    if sock is None:
        return
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass


def sock_addr(sock: socket.socket, advertise_host: Optional[str] = None
              ) -> str:
    host, port = sock.getsockname()[:2]
    if advertise_host:
        host = advertise_host
    elif host in ("0.0.0.0", "::"):
        host = socket.gethostbyname(socket.gethostname())
    return f"{host}:{port}"


# -- the event-loop serve core ----------------------------------------------
#
# WireServer multiplexes every connection of one listener onto a single
# selector-driven thread: the Framer parses incrementally, so reads are
# non-blocking feeds, writes are buffered and flushed as the socket
# drains, and the HMAC / raw-bit / pre-auth-bound discipline is the
# Framer's.  The blocking connect/send_msg/recv_msg client API stays for
# low-fanout links (scheduler rendezvous, heartbeats, mux links to
# replicas); the listeners that must scale (gateway, registry) ride this.


class WireConn:
    """One accepted connection on a :class:`WireServer`.

    ``send``/``send_raw`` may be called from any thread: frames append
    to a per-connection write buffer and the event loop flushes them as
    the socket drains, so a slow reader never blocks the caller or the
    loop; past ``max_buffer`` of backlog the connection is dropped
    instead (a peer that cannot keep up with its own replies is as good
    as gone).  Handlers may stash per-connection state as plain
    attributes (the registry keys heartbeat EOFs that way).

    A connection accepted on an ingress listener (``add_ingress``)
    carries a ``protocol`` object instead of the HMAC framer: raw socket
    bytes go to ``protocol.data_received(data)`` (an exception drops the
    connection), replies go out through ``send_bytes``, and on drop or
    close the protocol's own ``on_close()`` fires instead of the
    server's ``on_close`` hook (an ingress peer is never taken for a
    wire peer: the registry keys replica EOFs off that hook).
    ``deadline`` (a monotonic timestamp, tracked through
    ``server._watch``) is the slow-loris bound: a connection past it is
    swept closed by the loop."""

    def __init__(self, server: "WireServer", sock: socket.socket,
                 peer: str):
        self._server = server
        self._sock = sock
        self.peer = peer
        self._framer = Framer(server.token, allow_raw=server.allow_raw)
        self._out = bytearray()
        self._wlock = threading.Lock()
        self._closed = False
        self._close_after_flush = False
        self._events = selectors.EVENT_READ
        self.drop_reason: Optional[str] = None
        self.protocol: Optional[Any] = None
        self.deadline: Optional[float] = None

    @property
    def closed(self) -> bool:
        return self._closed

    def send(self, obj: Any) -> bool:
        """Queue one JSON frame; False when the connection is (being)
        dropped.  Best-effort: a vanished client is not an error the
        serving path cares about."""
        return self._enqueue(encode(obj, self._server.token))

    def send_raw(self, meta: Any, body) -> bool:
        """Queue one raw binary frame (meta + body, HMAC-tagged)."""
        header, mv = _raw_parts(meta, body, self._server.token)
        return self._enqueue(header + bytes(mv))

    def send_bytes(self, data: bytes) -> bool:
        """Queue bytes verbatim (no framing, no HMAC): the reply path of
        an ingress protocol (HTTP responses, SSE frames), with the same
        buffering and overflow rule as ``send``."""
        return self._enqueue(bytes(data))

    def _enqueue(self, frame: bytes) -> bool:
        hook = _chaos_send      # snapshot against a concurrent uninstall
        if hook is not None:
            try:
                if hook(self._sock, frame):
                    return True         # chaos drop: frame swallowed
            except OSError:
                self._server._request_close(self)   # chaos sever
                return False
        with self._wlock:
            if self._closed:
                return False
            self._out += frame
            over = len(self._out) > self._server.max_buffer
        if over:
            self.drop_reason = "write-buffer overflow (slow reader)"
            self._server._request_close(self)
            return False
        self._server._mark_writable(self)
        return True

    def close(self) -> None:
        """Flush whatever is already queued, then close (thread-safe)."""
        self._close_after_flush = True
        self._server._mark_writable(self)


class WireServer:
    """A selector-driven accept/read/dispatch/write loop over one
    listening socket: the serve-side core of the fleet gateway and the
    replica registry.

    ``handler(conn, msg)`` runs on the loop thread for every decoded
    message (a dict, or a :class:`RawFrame` when ``allow_raw``) and must
    not block: hand real work to a pool and reply later via
    ``conn.send`` (thread-safe, buffered).  A handler exception, a bad
    frame (HMAC failure, oversized length, the raw bit on a stream that
    did not opt in — the Framer's pre-auth bounds) or a write-buffer
    overflow drops that connection and nothing else.  ``on_close(conn)``
    fires once per dropped or closed connection (not at server stop).

    The fault hooks (:func:`set_chaos`) are consulted as on the blocking
    path: the send hook per queued frame, the recv hook per read batch.

    ``stop()`` wakes the loop through a self-pipe; :func:`wake_listener`
    on the listening socket also unblocks it (the poke lands as an
    accept event)."""

    def __init__(self, handler: Callable[[WireConn, Any], None],
                 token: str = "", host: str = "127.0.0.1", port: int = 0,
                 allow_raw: bool = False, name: str = "wire-server",
                 max_buffer: int = 64 * 1024 * 1024,
                 on_close: Optional[Callable[[WireConn], None]] = None,
                 advertise_host: Optional[str] = None,
                 reuseport: bool = False):
        self.handler = handler
        self.token = token
        self.host = host
        self.port = int(port)
        self.allow_raw = bool(allow_raw)
        self.name = name
        self.max_buffer = int(max_buffer)
        self.on_close = on_close
        self.advertise_host = advertise_host
        self.reuseport = bool(reuseport)
        self.addr: Optional[str] = None
        self._listen: Optional[socket.socket] = None
        self._sel: Optional[selectors.BaseSelector] = None
        self._waker_r: Optional[socket.socket] = None
        self._waker_w: Optional[socket.socket] = None
        self._conns: set = set()
        self._pending: set = set()          # conns with queued writes
        self._pending_close: set = set()
        self._plock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Ingress listeners: (factory, host, port) asked for before
        # start(); their sockets and addresses are filled in by start().
        self._ingress: List[tuple] = []
        self._ingress_socks: List[socket.socket] = []
        self.ingress_addrs: List[str] = []
        # Connections with a live slow-loris deadline (loop thread only).
        self._timed: set = set()
        from tfmesos_tpu_torch.utils.logging import get_logger
        self.log = get_logger("tfmesos_tpu_torch.wire")

    def add_ingress(self, factory: Callable[[WireConn], Any],
                    host: str = "127.0.0.1", port: int = 0) -> None:
        """Add a listener on the same event loop whose connections speak
        a protocol of the caller's instead of the HMAC framing (the
        HTTP/SSE edge).  ``factory(conn)`` runs at each accept and
        returns the protocol object: raw bytes go to
        ``protocol.data_received(data)`` (raise to drop the connection),
        replies ride ``conn.send_bytes``, and ``protocol.on_close()``
        (optional) fires when the connection dies.  Call before
        ``start()``."""
        if self._thread is not None:
            raise RuntimeError("add_ingress must precede start()")
        self._ingress.append((factory, host, int(port)))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "WireServer":
        self._listen = bind_ephemeral(self.host, port=self.port,
                                      reuseport=self.reuseport)
        self._listen.setblocking(False)
        adv = self.advertise_host or (
            None if self.host in ("0.0.0.0", "::") else self.host)
        self.addr = sock_addr(self._listen, advertise_host=adv)
        self._sel = selectors.DefaultSelector()
        self._waker_r, self._waker_w = socket.socketpair()
        self._waker_r.setblocking(False)
        self._sel.register(self._listen, selectors.EVENT_READ, "listen")
        self._sel.register(self._waker_r, selectors.EVENT_READ, "waker")
        for factory, host, port in self._ingress:
            sock = bind_ephemeral(host, port=port)
            sock.setblocking(False)
            self._ingress_socks.append(sock)
            self.ingress_addrs.append(sock_addr(
                sock, advertise_host=adv if host in ("0.0.0.0", "::")
                else host))
            self._sel.register(sock, selectors.EVENT_READ,
                               ("ingress", sock, factory))
        self._thread = threading.Thread(target=self._loop, name=self.name,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the loop and close every connection.  Abrupt by design:
        peers see the close, in-flight replies may be cut."""
        self._stop.set()
        self._wake()
        # The waker is the fast path; the accept poke is the one that
        # must keep working whatever happens to it.
        wake_listener(self._listen)
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def connections(self) -> List[WireConn]:
        with self._plock:
            return list(self._conns)

    # -- cross-thread signaling --------------------------------------------

    def _wake(self) -> None:
        w = self._waker_w
        if w is None:
            return
        try:
            w.send(b"\0")
        except OSError:
            pass

    def _mark_writable(self, conn: WireConn) -> None:
        with self._plock:
            self._pending.add(conn)
        self._wake()

    def _request_close(self, conn: WireConn) -> None:
        with self._plock:
            self._pending_close.add(conn)
        self._wake()

    def _watch(self, conn: WireConn) -> None:
        """Track ``conn`` in the deadline sweep.  Thread-safe: a
        keep-alive response that finishes on a gateway worker re-arms
        the idle deadline from there.  The wake matters: with no timed
        connection the loop waits on a 5 s backstop, far past the idle
        deadline it must now keep."""
        with self._plock:
            self._timed.add(conn)
        self._wake()

    def _sweep_timed(self) -> None:
        if not self._timed:
            return
        now = time.monotonic()
        with self._plock:
            timed = list(self._timed)
        for conn in timed:
            if conn._closed or conn.deadline is None:
                self._timed.discard(conn)
            elif now > conn.deadline:
                self._timed.discard(conn)
                self._close_conn(conn, "ingress deadline (slow peer)")

    # -- the loop ----------------------------------------------------------

    def _loop(self) -> None:
        sel = self._sel
        try:
            while not self._stop.is_set():
                # The waker (and wake_listener's accept poke) end the
                # wait; the timeout is only the backstop, shortened while
                # ingress connections carry slow-loris deadlines.
                timeout = 0.25 if self._timed else 5.0
                for key, mask in sel.select(timeout=timeout):
                    tag = key.data
                    if tag == "listen":
                        self._accept_ready()
                    elif isinstance(tag, tuple) and tag[0] == "ingress":
                        self._accept_ready(listen=tag[1], factory=tag[2])
                    elif tag == "waker":
                        try:
                            while self._waker_r.recv(4096):
                                pass
                        except OSError:
                            pass
                    else:
                        if mask & selectors.EVENT_READ:
                            self._read_ready(tag)
                        if mask & selectors.EVENT_WRITE \
                                and not tag._closed:
                            self._flush(tag)
                self._service_pending()
                self._sweep_timed()
        finally:
            with self._plock:
                conns = list(self._conns)
                self._conns.clear()
                self._pending.clear()
                self._pending_close.clear()
            for conn in conns:
                with conn._wlock:
                    conn._closed = True
                try:
                    conn._sock.close()
                except OSError:
                    pass
            for sock in ([self._listen, self._waker_r, self._waker_w]
                         + self._ingress_socks):
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
            try:
                sel.close()
            except OSError:
                pass

    def _service_pending(self) -> None:
        with self._plock:
            closes = list(self._pending_close)
            self._pending_close.clear()
            pend = list(self._pending)
            self._pending.clear()
        for conn in closes:
            self._close_conn(conn, conn.drop_reason or "closed")
        for conn in pend:
            if not conn._closed:
                self._flush(conn)

    def _accept_ready(self, listen: Optional[socket.socket] = None,
                      factory: Optional[Callable] = None) -> None:
        listen = listen if listen is not None else self._listen
        while True:
            try:
                sock, peer = listen.accept()
            except BlockingIOError:
                return
            except OSError:
                return              # listener closed (stopping)
            sock.setblocking(False)
            _nodelay(sock)
            conn = WireConn(self, sock, f"{peer[0]}:{peer[1]}"
                            if isinstance(peer, tuple) else str(peer))
            if factory is not None:
                try:
                    conn.protocol = factory(conn)
                except Exception:
                    self.log.exception("%s: ingress factory failed",
                                       self.name)
                    try:
                        sock.close()
                    except OSError:
                        pass
                    continue
            with self._plock:
                self._conns.add(conn)
            try:
                self._sel.register(sock, selectors.EVENT_READ, conn)
            except (ValueError, OSError):
                self._close_conn(conn, "selector register failed")

    def _read_ready(self, conn: WireConn) -> None:
        hook = _chaos_recv      # snapshot against a concurrent uninstall
        if hook is not None:
            try:
                hook(conn._sock)
            except OSError as e:
                self._close_conn(conn, f"chaos: {e}")
                return
        try:
            data = conn._sock.recv(262144)
        except BlockingIOError:
            return
        except OSError as e:
            self._close_conn(conn, str(e))
            return
        if not data:
            self._close_conn(conn, "eof")
            return
        proto = conn.protocol
        if proto is not None:
            # An ingress connection: the protocol parses its own framing
            # under its own byte bounds; raising is its rejection.
            try:
                proto.data_received(data)
            except Exception as e:
                self.log.warning("%s: dropping ingress connection from "
                                 "%s: %s", self.name, conn.peer, e)
                self._close_conn(conn, f"ingress error: {e}")
            return
        try:
            msgs = conn._framer.feed(data)
        except WireError as e:
            # HMAC failure, oversize at the 4-byte prefix, the raw bit
            # on a stream that never opted in: the connection drops and
            # the pre-auth buffering bound holds.
            self.log.warning("%s: dropping connection from %s: %s",
                             self.name, conn.peer, e)
            self._close_conn(conn, f"wire error: {e}")
            return
        for msg in msgs:
            if conn._closed:
                return
            try:
                self.handler(conn, msg)
            except Exception:
                self.log.exception("%s: handler failed; dropping "
                                   "connection from %s", self.name,
                                   conn.peer)
                self._close_conn(conn, "handler error")
                return

    def _flush(self, conn: WireConn) -> None:
        err: Optional[OSError] = None
        with conn._wlock:
            buf = conn._out
            if buf:
                try:
                    n = conn._sock.send(buf)
                    del buf[:n]
                except BlockingIOError:
                    pass
                except OSError as e:
                    err = e
            has_more = bool(buf)
        if err is not None:
            self._close_conn(conn, str(err))
            return
        want = selectors.EVENT_READ | (selectors.EVENT_WRITE
                                       if has_more else 0)
        if want != conn._events:
            try:
                self._sel.modify(conn._sock, want, conn)
                conn._events = want
            except (KeyError, ValueError, OSError):
                pass
        if not has_more and conn._close_after_flush:
            self._close_conn(conn, "closed")

    def _close_conn(self, conn: WireConn, why: str) -> None:
        with conn._wlock:
            if conn._closed:
                return
            conn._closed = True
            conn._out = bytearray()
        try:
            self._sel.unregister(conn._sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn._sock.close()
        except OSError:
            pass
        with self._plock:
            self._conns.discard(conn)
            self._pending.discard(conn)
            self._pending_close.discard(conn)
        self._timed.discard(conn)
        if conn.protocol is not None:
            # Ingress connections tell their own protocol, never the
            # server's hook, which carries wire-peer meaning.
            cb = getattr(conn.protocol, "on_close", None)
            if cb is not None:
                try:
                    cb()
                except Exception:
                    self.log.exception("%s: ingress on_close failed",
                                       self.name)
        elif self.on_close is not None:
            try:
                self.on_close(conn)
            except Exception:
                self.log.exception("%s: on_close callback failed",
                                   self.name)
