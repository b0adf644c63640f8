"""Authenticated control-plane wire protocol (port of
``tfmesos_tpu/wire.py:1-475``: the frames, the token contract and the
blocking socket helpers; the event-loop ``WireConn`` / ``WireServer``
that serve the gateway and the registry come with the port's launcher).

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
import socket
import struct
import weakref
from typing import Any, List, Optional

__all__ = ["WireError", "RawFrame", "MAX_FRAME", "MAX_RAW_FRAME",
           "MAX_RAW_META", "new_token", "load_token", "encode", "send_msg",
           "encode_raw", "send_raw_msg", "recv_msg", "Framer", "iter_msgs",
           "connect", "bind_ephemeral", "wake_listener", "shutdown_socket",
           "sock_addr", "tag_socket"]

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


# Socket identity tags: a dialer acting for a named endpoint (a direct KV
# push) tags its socket with that endpoint's advertised addr, for fault
# injection to match peer pairs by (``tfmesos_tpu/chaos.py``'s partition
# faults; not ported yet).  Sockets take no new attributes, hence the
# side table; weak keys let closed sockets vanish.
_sock_idents: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def tag_socket(sock, ident: str) -> None:
    """Record that ``sock`` speaks for the endpoint ``ident``
    (``host:port``); objects without weakref support are ignored."""
    try:
        _sock_idents[sock] = str(ident)
    except TypeError:
        pass


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
    sock.sendall(encode(obj, token))


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
    propagate."""
    while True:
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
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except (OSError, AttributeError):
        pass
    return sock


def bind_ephemeral(host: str = "0.0.0.0", port: int = 0) -> socket.socket:
    """A listening socket on ``port`` (0: one the OS assigns)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
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
