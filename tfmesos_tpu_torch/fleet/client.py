"""Multiplexed request/reply over the authenticated wire (port of
``tfmesos_tpu/fleet/client.py:48-268``, with ``Overloaded`` and
``RateLimited`` from ``fleet/admission.py``; the gateway-side
``FleetClient`` comes with the port's gateway).

One persistent connection carries many in-flight calls, matched by a
connection-local ``id`` the caller assigns: the router's link to a
replica.  A reply stream may interleave PARTIAL frames
(``{"op": "tokens", "id", "off", "tokens"}``) before the final reply;
they go to the call's ``on_partial`` callback without resolving it.

When the peer closes or the socket fails, every pending call fails at
once with :class:`ConnectionLost`; a reader-thread death that is not a
transport failure fails them with :class:`ReaderDied`.  Nothing waits
out a timeout for a reply nobody can deliver.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from tfmesos_tpu_torch import wire

__all__ = ["ConnectionLost", "ReaderDied", "CallTimeout", "RequestFailed",
           "Overloaded", "RateLimited", "MuxConnection"]


class Overloaded(Exception):
    """Explicit shed: the ingress queue is at its bound."""

    kind = "overloaded"


class RateLimited(Overloaded):
    """Explicit shed: the token bucket is empty."""

    kind = "rate_limited"


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
