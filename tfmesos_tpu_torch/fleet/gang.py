"""Gang replicas: N member processes, ONE routable replica (port of
``tfmesos_tpu/fleet/gang.py``).

``TPUMesosScheduler.add_gang`` places the N member tasks atomically
(all-or-nothing within an offer batch, one launch generation); this
module is the in-process half.  The **leader** (rank 0) owns the fleet
identity — the serve socket, the registry heartbeat, the batcher — and
fans every dispatched ``generate`` to its **members** (ranks 1..N-1)
over the raw-HMAC wire frames; each member executes the request on its
own batcher and acks a token DIGEST the leader verifies, so the
invariant "every gang process derives the same tokens" is checked in
flight (``divergence`` counts the mismatches).

Members MIRROR-execute the full request on an identical batcher build,
exactly as the reference's members do: no mesh and no collective is
involved, and on the card each gang process runs the single-device,
graph-captured batcher.  The wire contract, the placement atomicity,
the fencing and the failure semantics are the reference's, frame for
frame, so a port member joins a JAX leader and the other way round.

Rendezvous goes through the registry, so placement stays atomic (no
leader-must-start-first ordering): every member learns its identity
from the launch env (``TPUMESOS_GANG_ID/SIZE/RANK``, stamped by
``add_gang``), the leader advertises its coordination address in the
``gang`` field of its heartbeats, and members poll the registry's
``gang_lookup`` op until it appears.  Joins are fenced by the exact
``(gang_id, generation)`` pair: gang ids are fresh per launch and the
generation is the launch epoch, so a zombie of a torn-down gang never
joins, and a member that finds a NEWER-generation leader under its gang
id knows it is the zombie and exits.

A member's death is the gang's death: the leader sees the member
connection EOF, flags the gang broken once and exits; the registry
drops it with its heartbeat connection, and the fleet launcher tears
the siblings down and re-forms the whole gang under a fresh id and a
bumped generation.  The leader never serves while forming: it
registers ``warming`` until every member has joined.  Nothing here
touches torch; the ``execute`` callable a member runs is injected (the
replica process wraps its batcher, tests wrap a stub).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

from tfmesos_tpu_torch import wire
from tfmesos_tpu_torch.utils.logging import get_logger

__all__ = ["GANG_ENV_ID", "GANG_ENV_SIZE", "GANG_ENV_RANK",
           "read_gang_env", "token_digest", "GangLeader", "GangMember",
           "leader_handler"]

#: Launch-env contract (stamped per member by ``add_gang`` through the
#: scheduler's per-task env merge; inherited across the Mode-B exec).
GANG_ENV_ID = "TPUMESOS_GANG_ID"
GANG_ENV_SIZE = "TPUMESOS_GANG_SIZE"
GANG_ENV_RANK = "TPUMESOS_GANG_RANK"

#: Leader-side bound on un-verified dispatch records: acks for mids
#: evicted past this are ignored (a suspended/migrated request's
#: mirror ack legitimately never matches a local digest).
MAX_PENDING_DIGESTS = 256


def read_gang_env(environ=None) -> Optional[Tuple[str, int, int]]:
    """The ``(gang_id, size, rank)`` this process was launched into, or
    None for the single-process replica of old.  Malformed values read
    as no gang — a broken env must degrade to the long-standing
    behavior, not crash the replica."""
    environ = os.environ if environ is None else environ
    gid = environ.get(GANG_ENV_ID, "")
    if not gid:
        return None
    try:
        size = int(environ.get(GANG_ENV_SIZE, "0"))
        rank = int(environ.get(GANG_ENV_RANK, "-1"))
    except ValueError:
        return None
    if size < 2 or not 0 <= rank < size:
        return None
    return gid, size, rank


def token_digest(tokens) -> str:
    """Canonical digest of one completion's token stream — what a
    member acks and the leader compares (the in-flight SPMD
    token-identity check): sha256 over each token as 8 little-endian
    signed bytes, the first 16 hex digits."""
    h = hashlib.sha256()
    for t in tokens or ():
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.hexdigest()[:16]


class GangLeader:
    """Rank 0's member-coordination server.

    Owns a :class:`~tfmesos_tpu_torch.wire.WireServer` the members dial;
    accepts ``gang_join`` (fenced by exact ``(gang_id, generation)``),
    fans ``gang_dispatch`` frames to every joined member, and verifies
    ``gang_ack`` digests against the leader's own completions.  A
    member connection EOF marks the gang BROKEN and fires ``on_break``
    once — the leader process exits on it, which is what turns one
    member's death into the gang's death fleet-wide."""

    def __init__(self, gang_id: str, size: int, generation: int = 0,
                 token: str = "", host: str = "127.0.0.1",
                 on_break: Optional[Callable[[int], None]] = None):
        if size < 2:
            raise ValueError(f"a gang needs >= 2 members, got {size}")
        self.gang_id = gang_id
        self.size = int(size)
        self.generation = int(generation)
        self.token = token
        self.host = host
        self.on_break = on_break
        self.log = get_logger("tfmesos_tpu_torch.fleet.gang")
        self.divergence = 0         # digest mismatches observed
        self.dispatches = 0
        self.acks = 0               # member acks of tracked dispatches
        self._server: Optional[wire.WireServer] = None
        self._members: Dict[int, wire.WireConn] = {}
        self._pending: "OrderedDict[Any, dict]" = OrderedDict()
        self._lock = threading.Lock()
        self._formed = threading.Event()
        self._broken = threading.Event()
        self._stopping = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "GangLeader":
        self._server = wire.WireServer(
            self._on_msg, token=self.token, host=self.host,
            allow_raw=True, name="gang-leader",
            on_close=self._on_close).start()
        self.log.info("gang %s leader coordinating on %s (size %d, "
                      "generation %d)", self.gang_id, self._server.addr,
                      self.size, self.generation)
        return self

    def stop(self) -> None:
        self._stopping = True
        if self._server is not None:
            self._server.stop()

    @property
    def coord_addr(self) -> str:
        return self._server.addr if self._server is not None else ""

    @property
    def live(self) -> int:
        """Joined member count + the leader itself — the gang's
        member-liveness number (rides heartbeats into the registry)."""
        with self._lock:
            return 1 + len(self._members)

    @property
    def formed(self) -> bool:
        return self._formed.is_set()

    @property
    def broken(self) -> bool:
        return self._broken.is_set()

    def wait_formed(self, timeout: Optional[float] = None) -> bool:
        """Block until every member has joined (the leader's routable
        gate: it advertises ``warming`` until this returns True)."""
        return self._formed.wait(timeout)

    def gang_info(self) -> Dict[str, Any]:
        """The ``gang`` heartbeat field: identity, size, member
        liveness, and the coordination address ``gang_lookup`` serves
        to booting members."""
        return {"id": self.gang_id, "size": self.size,
                "live": self.live, "coord": self.coord_addr}

    # -- member protocol ---------------------------------------------------

    def _on_msg(self, conn, msg) -> None:
        head = msg.meta if isinstance(msg, wire.RawFrame) else msg
        if not isinstance(head, dict):
            return
        op = head.get("op")
        if op == "gang_join":
            self._join(conn, head)
        elif op == "gang_ack":
            self._ack(head)
        elif op == "ping":
            conn.send({"op": "pong", "id": head.get("id")})

    def _join(self, conn, head) -> None:
        try:
            rank = int(head.get("rank"))
            gen = int(head.get("gen"))
        except (TypeError, ValueError):
            conn.send({"op": "gang_joined", "ok": False,
                       "error": "malformed join"})
            conn.close()
            return
        # The zombie fence: the exact (gang_id, generation) pair must
        # match.  Gang ids are fresh per launch and the generation is
        # the launch epoch, so a straggler of a torn-down gang — or a
        # dispatch meant for another gang on a reused port — can never
        # take a member slot.
        if head.get("gang_id") != self.gang_id or gen != self.generation:
            self.log.warning(
                "gang %s refusing join (gang_id=%r gen=%r, ours gen %d)"
                ": fenced", self.gang_id, head.get("gang_id"), gen,
                self.generation)
            conn.send({"op": "gang_joined", "ok": False,
                       "error": "fenced: wrong gang or generation"})
            conn.close()
            return
        with self._lock:
            if not 1 <= rank < self.size or rank in self._members:
                ok = False
            else:
                self._members[rank] = conn
                conn.gang_rank = rank
                ok = True
                formed = len(self._members) == self.size - 1
        if not ok:
            conn.send({"op": "gang_joined", "ok": False,
                       "error": f"rank {rank} invalid or taken"})
            conn.close()
            return
        conn.send({"op": "gang_joined", "ok": True,
                   "gen": self.generation})
        self.log.info("gang %s member rank %d joined (%d/%d)",
                      self.gang_id, rank, self.live, self.size)
        if formed:
            self._formed.set()

    def _ack(self, head) -> None:
        mid = head.get("id")
        digest = head.get("digest")
        with self._lock:
            rec = self._pending.get(mid)
            if rec is None:
                return
            rec["acks"][head.get("rank")] = digest
            self.acks += 1
            local = rec["local"]
        if local is not None and digest != local:
            self._note_divergence(mid, head.get("rank"), digest, local)

    def _on_close(self, conn) -> None:
        rank = getattr(conn, "gang_rank", None)
        if rank is None:
            return
        with self._lock:
            if self._members.get(rank) is not conn:
                return
            del self._members[rank]
        if self._stopping:
            return
        # A member's death is the gang's death: flag it once and let
        # on_break turn it into a process exit (the registry sees the
        # heartbeat EOF, the scheduler sees the task death, and the
        # fleet re-forms the whole gang).
        first = not self._broken.is_set()
        self._broken.set()
        self.log.warning("gang %s member rank %d lost: gang broken",
                         self.gang_id, rank)
        if first and self.on_break is not None:
            try:
                self.on_break(rank)
            except Exception:
                self.log.exception("on_break callback failed")

    # -- dispatch fan-out --------------------------------------------------

    def dispatch(self, head: Dict[str, Any]) -> None:
        """Fan one plain ``generate`` head to every joined member (the
        raw-HMAC frames the replica links already speak).  Non-blocking:
        sends ride each connection's buffered writer, acks verify
        asynchronously against :meth:`observe_local`."""
        mid = head.get("id")
        with self._lock:
            conns = list(self._members.values())
            self._pending[mid] = {"local": None, "acks": {}}
            while len(self._pending) > MAX_PENDING_DIGESTS:
                self._pending.popitem(last=False)
        self.dispatches += 1
        out = dict(head)
        out["op"] = "gang_dispatch"
        for conn in conns:
            conn.send(out)

    def observe_local(self, mid, tokens) -> None:
        """Record the leader's own completion for ``mid`` and verify
        any member acks already in."""
        local = token_digest(tokens)
        stale = []
        with self._lock:
            rec = self._pending.get(mid)
            if rec is None:
                return
            rec["local"] = local
            stale = [(r, d) for r, d in rec["acks"].items()
                     if d != local]
        for rank, digest in stale:
            self._note_divergence(mid, rank, digest, local)

    def _note_divergence(self, mid, rank, digest, local) -> None:
        self.divergence += 1
        self.log.error(
            "gang %s TOKEN DIVERGENCE on request %r: member rank %s "
            "digest %s != leader %s (SPMD invariant violated)",
            self.gang_id, mid, rank, digest, local)


class GangMember:
    """Rank 1..N-1's whole life: find the leader through the registry,
    join (fenced), mirror-execute dispatches, ack digests, die with
    the leader.

    ``execute(head) -> tokens`` is injected: the replica process wraps
    its own batcher (mirror execution of the full request); tests wrap
    a stub."""

    def __init__(self, gang_id: str, size: int, rank: int,
                 generation: int, registry_addr: str, token: str = "",
                 execute: Optional[Callable[[Dict[str, Any]], Any]] = None,
                 poll_interval: float = 0.2,
                 lookup_timeout: float = 120.0):
        if not 1 <= rank < size:
            raise ValueError(f"member rank must be in [1, {size}), "
                             f"got {rank}")
        self.gang_id = gang_id
        self.size = int(size)
        self.rank = int(rank)
        self.generation = int(generation)
        self.registry_addr = registry_addr
        self.token = token
        self.execute = execute
        self.poll_interval = float(poll_interval)
        self.lookup_timeout = float(lookup_timeout)
        self.served = 0
        self.log = get_logger("tfmesos_tpu_torch.fleet.gang")

    # -- rendezvous --------------------------------------------------------

    def _lookup_once(self) -> Optional[Dict[str, Any]]:
        sock = None
        try:
            sock = wire.connect(self.registry_addr, timeout=5.0)
            wire.send_msg(sock, {"op": "gang_lookup",
                                 "gang_id": self.gang_id}, self.token)
            reply = wire.recv_msg(sock, self.token)
            return reply if isinstance(reply, dict) else None
        except (OSError, wire.WireError):
            return None
        finally:
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass

    def find_leader(self, stop: Optional[threading.Event] = None
                    ) -> Optional[str]:
        """Poll ``gang_lookup`` until the leader's coord addr appears
        for OUR generation.  A leader advertising a newer generation
        means this process is the zombie of a torn-down gang — give up
        immediately (the fence's mirror image)."""
        deadline = time.monotonic() + self.lookup_timeout
        while time.monotonic() < deadline:
            if stop is not None and stop.is_set():
                return None
            info = self._lookup_once()
            if info and info.get("found"):
                try:
                    gen = int(info.get("gen"))
                except (TypeError, ValueError):
                    gen = None
                if gen is not None and gen > self.generation:
                    self.log.warning(
                        "gang %s leader runs generation %s, ours is %d:"
                        " we are the zombie; exiting", self.gang_id,
                        gen, self.generation)
                    return None
                if gen == self.generation:
                    coord = info.get("coord")
                    if isinstance(coord, str) and coord:
                        return coord
            if stop is not None:
                if stop.wait(self.poll_interval):
                    return None
            else:
                time.sleep(self.poll_interval)
        self.log.warning("gang %s rank %d: leader never appeared in "
                         "%.0fs", self.gang_id, self.rank,
                         self.lookup_timeout)
        return None

    # -- serve loop --------------------------------------------------------

    def run(self, stop: Optional[threading.Event] = None) -> str:
        """The member's whole life; returns why it ended — one of
        ``"no_leader"``, ``"refused"``, ``"leader_eof"``,
        ``"stopped"``."""
        coord = self.find_leader(stop)
        if coord is None:
            return "no_leader"
        sock = None
        try:
            sock = wire.connect(coord, timeout=10.0)
            sock.settimeout(None)
            wire.send_msg(sock, {"op": "gang_join",
                                 "gang_id": self.gang_id,
                                 "rank": self.rank,
                                 "gen": self.generation}, self.token)
            framer = wire.Framer(self.token, allow_raw=True)
            for msg in wire.iter_msgs(sock, framer):
                if stop is not None and stop.is_set():
                    return "stopped"
                head = (msg.meta if isinstance(msg, wire.RawFrame)
                        else msg)
                if not isinstance(head, dict):
                    continue
                op = head.get("op")
                if op == "gang_joined":
                    if not head.get("ok"):
                        self.log.warning(
                            "gang %s rank %d join refused: %s",
                            self.gang_id, self.rank,
                            head.get("error"))
                        return "refused"
                    self.log.info("gang %s rank %d joined leader %s",
                                  self.gang_id, self.rank, coord)
                elif op == "gang_dispatch":
                    self._serve_one(sock, head)
            return "stopped" if (stop is not None and stop.is_set()) \
                else "leader_eof"
        except (OSError, wire.WireError) as e:
            self.log.warning("gang %s rank %d link error: %s",
                             self.gang_id, self.rank, e)
            return "leader_eof"
        finally:
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass

    def _serve_one(self, sock, head) -> None:
        try:
            tokens = self.execute(head) if self.execute else []
            digest = token_digest(tokens)
        except Exception as e:
            self.log.exception("gang %s rank %d mirror execution "
                               "failed: %s", self.gang_id, self.rank, e)
            digest = f"error:{type(e).__name__}"
        self.served += 1
        wire.send_msg(sock, {"op": "gang_ack", "id": head.get("id"),
                             "rank": self.rank, "digest": digest},
                      self.token)


def leader_handler(inner: Callable, leader: GangLeader) -> Callable:
    """Wrap a replica handler with the gang fan-out: plain ``generate``
    dicts are dispatched to every member before the leader serves them
    locally, and the leader's own completion tokens feed the digest
    verification.  Raw frames (disaggregated KV imports) and control
    ops pass straight through — members mirror the decode stream, not
    the control plane."""

    def handler(msg, reply: Callable) -> None:
        if not isinstance(msg, dict) or msg.get("op") != "generate":
            inner(msg, reply)
            return
        mid = msg.get("id")
        leader.dispatch(msg)

        def wrapped(out) -> None:
            if isinstance(out, dict) and out.get("op") == "completion":
                leader.observe_local(mid, out.get("tokens") or [])
            reply(out)

        wrapped.partial = getattr(reply, "partial", None)
        # The connection key too, so a ``cancel`` on the same link finds
        # the request the inner handler books under it.
        wrapped.conn_key = getattr(reply, "conn_key", None)
        inner(msg, wrapped)

    return handler
