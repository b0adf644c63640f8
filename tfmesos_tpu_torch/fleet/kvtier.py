"""The tiered KV store and the cross-host KV fabric (port of
``tfmesos_tpu/fleet/kvtier.py:77-1019``: ``KINDS``, ``KVTierFull``,
``KVTierStore``, ``rendezvous_order``, ``fabric_rpc`` and ``KVFabric``).

Stdlib-only, like the reference, so the whole control plane (and the
dedicated ``--role kv`` holder, which never imports torch) can use it:

* a bounded **host-RAM tier** (LRU) of opaque ``(meta, body)`` blobs
  keyed by ``(kind, key)``;
* an optional bounded **disk tier** under ``disk_dir``: RAM-evicted
  entries spill to HMAC-framed files, so replicas of one host that share
  the directory resume each other's parked sessions.

Two kinds ride the store: ``"prefix"`` (one spilled prefix-cache page,
keyed by its chain digest) and ``"session"`` (a conversation's KV
artifact in ``pack_prefilled`` shape, keyed by the client's session id).

A disk entry is a 32-byte HMAC-SHA256 tag (keyed by the cluster token)
over ``meta_len (4 bytes, big-endian) + meta_json + body``; a tag
mismatch reads as a counted miss and the file is removed.  The framing,
the file names and the JSON encoding are the reference's byte for byte:
a JAX store and a port store over one directory with one token read
each other's entries.  Entries carry the writer's ``stamp``; a reader
stamped with another ``weights_version`` misses (``version_miss``).

Capacity is a hard bound: an entry larger than both budgets raises
:class:`KVTierFull` (a session park turns it into ``park_rejected``).
Counters (``stats()`` / ``summary()``): ``hits``, ``misses``, ``spills``,
``demotions``, ``evictions``, ``park``, ``park_rejected``, ``corrupt``,
``version_miss``; the batcher adds ``resume`` and ``promotions``, the
fabric its ``fabric_*`` and ``park_replicated`` / ``park_degraded``.

Gang artifacts (``pack_gang_shards`` / ``unpack_gang_shards`` and the
fabric's torn-gang check on fetch) come with gang replicas (ROADMAP
A.9).
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import struct
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from tfmesos_tpu_torch import wire
from tfmesos_tpu_torch.utils.logging import get_logger

__all__ = ["KINDS", "KVTierFull", "KVTierStore", "KVFabric", "fabric_rpc",
           "rendezvous_order"]

_TAG_LEN = 32
_LEN = struct.Struct(">I")

#: entry kinds; anything else is rejected at put().
KINDS = ("prefix", "session")


class KVTierFull(RuntimeError):
    """The entry can never fit the tier's budgets (an explicit rejection,
    never a hang: the caller completes without parking)."""


def _tag(token: str, payload: bytes) -> bytes:
    return hmac.new(token.encode("utf-8"), payload,
                    hashlib.sha256).digest()


class KVTierStore:
    """Bounded two-level (host-RAM → disk) blob store.

    ``ram_bytes`` bounds the RAM tier by body + serialized-meta bytes (a
    session meta embeds the conversation history).  ``disk_dir`` enables
    the disk tier, bounded by ``disk_bytes`` (default 4x RAM); the
    directory may be shared by the replicas of one host.  ``token`` keys
    the disk entries' tags; ``stamp`` is merged into every entry's meta
    and fences reads by ``weights_version``.  Thread-safe: the batcher's
    serve loop writes, the heartbeat thread reads :meth:`summary`."""

    def __init__(self, ram_bytes: int, disk_dir: Optional[str] = None,
                 disk_bytes: Optional[int] = None, token: str = "",
                 stamp: Optional[Dict[str, Any]] = None):
        if ram_bytes < 0:
            raise ValueError(f"ram_bytes must be >= 0, got {ram_bytes}")
        self.ram_bytes = int(ram_bytes)
        self.disk_dir = disk_dir
        self.disk_bytes = (int(disk_bytes) if disk_bytes is not None
                           else 4 * self.ram_bytes)
        if disk_dir is not None and self.disk_bytes <= 0:
            raise ValueError(f"disk_bytes must be > 0 with a disk tier, "
                             f"got {self.disk_bytes}")
        if self.ram_bytes == 0 and disk_dir is None:
            raise ValueError("a KV tier needs ram_bytes > 0 or a "
                             "disk_dir (both bounds zero stores nothing)")
        self.token = token
        #: writer identity merged into every entry's meta; a reader whose
        #: stamp names another weights_version misses.
        self.stamp = dict(stamp or {})
        # The base weights_version restamp() composes adapter labels on.
        self._base_wv = self.stamp.get("weights_version")
        #: the chunk geometry ({page, first, seed}) of this store's
        #: "prefix" entries, set by the owning batcher; rides summary()
        #: so the router can match prompts against spilled digests.
        self.prefix_geometry: Optional[Dict[str, Any]] = None
        self.log = get_logger("tfmesos_tpu_torch.fleet.kvtier")
        if disk_dir is not None:
            os.makedirs(disk_dir, exist_ok=True)
        self._lock = threading.Lock()
        # (kind, key) -> (meta, body, cost), LRU order (most recent last).
        self._ram: "OrderedDict[Tuple[str, str], tuple]" = OrderedDict()
        self._ram_used = 0
        # Incremental disk-occupancy estimate, reconciled against a real
        # scandir only when a write thinks it is over budget.
        self._disk_used = 0
        if disk_dir is not None:
            self._disk_used = sum(s for _, _, s in self._disk_usage())
        # Disk entries THIS process wrote: filename -> (kind, key, size).
        self._disk_keys: "OrderedDict[str, Tuple[str, str, int]]" = \
            OrderedDict()
        self._stats = {"hits": 0, "misses": 0, "spills": 0,
                       "demotions": 0, "evictions": 0, "park": 0,
                       "park_rejected": 0, "resume": 0, "promotions": 0,
                       "corrupt": 0, "version_miss": 0}

    # -- counters ----------------------------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        """Bump one counter (the batcher records ``resume`` and
        ``promotions`` here)."""
        with self._lock:
            self._stats[name] = self._stats.get(name, 0) + n

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._stats)
            out["ram_bytes_used"] = self._ram_used
            out["ram_entries"] = len(self._ram)
            out["disk_bytes_used"] = sum(
                s for _, _, s in self._disk_keys.values())
            out["disk_entries"] = len(self._disk_keys)
        return out

    # -- disk framing ------------------------------------------------------

    def _path(self, kind: str, key: str) -> str:
        name = hashlib.sha256(
            f"{kind}\x00{key}".encode("utf-8")).hexdigest()
        return os.path.join(self.disk_dir, f"{name}.kvt")

    def _disk_write(self, kind: str, key: str, meta: dict,
                    body: bytes) -> bool:
        """Write one HMAC-framed entry atomically (tmp + rename).  False
        on any OS error: spilling is best-effort."""
        path = self._path(kind, key)
        mb = json.dumps(meta).encode("utf-8")
        payload = _LEN.pack(len(mb)) + mb + body
        try:
            tmp = path + f".tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(_tag(self.token, payload))
                f.write(payload)
            os.replace(tmp, path)
        except OSError as e:
            self.log.warning("kv tier disk write failed for %s/%s: %s",
                             kind, key, e)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        name = os.path.basename(path)
        old = self._disk_keys.pop(name, None)
        if old is not None:
            self._disk_used -= old[2]
        total = _TAG_LEN + len(payload)
        self._disk_keys[name] = (kind, key, total)
        self._disk_used += total
        return True

    def _disk_read(self, kind: str, key: str
                   ) -> Optional[Tuple[dict, bytes]]:
        """Read and verify one disk entry: a missing file is a miss, a
        tag mismatch a counted miss whose file is removed."""
        path = self._path(kind, key)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        ok = len(blob) > _TAG_LEN + _LEN.size and hmac.compare_digest(
            blob[:_TAG_LEN], _tag(self.token, blob[_TAG_LEN:]))
        meta: Any = None
        if ok:
            (mlen,) = _LEN.unpack_from(blob, _TAG_LEN)
            off = _TAG_LEN + _LEN.size
            if off + mlen <= len(blob):
                try:
                    meta = json.loads(blob[off:off + mlen])
                except ValueError:
                    meta = None
        if not ok or not isinstance(meta, dict):
            self._stats["corrupt"] += 1
            self.log.warning("kv tier disk entry for %s/%s failed its "
                             "integrity tag; treating as a miss", kind,
                             key)
            try:
                os.unlink(path)
            except OSError:
                pass
            old = self._disk_keys.pop(os.path.basename(path), None)
            if old is not None:
                self._disk_used -= old[2]
            return None
        return meta, blob[_TAG_LEN + _LEN.size + mlen:]

    def _disk_usage(self) -> List[Tuple[float, str, int]]:
        """(mtime, path, size) of every entry in the directory."""
        out = []
        try:
            with os.scandir(self.disk_dir) as it:
                for e in it:
                    if not e.name.endswith(".kvt"):
                        continue
                    try:
                        st = e.stat()
                    except OSError:
                        continue
                    out.append((st.st_mtime, e.path, st.st_size))
        except OSError:
            pass
        return out

    def _disk_make_room(self, need: int) -> bool:
        """Evict the oldest disk entries until ``need`` more bytes fit;
        False when ``need`` alone exceeds the budget.  The scandir (which
        also counts a shared directory's foreign entries) runs only when
        the estimate says the budget is reached."""
        if need > self.disk_bytes:
            return False
        if self._disk_used + need <= self.disk_bytes:
            return True
        entries = sorted(self._disk_usage())
        used = sum(s for _, _, s in entries)
        while entries and used + need > self.disk_bytes:
            _, path, size = entries.pop(0)
            try:
                os.unlink(path)
            except OSError:
                pass
            self._disk_keys.pop(os.path.basename(path), None)
            self._stats["evictions"] += 1
            used -= size
        self._disk_used = used
        return used + need <= self.disk_bytes

    # -- the RAM tier ------------------------------------------------------

    def _ram_evict_one(self) -> None:
        """Drop the LRU RAM entry, demoting it to disk when there is a
        disk tier."""
        (kind, key), (meta, body, cost) = self._ram.popitem(last=False)
        self._ram_used -= cost
        if self.disk_dir is not None and \
                self._disk_make_room(cost + 256) and \
                self._disk_write(kind, key, meta, body):
            self._stats["demotions"] += 1
        else:
            self._stats["evictions"] += 1

    def _ram_put(self, kind: str, key: str, meta: dict,
                 body: bytes, cost: Optional[int] = None) -> None:
        if cost is None:
            cost = len(body) + len(json.dumps(meta))
        old = self._ram.pop((kind, key), None)
        if old is not None:
            self._ram_used -= old[2]
        self._ram[(kind, key)] = (meta, body, cost)
        self._ram_used += cost
        self._ram.move_to_end((kind, key))
        while self._ram_used > self.ram_bytes and len(self._ram) > 1:
            self._ram_evict_one()
        if self._ram_used > self.ram_bytes:
            # The sole entry alone overflows RAM: straight to disk (put()
            # checked that some tier can hold it).
            self._ram_evict_one()

    # -- public surface ----------------------------------------------------

    def put(self, kind: str, key: str, meta: Dict[str, Any],
            body: bytes, stamp: bool = True) -> None:
        """Store one entry, replacing any with the same key.  Raises
        :class:`KVTierFull` when it can never fit either budget, or when
        a straight-to-disk write fails.  ``stamp=False`` keeps the meta's
        own writer stamp (a fabric-replicated artifact keeps its
        original fence)."""
        if kind not in KINDS:
            raise ValueError(f"unknown kv tier kind {kind!r} "
                             f"(have: {KINDS})")
        body = bytes(body)
        meta = dict(meta)
        if stamp:
            meta.update(self.stamp)
        cost = len(body) + len(json.dumps(meta))
        fits_ram = cost <= self.ram_bytes
        fits_disk = (self.disk_dir is not None
                     and cost + 256 <= self.disk_bytes)
        if not fits_ram and not fits_disk:
            raise KVTierFull(
                f"{kind} entry {key!r} ({cost} bytes incl. meta) "
                f"exceeds the tier budgets (ram {self.ram_bytes}, disk "
                f"{self.disk_bytes if self.disk_dir else 0})")
        with self._lock:
            if fits_ram:
                self._ram_put(kind, key, meta, body, cost=cost)
            else:
                old = self._ram.pop((kind, key), None)
                if old is not None:
                    self._ram_used -= old[2]
                if not self._disk_make_room(cost + 256) \
                        or not self._disk_write(kind, key, meta, body):
                    raise KVTierFull(
                        f"{kind} entry {key!r} cannot be stored in the "
                        f"disk tier ({self.disk_bytes} bytes budget, "
                        f"or the write failed)")

    def restamp(self, weights_version: Optional[str] = None,
                adapter: str = "") -> None:
        """Re-identify the store after a weight change:
        ``weights_version`` replaces the base label (None keeps it), a
        non-empty ``adapter`` composes as ``"<base>+<adapter>"``.
        Entries written under the old stamp become version misses."""
        with self._lock:
            if weights_version is not None:
                self._base_wv = str(weights_version)
            wv = self._base_wv
            if adapter:
                wv = f"{wv or ''}+{adapter}"
            stamp = dict(self.stamp)
            if wv:
                stamp["weights_version"] = wv
            else:
                stamp.pop("weights_version", None)
            self.stamp = stamp

    def _stamp_ok(self, meta: dict) -> bool:
        """An entry stamped with another weights_version than this
        reader's misses; unstamped entries (or reader) pass."""
        want = self.stamp.get("weights_version")
        have = meta.get("weights_version")
        if want and have and str(have) != str(want):
            return False
        return True

    def get(self, kind: str, key: str
            ) -> Optional[Tuple[Dict[str, Any], bytes]]:
        """``(meta, body)`` or None.  A disk hit moves the entry back
        into the RAM tier."""
        with self._lock:
            hit = self._ram.get((kind, key))
            if hit is not None:
                if not self._stamp_ok(hit[0]):
                    self._stats["version_miss"] += 1
                    self._stats["misses"] += 1
                    return None
                self._ram.move_to_end((kind, key))
                self._stats["hits"] += 1
                return hit[0], hit[1]
            if self.disk_dir is not None:
                got = self._disk_read(kind, key)
                if got is not None:
                    if not self._stamp_ok(got[0]):
                        self._stats["version_miss"] += 1
                        self._stats["misses"] += 1
                        return None
                    self._stats["hits"] += 1
                    cost = len(got[1]) + len(json.dumps(got[0]))
                    if cost <= self.ram_bytes:
                        self._ram_put(kind, key, got[0], got[1],
                                      cost=cost)
                    return got
            self._stats["misses"] += 1
            return None

    def delete(self, kind: str, key: str) -> None:
        with self._lock:
            old = self._ram.pop((kind, key), None)
            if old is not None:
                self._ram_used -= old[2]
            if self.disk_dir is not None:
                path = self._path(kind, key)
                try:
                    os.unlink(path)
                except OSError:
                    pass
                dold = self._disk_keys.pop(os.path.basename(path), None)
                if dold is not None:
                    self._disk_used -= dold[2]

    # -- kind-specific sugar ----------------------------------------------

    def would_accept(self, nbytes: int) -> bool:
        """Whether an entry of about ``nbytes`` could ever be stored: the
        batcher asks before paying a device-to-host gather for a spill
        the tier would reject."""
        return (nbytes <= self.ram_bytes
                or (self.disk_dir is not None
                    and nbytes + 256 <= self.disk_bytes))

    def put_prefix(self, digest_hex: str, meta: Dict[str, Any],
                   body: bytes) -> None:
        """Park one evicted prefix-cache page (content-addressed by its
        chain digest); a full tier declines, counted as an eviction."""
        try:
            self.put("prefix", digest_hex, meta, body)
        except KVTierFull:
            self.count("evictions")
            return
        self.count("spills")

    def get_prefix(self, digest_hex: str
                   ) -> Optional[Tuple[Dict[str, Any], bytes]]:
        return self.get("prefix", digest_hex)

    def park(self, session_id: str, meta: Dict[str, Any],
             body: bytes) -> None:
        """Park one session's KV artifact between turns; raises
        :class:`KVTierFull` (counted ``park_rejected``) when it cannot
        fit."""
        try:
            self.put("session", session_id, meta, body)
        except KVTierFull:
            self.count("park_rejected")
            raise
        self.count("park")

    def resume(self, session_id: str
               ) -> Optional[Tuple[Dict[str, Any], bytes]]:
        """The parked artifact for ``session_id`` (the batcher counts
        ``resume`` once it validated it)."""
        return self.get("session", session_id)

    # -- wire-facing summary ----------------------------------------------

    def summary(self, max_entries: int = 32) -> Dict[str, Any]:
        """Heartbeat payload: recent parked session ids (the router's
        session-affinity key), the spilled prefix digests in the device
        cache's summary shape, counters and occupancy."""
        with self._lock:
            sessions: List[str] = []
            hashes: List[str] = []
            for (kind, key) in reversed(self._ram):
                if len(sessions) >= max_entries \
                        and len(hashes) >= max_entries:
                    break
                if kind == "session" and len(sessions) < max_entries:
                    sessions.append(key)
                elif kind == "prefix" and len(hashes) < max_entries:
                    hashes.append(key)
            for _, (kind, key, _s) in reversed(self._disk_keys.items()):
                if len(sessions) >= max_entries \
                        and len(hashes) >= max_entries:
                    break
                if kind == "session" and key not in sessions \
                        and len(sessions) < max_entries:
                    sessions.append(key)
                elif kind == "prefix" and key not in hashes \
                        and len(hashes) < max_entries:
                    hashes.append(key)
            out: Dict[str, Any] = {
                "sessions": sessions,
                "counters": dict(self._stats),
                "ram_bytes_used": self._ram_used,
                "ram_bytes": self.ram_bytes,
                # Whether parked state outlives this replica (a disk
                # tier the host's replicas share).
                "disk": self.disk_dir is not None,
            }
            geom = self.prefix_geometry
        if geom and hashes:
            out["prefix"] = {"page": geom.get("page"),
                             "first": geom.get("first"),
                             "seed": geom.get("seed"),
                             "hashes": hashes}
        return out


# -- the cross-host fabric ---------------------------------------------------


def rendezvous_order(key: str, addrs: List[str]) -> List[str]:
    """Deterministic per-key peer preference (rendezvous hashing): every
    replica computes the same order from the same alive set."""
    return sorted(addrs, key=lambda a: hashlib.sha256(
        f"{key}\x00{a}".encode("utf-8")).hexdigest())


def fabric_rpc(addr: str, meta: Dict[str, Any], body: Optional[bytes] = None,
               token: str = "", timeout: float = 10.0,
               self_addr: str = "") -> Any:
    """One synchronous request/reply with a peer replica over a fresh
    authenticated connection: a JSON frame without ``body``, a raw frame
    with one; the reply may be either kind.  The socket is tagged with
    the caller's advertised ``self_addr``."""
    sock = wire.connect(addr, timeout=timeout)
    try:
        sock.settimeout(timeout)
        if self_addr:
            wire.tag_socket(sock, self_addr)
        if body is None:
            wire.send_msg(sock, meta, token)
        else:
            wire.send_raw_msg(sock, meta, body, token)
        return wire.recv_msg(sock, token, allow_raw=True)
    finally:
        try:
            sock.close()
        except OSError:
            pass


class KVFabric:
    """The cross-host face of one replica's :class:`KVTierStore`: K-way
    replicated session parking and peer fetch on a miss, so a parked
    conversation survives the host that parked it.

    It wraps a store and presents the surface the batcher binds,
    delegating whatever it does not override:

    * ``park`` parks locally first (capacity rejections propagate), then
      pushes the stamped artifact synchronously to ``replication - 1``
      peers in rendezvous order (``kv_put`` raw frames): at least one
      copy landed is ``park_replicated``, eligible peers that all failed
      ``park_degraded`` (the local copy stands);
    * ``resume`` / ``get_prefix`` on a local miss ask the registry where
      the artifact lives (``kv_locate``), ``kv_fetch`` it and install it
      without re-stamping, so the local fence judges the original
      writer's stamp (a stale copy reads as ``fabric_reject_stale``).

    ``rpc`` and ``peers`` are injectable (tests run fabrics with no
    sockets); ``peers()`` returns dicts with at least ``addr`` (plus
    ``role`` / ``weights_version`` / ``occupancy``), by default from the
    registry's ``kv_peers`` op, cached for ``peer_ttl``."""

    def __init__(self, store: KVTierStore, token: str = "",
                 self_addr: str = "", registry_addr: Optional[str] = None,
                 replication: int = 2, rpc=None, peers=None,
                 clock=time.monotonic, peer_ttl: float = 1.0,
                 push_timeout: float = 10.0,
                 placement: str = "rendezvous"):
        if replication < 1:
            raise ValueError(f"replication must be >= 1, "
                             f"got {replication}")
        if placement not in ("rendezvous", "loaded"):
            raise ValueError(f"placement must be 'rendezvous' or "
                             f"'loaded', got {placement!r}")
        self.store = store
        self.token = token
        self.self_addr = self_addr
        self.registry_addr = registry_addr
        self.replication = int(replication)
        self.placement = placement
        self._rpc = rpc or (lambda addr, meta, body=None, timeout=10.0:
                            fabric_rpc(addr, meta, body, token=self.token,
                                       timeout=timeout,
                                       self_addr=self.self_addr))
        self._peer_source = peers
        self._clock = clock
        self.peer_ttl = float(peer_ttl)
        self.push_timeout = float(push_timeout)
        self._peer_cache: Tuple[float, List[Dict[str, Any]]] = (-1e18, [])
        self.log = get_logger("tfmesos_tpu_torch.fleet.kvfabric")

    # -- delegation: the fabric is the batcher's kv tier -------------------

    def __getattr__(self, name: str) -> Any:
        return getattr(self.store, name)

    @property
    def prefix_geometry(self) -> Optional[Dict[str, Any]]:
        return self.store.prefix_geometry

    @prefix_geometry.setter
    def prefix_geometry(self, geom: Optional[Dict[str, Any]]) -> None:
        # The batcher assigns it: it must land on the store summary()
        # reads, not on this wrapper.
        self.store.prefix_geometry = geom

    # -- peer placement ----------------------------------------------------

    def peers(self) -> List[Dict[str, Any]]:
        """Alive fabric peers (self excluded), from the injected source
        or the registry's ``kv_peers`` (cached: park runs on the serve
        loop)."""
        if self._peer_source is not None:
            raw = list(self._peer_source())
        else:
            if self.registry_addr is None:
                return []
            t, cached = self._peer_cache
            if self._clock() - t < self.peer_ttl:
                raw = cached
            else:
                try:
                    reply = self._rpc(self.registry_addr,
                                      {"op": "kv_peers"},
                                      timeout=self.push_timeout)
                    raw = reply.get("peers") or [] \
                        if isinstance(reply, dict) else []
                except (OSError, wire.WireError) as e:
                    self.log.warning("kv_peers lookup failed: %s", e)
                    raw = cached    # stale beats empty mid-blip
                self._peer_cache = (self._clock(), raw)
        out = []
        for p in raw:
            if isinstance(p, dict) and p.get("addr") \
                    and p["addr"] != self.self_addr:
                out.append(p)
        return out

    def _order(self, key: str, peers: List[Dict[str, Any]]
               ) -> List[str]:
        """One eligibility class's candidate order: rendezvous, or with
        ``placement='loaded'`` the same order re-scored by the peers'
        advertised tier occupancy in quarter buckets."""
        ranked = rendezvous_order(key, [p["addr"] for p in peers])
        if self.placement != "loaded":
            return ranked
        occ: Dict[str, Any] = {p["addr"]: p.get("occupancy")
                               for p in peers}

        def bucket(addr: str) -> int:
            o = occ.get(addr)
            if not isinstance(o, (int, float)) or o != o or o < 0:
                return 0    # unknown load reads as empty, not as full
            return min(int(float(o) * 4.0), 4)

        rank = {a: i for i, a in enumerate(ranked)}
        return sorted(ranked, key=lambda a: (bucket(a), rank[a]))

    def _replica_targets(self, key: str) -> List[str]:
        """The peers eligible to hold a copy of ``key``: dedicated
        KV-role peers first, then same-weights_version peers, unstamped
        or other-version peers last, each class in :meth:`_order`."""
        wv = self.store.stamp.get("weights_version")
        kv_role, same, rest = [], [], []
        for p in self.peers():
            pwv = p.get("weights_version")
            if p.get("role") == "kv":
                kv_role.append(p)
            elif not wv or not pwv or str(pwv) == str(wv):
                same.append(p)
            else:
                rest.append(p)
        return (self._order(key, kv_role)
                + self._order(key, same)
                + self._order(key, rest))

    # -- replicated park ---------------------------------------------------

    def park(self, session_id: str, meta: Dict[str, Any],
             body: bytes) -> None:
        self.store.park(session_id, meta, body)
        if self.replication <= 1:
            return
        # Push the stamped artifact, so every copy carries the same fence.
        smeta = dict(meta)
        smeta.update(self.store.stamp)
        self._replicate("session", session_id, smeta, body)

    def _replicate(self, kind: str, key: str, meta: Dict[str, Any],
                   body: bytes) -> int:
        """Land ``replication - 1`` copies on peers (one attempt a peer,
        rendezvous order); returns the copies made."""
        want = self.replication - 1
        targets = self._replica_targets(key)
        landed = 0
        for addr in targets:
            if landed >= want:
                break
            self.store.count("fabric_push")
            try:
                reply = self._rpc(
                    addr, {"op": "kv_put", "kind": kind, "key": key,
                           "meta": meta},
                    body, timeout=self.push_timeout)
            except (OSError, wire.WireError) as e:
                self.store.count("fabric_push_fail")
                self.log.warning("fabric push of %s/%s to %s failed: %s",
                                 kind, key, addr, e)
                continue
            if isinstance(reply, dict) and reply.get("op") == "kv_put_ok":
                landed += 1
                self.store.count("fabric_push_bytes", len(body))
            else:
                self.store.count("fabric_push_fail")
                self.log.warning("fabric push of %s/%s to %s rejected: "
                                 "%r", kind, key, addr, reply)
        if landed >= min(want, len(targets)) and landed > 0:
            self.store.count("park_replicated")
        elif targets:
            self.store.count("park_degraded")
            self.log.warning(
                "fabric park of %s/%s degraded: %d/%d peer copies "
                "landed (%d peers eligible)", kind, key, landed, want,
                len(targets))
        return landed

    # -- remote fetch on miss ----------------------------------------------

    def resume(self, session_id: str
               ) -> Optional[Tuple[Dict[str, Any], bytes]]:
        got = self.store.resume(session_id)
        if got is not None:
            return got
        return self.fetch("session", session_id)

    def get_prefix(self, digest_hex: str
                   ) -> Optional[Tuple[Dict[str, Any], bytes]]:
        """A spilled prefix page missing locally is fetched like a
        session (content-addressed, so any holder's copy is the right
        bytes; the fence still applies on the local re-read)."""
        got = self.store.get_prefix(digest_hex)
        if got is not None:
            return got
        got = self.fetch("prefix", digest_hex)
        if got is not None:
            self.store.count("fabric_prefix_fetches")
        return got

    def fetch(self, kind: str, key: str
              ) -> Optional[Tuple[Dict[str, Any], bytes]]:
        """Locate and fetch one artifact from a surviving holder; None
        when none has a usable copy.  The copy installs un-restamped and
        re-reads through the local store's fence."""
        holders = self.locate(kind, key)
        if not holders:
            # The placement map is heartbeat-fed and truncated: probe the
            # rendezvous heads a replicated park would have picked.
            holders = self._replica_targets(key)[:self.replication + 1]
        for addr in holders:
            if addr == self.self_addr:
                continue
            self.store.count("fabric_fetch")
            try:
                reply = self._rpc(addr,
                                  {"op": "kv_fetch", "kind": kind,
                                   "key": key},
                                  timeout=self.push_timeout)
            except (OSError, wire.WireError) as e:
                self.store.count("fabric_fetch_fail")
                self.log.warning("fabric fetch of %s/%s from %s failed: "
                                 "%s", kind, key, addr, e)
                continue
            if not isinstance(reply, wire.RawFrame) \
                    or not isinstance(reply.meta, dict) \
                    or reply.meta.get("op") != "kv_artifact":
                self.store.count("fabric_fetch_miss")
                continue
            ameta = reply.meta.get("meta")
            if not isinstance(ameta, dict):
                self.store.count("fabric_fetch_miss")
                continue
            try:
                self.store.put(kind, key, ameta, reply.body, stamp=False)
            except KVTierFull:
                self.store.count("fabric_fetch_fail")
                return None     # nowhere to land it locally
            got = self.store.get(kind, key)
            if got is None:
                # The local fence rejected a stale holder's copy: drop it
                # and keep looking.
                self.store.count("fabric_reject_stale")
                self.store.delete(kind, key)
                continue
            self.store.count("fabric_fetch_hit")
            self.store.count("fabric_fetch_bytes", len(reply.body))
            return got
        return None

    def locate(self, kind: str, key: str) -> List[str]:
        """Holder addrs of one artifact from the registry's placement map
        (``kv_locate``)."""
        if self.registry_addr is None:
            return []
        try:
            reply = self._rpc(self.registry_addr,
                              {"op": "kv_locate", "kind": kind,
                               "key": key},
                              timeout=self.push_timeout)
        except (OSError, wire.WireError) as e:
            self.log.warning("kv_locate of %s/%s failed: %s", kind,
                             key, e)
            return []
        if isinstance(reply, dict) and isinstance(reply.get("addrs"),
                                                  list):
            return [a for a in reply["addrs"] if isinstance(a, str)]
        return []

    # -- wire ops the owning replica serves --------------------------------

    def handle_put(self, msg: "wire.RawFrame") -> Dict[str, Any]:
        """Serve a peer's ``kv_put``: install without re-stamping."""
        meta = msg.meta
        kind = meta.get("kind")
        key = meta.get("key")
        ameta = meta.get("meta")
        if kind not in KINDS or not isinstance(key, str) or not key \
                or not isinstance(ameta, dict):
            return {"op": "error", "kind": "bad_request",
                    "error": "malformed kv_put"}
        try:
            self.store.put(kind, key, ameta, msg.body, stamp=False)
        except KVTierFull as e:
            return {"op": "error", "kind": "kv_tier_full",
                    "error": str(e)}
        self.store.count("fabric_store")
        return {"op": "kv_put_ok", "kind": kind, "key": key}

    def handle_fetch(self, msg: Dict[str, Any]) -> Any:
        """Serve a peer's ``kv_fetch`` from the raw store (never a fabric
        re-fetch, so two replicas that both miss cannot loop): the
        artifact as a raw frame, or an explicit miss."""
        kind = msg.get("kind")
        key = msg.get("key")
        if kind not in KINDS or not isinstance(key, str) or not key:
            return {"op": "error", "kind": "bad_request",
                    "error": "malformed kv_fetch"}
        got = self.store.get(kind, key)
        if got is None:
            return {"op": "kv_miss", "kind": kind, "key": key}
        meta, body = got
        self.store.count("fabric_serve")
        return wire.RawFrame({"op": "kv_artifact", "kind": kind,
                              "key": key, "meta": meta}, body)
