"""Minimal ZooKeeper client: resolve a ``zk://`` Mesos master URL (port
of ``tfmesos_tpu/backends/zk.py``).

The reference accepts ``zk://host:port,.../mesos`` masters via pymesos'
ZooKeeper dependency (reference requirements.txt:11, scheduler.py:188).  We
need exactly one read path — find the leading master's advertised address —
so instead of a ZK client library this speaks the few jute-encoded frames
that path requires (connect, getChildren, getData) over a raw socket.

Mesos masters register ephemeral sequential znodes ``json.info_XXXXXXXXXX``
under the configured path; the lowest sequence number is the leader, and its
data is a JSON ``MasterInfo`` carrying ``address.ip``/``address.port``.
"""

from __future__ import annotations

import json
import socket
import struct
import urllib.parse
from typing import List, Tuple

from tfmesos_tpu_torch.utils.logging import get_logger

log = get_logger("tfmesos_tpu_torch.zk")

_GET_CHILDREN = 8
_GET_DATA = 4


def _buf(data: bytes) -> bytes:
    return struct.pack(">i", len(data)) + data


def _frame(payload: bytes) -> bytes:
    return struct.pack(">i", len(payload)) + payload


def _read_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise IOError("ZooKeeper connection closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _read_frame(sock: socket.socket) -> bytes:
    (length,) = struct.unpack(">i", _read_exact(sock, 4))
    if length < 0 or length > 1 << 22:
        raise IOError(f"bad ZooKeeper frame length {length}")
    return _read_exact(sock, length)


def _connect(sock: socket.socket, timeout_ms: int = 10000) -> None:
    # ConnectRequest: protocolVersion, lastZxidSeen, timeOut, sessionId,
    # passwd buffer (+ trailing readOnly flag, accepted since ZK 3.4).
    req = (struct.pack(">iqiq", 0, 0, timeout_ms, 0)
           + _buf(b"\x00" * 16) + b"\x00")
    sock.sendall(_frame(req))
    resp = _read_frame(sock)
    if len(resp) < 16:
        raise IOError(f"short ZooKeeper connect response ({len(resp)}B)")
    # ConnectResponse: protocolVersion int32, timeOut int32, sessionId int64,
    # passwd buffer[, readOnly byte] — nothing we need beyond "it parsed".


def _request(sock: socket.socket, xid: int, op: int, payload: bytes) -> bytes:
    sock.sendall(_frame(struct.pack(">ii", xid, op) + payload))
    resp = _read_frame(sock)
    got_xid, _zxid, err = struct.unpack(">iqi", resp[:16])
    while got_xid != xid:
        # Skip unsolicited server frames (watch events use xid -1).
        resp = _read_frame(sock)
        got_xid, _zxid, err = struct.unpack(">iqi", resp[:16])
    if err != 0:
        raise IOError(f"ZooKeeper op {op} failed with error {err}")
    return resp[16:]


def _get_children(sock: socket.socket, path: str) -> List[str]:
    body = _request(sock, 1, _GET_CHILDREN, _buf(path.encode()) + b"\x00")
    (count,) = struct.unpack(">i", body[:4])
    out, off = [], 4
    for _ in range(count):
        (n,) = struct.unpack(">i", body[off:off + 4])
        off += 4
        out.append(body[off:off + n].decode())
        off += n
    return out


def _get_data(sock: socket.socket, path: str) -> bytes:
    body = _request(sock, 2, _GET_DATA, _buf(path.encode()) + b"\x00")
    (n,) = struct.unpack(">i", body[:4])
    return body[4:4 + n]


def parse_zk_url(url: str) -> Tuple[List[Tuple[str, int]], str]:
    """``zk://h1:2181,h2:2181/mesos`` -> ([(h1, 2181), (h2, 2181)], "/mesos").

    A ``user:pass@`` userinfo section (digest auth) is accepted and ignored —
    Mesos master znodes are world-readable.
    """
    parsed = urllib.parse.urlparse(url)
    if parsed.scheme != "zk":
        raise ValueError(f"not a zk:// URL: {url}")
    netloc = parsed.netloc.rsplit("@", 1)[-1]
    servers = []
    for part in netloc.split(","):
        host, _, port = part.partition(":")
        if host:
            servers.append((host, int(port or 2181)))
    if not servers or not parsed.path or parsed.path == "/":
        raise ValueError(f"zk:// URL needs servers and a path: {url}")
    return servers, parsed.path.rstrip("/")


def resolve_master(url: str, timeout: float = 10.0) -> str:
    """Resolve a ``zk://`` URL to the leading master's ``host:port``."""
    servers, path = parse_zk_url(url)
    last_err: Exception = IOError("no ZooKeeper servers in URL")
    for host, port in servers:
        try:
            with socket.create_connection((host, port),
                                          timeout=timeout) as sock:
                sock.settimeout(timeout)
                _connect(sock)
                children = [c for c in _get_children(sock, path)
                            if c.startswith("json.info_")]
                if not children:
                    raise IOError(f"no json.info_* master znodes under "
                                  f"{path} — is this a Mesos ensemble?")
                leader = min(children, key=lambda c: int(c.rsplit("_", 1)[1]))
                info = json.loads(_get_data(sock, f"{path}/{leader}"))
                addr = info.get("address", {})
                ip = addr.get("ip") or addr.get("hostname") or info.get(
                    "hostname")
                if not ip:
                    raise IOError(f"master znode {leader} carries no address")
                master = f"{ip}:{addr.get('port', 5050)}"
                log.info("zk: resolved %s -> leading master %s (%s)",
                         url, master, leader)
                return master
        except (OSError, IOError, ValueError, json.JSONDecodeError) as e:
            last_err = e
            log.warning("zk: %s:%d failed: %s", host, port, e)
    raise IOError(f"could not resolve {url}: {last_err}")
