"""The KV fabric's one call the replica makes (port of
``tfmesos_tpu/fleet/kvtier.py:625-646``, ``fabric_rpc``: the direct KV
push of drain migration and of the prefill role).  The tiered store and
the fabric (``KVTierStore``, ``KVFabric``) come with the port's
``kv_tier``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from tfmesos_tpu_torch import wire

__all__ = ["fabric_rpc"]


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
