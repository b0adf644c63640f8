"""The adapter (weight-delta) wire format (port of
``tfmesos_tpu/fleet/catalog.py:616-700``): how a LoRA-style delta of
``/``-joined param paths to arrays travels to a replica's
``swap_adapter`` op, byte for byte the JAX package's encoding.  The
catalog itself (``ModelCatalog``, ``ModelTrader``) is not ported yet.

A raw frame carries it between processes: ``meta["adapter"]`` is the
manifest (paths, shapes, dtypes, byte sizes; JSON, never pickle) and the
body the arrays' bytes in path order; the frame's HMAC covers both.  The
gateway hop carries the same manifest with the body in base64
(:func:`encode_adapter_fields`), since the gateway's public port takes
no raw frames.
"""

from __future__ import annotations

import base64
from typing import Any, Dict, Tuple

__all__ = ["pack_adapter", "unpack_adapter", "encode_adapter_fields",
           "decode_adapter_fields"]


def pack_adapter(delta: Dict[str, Any]) -> Tuple[dict, bytes]:
    """A param-path -> numpy-array delta as the raw frame's ``(meta,
    body)``: the manifest in ``meta["adapter"]``, the arrays' raw bytes
    concatenated in sorted path order."""
    import numpy as np

    if not delta:
        raise ValueError("an adapter delta needs at least one entry")
    paths, shapes, dtypes, chunks = [], [], [], []
    for path in sorted(delta):
        arr = np.ascontiguousarray(delta[path])
        paths.append(str(path))
        shapes.append(list(arr.shape))
        dtypes.append(str(arr.dtype))
        chunks.append(arr.tobytes())
    meta = {"adapter": {"paths": paths, "shapes": shapes,
                        "dtypes": dtypes,
                        "sizes": [len(c) for c in chunks]}}
    return meta, b"".join(chunks)


def unpack_adapter(meta: dict, body: bytes) -> Dict[str, Any]:
    """Inverse of :func:`pack_adapter`; ``ValueError`` on a malformed
    manifest (sizes that do not tile the body, bad dtypes or shapes)."""
    import numpy as np

    man = meta.get("adapter")
    if not isinstance(man, dict):
        raise ValueError("adapter frame carries no manifest")
    paths = man.get("paths")
    shapes = man.get("shapes")
    dtypes = man.get("dtypes")
    sizes = man.get("sizes")
    if not (isinstance(paths, list) and isinstance(shapes, list)
            and isinstance(dtypes, list) and isinstance(sizes, list)
            and len(paths) == len(shapes) == len(dtypes) == len(sizes)
            and paths):
        raise ValueError("malformed adapter manifest")
    if sum(int(s) for s in sizes) != len(body):
        raise ValueError(
            f"adapter body ({len(body)} bytes) does not match its "
            f"manifest ({sum(int(s) for s in sizes)} bytes)")
    out: Dict[str, Any] = {}
    off = 0
    for path, shape, dtype, size in zip(paths, shapes, dtypes, sizes):
        size = int(size)
        try:
            dt = np.dtype(str(dtype))
            if dt.itemsize == 0:    # e.g. "V0" would divide by zero
                raise ValueError(f"zero-itemsize dtype {dtype!r}")
            arr = np.frombuffer(body, dtype=dt, count=size // dt.itemsize,
                                offset=off).reshape([int(d) for d in shape])
        except (TypeError, ValueError) as e:
            raise ValueError(f"bad adapter entry {path!r}: {e}") from e
        out[str(path)] = arr.copy()     # frombuffer views are read-only
        off += size
    return out


def encode_adapter_fields(delta: Dict[str, Any]) -> Dict[str, Any]:
    """The JSON-safe shape of a delta for the gateway hop: the manifest
    plus the body in base64 (``body_b64``)."""
    meta, body = pack_adapter(delta)
    out = dict(meta["adapter"])
    out["body_b64"] = base64.b64encode(body).decode("ascii")
    return out


def decode_adapter_fields(fields: Dict[str, Any]) -> Tuple[dict, bytes]:
    """Inverse of :func:`encode_adapter_fields`, standard library only:
    the raw frame's ``(meta, body)`` without building arrays (the
    manifest is checked structurally here, numerically by the
    replica)."""
    if not isinstance(fields, dict):
        raise ValueError("adapter delta must be an object")
    b64 = fields.get("body_b64")
    if not isinstance(b64, str) or not b64:
        raise ValueError("adapter delta needs body_b64")
    try:
        body = base64.b64decode(b64.encode("ascii"), validate=True)
    except Exception as e:
        raise ValueError(f"adapter body_b64 does not decode: {e}") from e
    man = {k: fields.get(k) for k in ("paths", "shapes", "dtypes",
                                      "sizes")}
    if not all(isinstance(v, list) and v for v in man.values()):
        raise ValueError("adapter delta needs paths/shapes/dtypes/sizes")
    sizes = man["sizes"]
    if not all(isinstance(s, int) and not isinstance(s, bool) and s > 0
               for s in sizes) or sum(sizes) != len(body):
        raise ValueError("adapter sizes do not tile the body")
    return {"adapter": man}, body
