"""Chunk hashing shared by the serving prefix cache and the fleet router
(a copy of ``tfmesos_tpu/prefixhash.py``: the port imports nothing of
the JAX package, and its digests must equal that module's bit for bit,
because the fleet router matches heartbeat hashes against them).

The prefix cache (serving.py) keys resident KV pages by a HASH CHAIN
over page-aligned token chunks: the digest of chunk j commits to every
token in chunks 0..j, which is exactly the dependency set of the K/V
values stored in page j (attention at position i reads all positions
<= i).  The fleet router computes the same chain over an incoming
request's prompt and matches it against the digests replicas advertise
in their registry heartbeats — so the two sides MUST agree on the
hashing, which is why it lives in this tiny jax-free module (the fleet
control plane imports no model code).

Geometry: a batcher with page size ``P`` and a constant batcher-level
prefix whose last ``off`` tokens share the first cacheable page splits
a prompt into chunks of ``first = P - off`` then ``P, P, ...`` tokens
(``first == P`` without a prefix tail), and seeds the chain with the
digest of those constant tail tokens so the chain stays a pure function
of what the GATEWAY can see — the request prompt — given the replica's
advertised ``(page, first, seed)``.  Only COMPLETE chunks enter the
chain: a trailing partial page's KV is never shared (its page also
receives the row's own decode writes).
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np

__all__ = ["token_bytes", "chunk_digest", "prompt_digests",
           "match_depth"]

_DIGEST_SIZE = 16


def token_bytes(tokens) -> bytes:
    """Canonical byte form of a token sequence (int32 little-endian —
    one encoding on both sides of the wire)."""
    return np.ascontiguousarray(
        np.asarray(tokens, np.int32)).tobytes()


def chunk_digest(parent: bytes, chunk_tokens) -> bytes:
    """Digest of one chunk given its parent chain digest."""
    h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
    h.update(parent)
    h.update(token_bytes(chunk_tokens))
    return h.digest()


def prompt_digests(prompt, page: int, first: int = 0,
                   seed: bytes = b"") -> List[bytes]:
    """The chain digests of every COMPLETE page-aligned chunk of
    ``prompt``: chunk 0 is ``first`` tokens (default: ``page``), the
    rest ``page`` tokens each; the trailing partial chunk (if any) is
    dropped.  ``seed`` is the constant-prefix-tail digest described in
    the module docstring."""
    prompt = np.asarray(prompt, np.int32)
    if page < 1:
        raise ValueError(f"page must be >= 1, got {page}")
    first = first or page
    out: List[bytes] = []
    h = seed
    off, w = 0, first
    while off + w <= prompt.size:
        h = chunk_digest(h, prompt[off:off + w])
        out.append(h)
        off += w
        w = page
    return out


def match_depth(digests: Sequence[bytes], advertised) -> int:
    """Longest leading run of ``digests`` present in ``advertised`` (a
    set/sequence of digests, bytes or hex str): the number of leading
    chunks a replica's cache already holds.  The chain property makes a
    leading-run check sufficient — digest j can only be advertised by a
    cache that stored chunks 0..j."""
    adv = {d if isinstance(d, bytes) else bytes.fromhex(d)
           for d in advertised}
    depth = 0
    for d in digests:
        if d not in adv:
            break
        depth += 1
    return depth
