"""The port batcher's KV tier (``kv_tier``) against the JAX batcher on
the CPU, over the grid of ``tests/test_serving.py``'s tier tests: a
conversation parked and resumed turn after turn is token-identical to a
cold full-history prefill and to the JAX batcher over a JAX store, in
every decode mode that parks; every miss path prefills cold; evicted
prefix pages spill and promote back exactly, with the reclaim
accounting of the reference; an oversized park is an explicit
rejection; an int8 pool bypasses the tier as the reference's registry
says; a session parked by either framework resumes in the other through
a shared disk tier; and the prefix cache's eviction seam and the tier's
warmup widening.  Weights are the JAX tiny model's
(``convert.params_from_jax``)."""

import numpy as np
import pytest
from torch_parity import jax_compile_cache_off, tiny_models  # noqa: F401

from tfmesos_tpu import serving as js
from tfmesos_tpu.fleet import kvtier as jkv
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.fleet import kvtier as tkv

V = 97
KW = dict(rows=2, max_len=128, page_size=16, prefill_bucket=16)


class Side:
    """One framework's batcher module, store module and model."""

    def __init__(self, name, cfg, params):
        self.name, self.cfg, self.params = name, cfg, params
        self.serving = js if name == "jax" else ts
        self.kvtier = jkv if name == "jax" else tkv

    def batcher(self, **kw):
        extra = {} if self.name == "jax" else {"device": "cpu"}
        return self.serving.ContinuousBatcher(self.cfg, self.params,
                                              **dict(KW, **kw), **extra)

    def store(self, **kw):
        kw.setdefault("ram_bytes", 8 << 20)
        kw.setdefault("token", "t")
        return self.kvtier.KVTierStore(**kw)

    def turn(self, batcher, prompt, new, session=None):
        (c,) = list(batcher.run([self.serving.Request(
            np.asarray(prompt, np.int32), new, session_id=session)]))
        return list(c.tokens)


@pytest.fixture(scope="module")
def sides():
    jcfg, jparams, tcfg, tparams = tiny_models()
    return Side("jax", jcfg, jparams), Side("port", tcfg, tparams)


@pytest.fixture(scope="module")
def cold(sides):
    """Cold full-history prefills, one batcher a framework for the whole
    module (the JAX one compiles once): ``cold(side, prompt, new)``."""
    made = {}

    def run(side, prompt, new):
        if side.name not in made:
            made[side.name] = side.batcher()
        return side.turn(made[side.name], prompt, new)

    return run


def converse(run, seed=3, turns=3, first=24, new=6, extra=5):
    """A conversation of ``turns`` resumed turns after the first: each
    prompt is the history so far (prompts and replies) plus new tokens.
    ``run(prompt, new)`` -> the reply; returns (prompts, replies)."""
    rng = np.random.RandomState(seed)
    hist = [int(t) for t in rng.randint(0, V, size=first)]
    prompts, replies = [list(hist)], [run(hist, new)]
    for turn in range(turns):
        hist += replies[-1] + [int(t) for t in
                               rng.randint(0, V, size=extra + turn)]
        prompts.append(list(hist))
        replies.append(run(hist, new))
    return prompts, replies


@pytest.fixture(scope="module")
def golden(sides):
    """The JAX batcher over a JAX store, synchronous tick: the replies
    and the store's park / resume counts."""
    jax_side = sides[0]
    store = jax_side.store()
    b = jax_side.batcher(kv_tier=store)
    prompts, replies = converse(
        lambda p, n: jax_side.turn(b, p, n, session="conv"))
    st = store.stats()
    return prompts, replies, (st["park"], st["resume"])


MODES = {"sync": {}, "overlap": {"overlap": True},
         "pipeline_depth=1": {"pipeline_depth": 1},
         "multi_step=4": {"multi_step": 4},
         # A lagged K-step block runs past the quota: the host's pos
         # overshoots the committed stream, and the park clamps it.
         "overlap+multi_step=4": {"overlap": True, "multi_step": 4},
         "pipeline_depth=1+multi_step=4": {"pipeline_depth": 1,
                                           "multi_step": 4},
         "prefill_chunk=16": {"prefill_chunk": 16},
         "fused_prefill": {"prefill_chunk": 16, "fused_prefill": True}}


@pytest.mark.parametrize("mode", MODES)
def test_session_resume_matches_cold_and_jax(mode, sides, cold, golden):
    """Three resumed turns on the port: each reply equals the port's and
    the JAX batcher's cold full-history prefill and the JAX batcher's own
    resumed turn; the port parks 4 and resumes 3 as the JAX store
    counts, with no full prefill after the first turn, and the pool
    drains to the sink page."""
    _, port = sides
    store = port.store()
    b = port.batcher(kv_tier=store, **MODES[mode])
    assert b.kv_tier_bypass_reason is None
    prompts, replies = converse(
        lambda p, n: port.turn(b, p, n, session="conv"))
    want_prompts, want_replies, want_counts = golden
    assert (prompts, replies) == (want_prompts, want_replies)
    for p, r in zip(prompts, replies):
        assert r == cold(port, p, 6) == cold(sides[0], p, 6)
    st = store.stats()
    assert (st["park"], st["resume"]) == want_counts == (4, 3)
    # Only the first turn prefills its prompt (24 tokens: one call, or
    # two chunks of 16); each resumed turn is one tail call.
    assert (b.prefills, b.prefill_chunks) == \
        ((0, 2) if "prefill_chunk" in MODES[mode] else (1, 0))
    assert b.tail_prefills == 3
    assert b.alloc.rows == {}
    assert len(b.alloc.free) == b.n_pages - 1


def _miss_setup(kind, side, tmp_path):
    """(parking batcher, resuming batcher, the resuming batcher's store)
    for one miss path."""
    if kind in ("unknown", "diverged", "short"):
        store = side.store()
        b = side.batcher(kv_tier=store)
        return b, b, store
    if kind == "version":
        park = side.store(ram_bytes=0, disk_dir=str(tmp_path),
                          disk_bytes=1 << 20,
                          stamp={"weights_version": "v1"})
        read = side.store(ram_bytes=0, disk_dir=str(tmp_path),
                          disk_bytes=1 << 20,
                          stamp={"weights_version": "v2"})
        return (side.batcher(kv_tier=park), side.batcher(kv_tier=read),
                read)
    if kind == "corrupt":
        store = side.store(ram_bytes=0, disk_dir=str(tmp_path),
                           disk_bytes=1 << 20)
        b = side.batcher(kv_tier=store)
        return b, b, store
    assert kind == "geometry"
    park = side.store(ram_bytes=0, disk_dir=str(tmp_path),
                      disk_bytes=1 << 20)
    read = side.store(ram_bytes=0, disk_dir=str(tmp_path),
                      disk_bytes=1 << 20)
    return (side.batcher(kv_tier=park),
            side.batcher(kv_tier=read, page_size=8, prefill_bucket=8),
            read)


@pytest.mark.parametrize("kind", ["unknown", "diverged", "short", "version",
                                  "corrupt", "geometry"])
def test_session_miss_paths_fall_back_cold(kind, sides, cold, tmp_path):
    """An unknown id, a prompt that diverges from the parked history, a
    prompt shorter than it, another weights_version, a corrupt disk
    entry and another page geometry each prefill cold: the reply equals
    the cold one (and the JAX batcher's), and nothing counts a
    resume."""
    _, port = sides
    parker, resumer, store = _miss_setup(kind, port, tmp_path)
    rng = np.random.RandomState(5)
    p1 = [int(t) for t in rng.randint(0, V, size=20)]
    r1 = port.turn(parker, p1, 4, session="conv")
    if kind == "diverged":
        p2 = [int(t) for t in rng.randint(0, V, size=30)]
    elif kind == "short":
        p2 = p1[:-3]
    else:
        p2 = p1 + r1 + [int(t) for t in rng.randint(0, V, size=4)]
    if kind == "corrupt":
        (path,) = [p for p in tmp_path.iterdir() if p.name.endswith(".kvt")]
        blob = bytearray(path.read_bytes())
        blob[len(blob) // 2] ^= 0x40
        path.write_bytes(bytes(blob))
    got = port.turn(resumer, p2, 4,
                    session="other" if kind == "unknown" else "conv")
    assert got == cold(port, p2, 4) == cold(sides[0], p2, 4)
    st = store.stats()
    assert st["resume"] == 0
    assert resumer.tail_prefills == 0
    assert st["version_miss"] == (1 if kind == "version" else 0)
    assert st["corrupt"] == (1 if kind == "corrupt" else 0)


@pytest.mark.parametrize("kind", ["session", "prefix"])
def test_tail_and_cold_prefill_in_one_admission_burst(kind, sides, cold):
    """A tail admission (a session resume, or a prefix-cache hit) and a
    cold prefill queued online before the loop starts are admitted in
    one burst, their first tokens fetched in one sync: both replies
    equal the cold ones and the JAX batcher's."""
    rng = np.random.RandomState(13)
    p1 = [int(t) for t in rng.randint(0, V, size=40)]
    q = [int(t) for t in rng.randint(0, V, size=20)]
    extra = [int(t) for t in rng.randint(0, V, size=10)]
    got = {}
    for side in sides:
        kw = ({"kv_tier": side.store()} if kind == "session"
              else {"prefix_cache_pages": 16})
        b = side.batcher(**kw)
        sid = "conv" if kind == "session" else None
        r1 = side.turn(b, p1, 4, session=sid)
        p2 = (p1 + r1 if kind == "session" else p1[:32]) + extra
        reqs = [side.serving.Request(np.asarray(p2, np.int32), 4,
                                     session_id=sid),
                side.serving.Request(np.asarray(q, np.int32), 4)]
        for r in reqs:
            b.submit(r)
        b.close()
        by = {id(c.request): list(c.tokens) for c in b.serve()}
        got[side.name] = [by[id(r)] for r in reqs]
        assert got[side.name] == [cold(side, p2, 4), cold(side, q, 4)]
    assert (b.prefills, b.tail_prefills) == (2, 1)
    assert got["port"] == got["jax"]


def _spill_requests(side):
    return [side.serving.Request(
        prompt=np.random.RandomState(50 + i).randint(
            0, V, size=33 + (i % 3)).astype(np.int32), max_new_tokens=4)
        for i in range(10)]


def _in_order(batcher, reqs):
    return [t for _, t in sorted((c.rid, list(c.tokens))
                                 for c in batcher.run(reqs))]


@pytest.mark.parametrize("chunk", [None, 16])
def test_spill_promote_exact_with_reclaim_accounting(chunk, sides):
    """Under allocation pressure evicted prefix pages spill to the tier
    and promote back at the next matching admission: both passes' streams
    equal the cold batcher's and the JAX batcher's, the spill, promotion
    and eviction counts are the JAX batcher's, and the pool balances
    (free + cached + sink = all pages)."""
    kw = dict(max_len=64)
    if chunk:
        kw["prefill_chunk"] = chunk
    counts, streams = {}, {}
    for side in sides:
        cold_b = side.batcher(**kw)
        want = _in_order(cold_b, _spill_requests(side))
        tier = side.store()
        warm = side.batcher(prefix_cache_pages=64, kv_tier=tier, **kw)
        first = _in_order(warm, _spill_requests(side))
        st1, ts1 = warm.prefix_cache_stats(), tier.stats()
        second = _in_order(warm, _spill_requests(side))
        st, tst = warm.prefix_cache_stats(), tier.stats()
        assert first == want and second == want
        assert st1["evicted"] > 0 and ts1["spills"] == st1["evicted"]
        assert tst["promotions"] > 0 and st["promoted"] == tst["promotions"]
        assert len(warm.alloc.free) + st["cached_pages"] + 1 == warm.n_pages
        assert warm.peak_pages_used <= warm.n_pages
        assert warm.alloc.rows == {}
        streams[side.name] = want
        counts[side.name] = (st["evicted"], st["promoted"], st["hits"],
                             tst["spills"], tst["promotions"])
    assert streams["port"] == streams["jax"]
    assert counts["port"] == counts["jax"]


def test_park_rejection_is_explicit(sides, cold):
    """A tier too small for the artifact rejects the park (counted) and
    the completion stands; the next turn prefills cold."""
    for side in sides:
        tier = side.store(ram_bytes=64)
        warm = side.batcher(kv_tier=tier)
        rng = np.random.RandomState(9)
        p1 = [int(t) for t in rng.randint(0, V, size=30)]
        r1 = side.turn(warm, p1, 5, session="conv")
        assert r1 == cold(side, p1, 5)
        st = tier.stats()
        assert (st["park_rejected"], st["park"]) == (1, 0)
        p2 = p1 + r1
        assert side.turn(warm, p2, 4, session="conv") == cold(side, p2, 4)
        assert tier.stats()["resume"] == 0


def test_int8_pool_bypasses_the_tier_as_the_reference(sides):
    """The bypass comes from the reference's registry: an int8 pool
    records "quantized kv cache", installs no spill hook, parks nothing
    and still serves session-labelled requests."""
    reasons = {}
    for side in sides:
        plain = side.batcher(kv_tier=side.store(), prefix_cache_pages=8)
        tier = side.store()
        q = side.batcher(quantized_cache=True, kv_tier=tier,
                         prefix_cache_pages=8)
        reasons[side.name] = (plain.kv_tier_bypass_reason,
                              q.kv_tier_bypass_reason)
        assert plain._pcache.on_evict is not None
        assert q._pcache is None
        p = np.random.RandomState(2).randint(0, V, size=9)
        assert len(side.turn(q, p, 3, session="s")) == 3
        assert tier.stats()["park"] == 0
    assert reasons["port"] == reasons["jax"] == (None, "quantized kv cache")
    assert ts.compute_bypass_reasons(quantized_cache=True)["kv_tier"] \
        == js.compute_bypass_reasons(quantized_cache=True)["kv_tier"]


@pytest.mark.parametrize("parker", ["jax", "port"])
def test_session_resumes_across_frameworks(parker, sides, cold, tmp_path):
    """A session parked by one framework's batcher in a disk tier resumes
    in the other's (same directory, same token): the resumed turn equals
    both frameworks' cold prefill, and the resuming store counts the
    resume."""
    a, b = sides if parker == "jax" else sides[::-1]
    store_a = a.store(ram_bytes=0, disk_dir=str(tmp_path),
                      disk_bytes=8 << 20)
    store_b = b.store(disk_dir=str(tmp_path), disk_bytes=8 << 20)
    batcher_a, batcher_b = a.batcher(kv_tier=store_a), \
        b.batcher(kv_tier=store_b)
    rng = np.random.RandomState(7)
    p1 = [int(t) for t in rng.randint(0, V, size=37)]
    r1 = a.turn(batcher_a, p1, 6, session="conv")
    assert store_a.stats()["park"] == 1
    p2 = p1 + r1 + [int(t) for t in rng.randint(0, V, size=9)]
    r2 = b.turn(batcher_b, p2, 6, session="conv")
    assert r2 == cold(a, p2, 6) == cold(b, p2, 6)
    st = store_b.stats()
    assert st["resume"] == 1 and st["hits"] == 1
    if b.name == "port":
        assert batcher_b.tail_prefills == 1


def test_spilled_jax_pages_promote_in_the_port(sides, tmp_path):
    """Prefix pages the JAX batcher spilled to a shared disk tier promote
    into the port's pool (the spilled pages' geometry and bytes are the
    reference's): the port's streams equal its cold ones with every
    shared page a promotion."""
    jax_side, port = sides
    system = np.random.RandomState(31).randint(0, V, size=48)

    def reqs(side, seed):
        return [side.serving.Request(np.concatenate([system, np.random.
                RandomState(seed + i).randint(0, V, size=5 + i)]).astype(
                    np.int32), 4) for i in range(2)]

    jstore = jax_side.store(ram_bytes=0, disk_dir=str(tmp_path),
                            disk_bytes=8 << 20)
    jb = jax_side.batcher(prefix_cache_pages=3, kv_tier=jstore, max_len=64)
    _in_order(jb, reqs(jax_side, 40))
    # Another prompt family fills the 3-page budget: the system pages
    # spill to the directory.
    _in_order(jb, [jax_side.serving.Request(np.random.RandomState(60 + i)
                                            .randint(0, V, size=52).astype(
                                                np.int32), 2)
                   for i in range(2)])
    assert jstore.stats()["spills"] >= 3
    tstore = port.store(disk_dir=str(tmp_path), disk_bytes=8 << 20)
    tb = port.batcher(prefix_cache_pages=8, kv_tier=tstore, max_len=64)
    got = _in_order(tb, reqs(port, 80))
    want = _in_order(port.batcher(max_len=64), reqs(port, 80))
    assert got == want
    assert tstore.stats()["promotions"] == 3
    assert tb.prefix_cache_stats()["hit_pages"] >= 3


# -- the prefix cache's eviction seam ----------------------------------------


def _seam_batcher(port):
    """A 2-page prefix cache: the spill requests' pages evict each
    other's."""
    return port.batcher(prefix_cache_pages=2, max_len=64)


def test_on_evict_runs_before_the_page_frees(sides):
    """``on_evict(shard, digest, page)`` sees the evicted node's page
    while it is still off the free list."""
    _, port = sides
    b, seen = _seam_batcher(port), []

    def hook(shard, digest, page):
        seen.append((shard, digest, page, page in b.alloc.free))

    b._pcache.on_evict = hook
    _in_order(b, _spill_requests(port)[:4])
    assert seen and b._pcache.stats()["evicted"] == len(seen)
    assert all(s == 0 and isinstance(d, bytes) and not free
               for s, d, _, free in seen)


def test_raising_on_evict_never_blocks_an_eviction(sides):
    _, port = sides
    b = _seam_batcher(port)
    ref = _in_order(port.batcher(max_len=64), _spill_requests(port)[:6])

    def hook(shard, digest, page):
        raise RuntimeError("spill failed")

    b._pcache.on_evict = hook
    assert _in_order(b, _spill_requests(port)[:6]) == ref
    st = b._pcache.stats()
    assert st["evicted"] > 0
    assert len(b.alloc.free) + st["cached_pages"] + 1 == b.n_pages


def test_clear_does_not_spill(sides):
    _, port = sides
    tier = port.store()
    b = port.batcher(prefix_cache_pages=8, kv_tier=tier, max_len=64)
    _in_order(b, _spill_requests(port)[:2])
    assert b._pcache.stats()["cached_pages"] > 0
    assert b._pcache.clear() > 0
    assert tier.stats()["spills"] == 0


# -- warmup with a tier -------------------------------------------------------


@pytest.mark.parametrize("chunk", [None, 16])
def test_tier_warmup_covers_every_session_tail(chunk, sides, monkeypatch):
    """A tier alone (no prefix cache) warms the tail call at every prefill
    width and every table width its start can take, under the
    reference's names; a conversation served after warmup captures
    nothing new (the card's graphs through a stub capture)."""
    from test_torch_warmup import _stub_graphs

    _, port = sides
    kw = {"prefill_chunk": chunk} if chunk else {}
    b = port.batcher(kv_tier=port.store(), **kw)
    b._graphs, _ = _stub_graphs(monkeypatch)
    names = b.warmup()["compiled"]
    tails = [f"chunk_prefill[{t}]" for t in b._prefill_widths()]
    assert [n for n in names if n.startswith("chunk_prefill")] == tails
    warmed = b._graphs.keys()
    assert {("chunk", t, w) for t in b._prefill_widths()
            for w in b._tail_widths(t)} <= warmed
    converse(lambda p, n: port.turn(b, p, n, session="conv"))
    assert b.tail_prefills == 3
    assert b._graphs.keys() == warmed
