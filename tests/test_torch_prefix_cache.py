"""The cross-request prefix cache (``prefix_cache_pages``) of the port's
ContinuousBatcher against the JAX batcher on the CPU, over the grid of
``tests/test_serving.py``'s prefix-cache tests: warm vs cold, the COW
full hit, eviction under pressure, the budget, refcounts under churn,
warm admission on a tight pool, the COW falling back shallower, and
with chunked prefill.  Each case runs the same requests through both
batchers (the JAX tiny model's weights, ``convert.params_from_jax``) and
requires the streams, ``prefix_cache_stats()`` and
``prefix_cache_summary()["hashes"]`` equal, beside the reference's own
assertions on the port."""

import jax
import numpy as np
import pytest
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu import serving as js
from tfmesos_tpu.fleet.replica import tiny_model as jax_tiny_model
from tfmesos_tpu_torch import convert, prefixhash
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.models import presets

V = 97


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = jax_tiny_model(seed=0)
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, presets.tiny_model()[0], tparams


def _shared(n, sys_len=36, tail0=5, new=4, seed=21):
    rng = np.random.RandomState(seed)
    system = rng.randint(0, V, size=sys_len).astype(np.int32)
    return [(np.concatenate([system, np.random.RandomState(
        seed + 1 + i).randint(0, V, size=tail0 + i).astype(np.int32)]),
        new) for i in range(n)]


def _distinct(seed0, n, size, new, vary=0):
    return [(np.random.RandomState(seed0 + i).randint(
        0, V, size=size + (i % 3 if vary else 0)).astype(np.int32), new)
        for i in range(n)]


class Pair:
    """A port batcher and a JAX batcher built alike, fed alike."""

    def __init__(self, models, **kw):
        jcfg, jparams, tcfg, tparams = models
        self.t = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
        self.j = js.ContinuousBatcher(jcfg, jparams, **kw)

    def run(self, spec):
        """Streams in rid order, required equal across the two."""
        got = [c.tokens for c in sorted(
            self.t.run(ts.Request(p.copy(), n) for p, n in spec),
            key=lambda c: c.rid)]
        want = [c.tokens for c in sorted(
            self.j.run(js.Request(prompt=p.copy(), max_new_tokens=n)
                       for p, n in spec), key=lambda c: c.rid)]
        assert got == want
        return got

    def stats(self):
        """The port's stats and summary hashes, required equal."""
        st = self.t.prefix_cache_stats()
        assert st == self.j.prefix_cache_stats()
        assert self.t.prefix_cache_summary()["hashes"] == \
            self.j.prefix_cache_summary()["hashes"]
        assert self.t.peak_pages_used == self.j.peak_pages_used
        return st


def _cold(models, spec, **kw):
    jcfg, jparams, tcfg, tparams = models
    b = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    return [c.tokens for c in sorted(
        b.run(ts.Request(p.copy(), n) for p, n in spec),
        key=lambda c: c.rid)]


def test_prefix_cache_exact_vs_cold(models):
    kw = dict(rows=2, max_len=96, page_size=16, prefill_bucket=16)
    pair = Pair(models, prefix_cache_pages=8, **kw)
    assert pair.t.prefix_cache_active
    want = _cold(models, _shared(6), **kw)
    assert pair.run(_shared(6)) == want
    st = pair.stats()
    assert st["hits"] == 5 and st["misses"] == 1 and st["hit_pages"] == 10
    assert pair.run(_shared(6)) == want
    st = pair.stats()
    assert st["hits"] == 11 and st["retained_pages"] == st["cached_pages"]
    assert len(pair.t.alloc.free) + st["cached_pages"] + 1 == \
        pair.t.n_pages
    assert pair.t.alloc.rows == {}
    # The summary's geometry is what the fleet router hashes prompts by.
    s = pair.t.prefix_cache_summary()
    assert (s["page"], s["first"], s["seed"]) == (16, 16, "")
    digs = prefixhash.prompt_digests(_shared(1)[0][0], 16)
    assert {d.hex() for d in digs[:2]} <= set(s["hashes"])


def test_prefix_cache_cow_on_page_aligned_full_hit(models):
    kw = dict(rows=2, max_len=96, page_size=16, prefill_bucket=16)
    prompt = np.random.RandomState(3).randint(0, V, 48).astype(np.int32)
    spec = [(prompt, 20)]
    pair = Pair(models, prefix_cache_pages=8, **kw)
    want = _cold(models, spec, **kw)
    assert pair.run(spec) == want           # miss, publishes
    assert pair.run(spec) == want           # full hit -> COW
    st = pair.stats()
    assert st["cow_copies"] == 1 and st["hits"] == 1
    assert st["hit_tokens"] == 47


def test_prefix_cache_eviction_under_pressure_never_deadlocks(models):
    kw = dict(rows=2, max_len=64, page_size=16, prefill_bucket=16)
    spec = _distinct(50, 10, 33, 4, vary=1)
    pair = Pair(models, prefix_cache_pages=64, **kw)
    assert pair.run(spec) == _cold(models, spec, **kw)
    st = pair.stats()
    assert st["evicted"] > 0
    assert len(pair.t.alloc.free) + st["cached_pages"] + 1 == \
        pair.t.n_pages
    assert pair.t.peak_pages_used <= pair.t.n_pages


def test_prefix_cache_budget_caps_residency(models):
    kw = dict(rows=2, max_len=64, page_size=16, prefill_bucket=16)
    pair = Pair(models, prefix_cache_pages=2, **kw)
    pair.run(_distinct(80, 5, 36, 3))
    st = pair.stats()
    assert st["cached_pages"] <= 2 and st["evicted"] + st["skipped"] > 0


def test_prefix_cache_refcounts_protect_inflight_pages(models):
    kw = dict(rows=2, max_len=64, page_size=16, prefill_bucket=16)
    shared = _shared(3, sys_len=32, new=12, seed=91)
    churn = _distinct(200, 6, 34, 2)
    mix = [shared[0], churn[0], shared[1], churn[1], churn[2], shared[2],
           churn[3], churn[4], churn[5]]
    pair = Pair(models, prefix_cache_pages=64, **kw)
    assert pair.run(mix) == _cold(models, mix, **kw)
    pair.stats()


def test_prefix_cache_warm_admission_never_overcommits(models):
    kw = dict(rows=2, max_len=80, page_size=16, prefill_bucket=16)
    cached = np.random.RandomState(5).randint(0, V, 49).astype(np.int32)
    pair = Pair(models, n_pages=8, prefix_cache_pages=8, **kw)
    pair.run([(cached, 4)])
    st = pair.stats()
    assert st["cached_pages"] == 3 and st["retained_pages"] == 3
    pressure = np.random.RandomState(6).randint(0, V, 60).astype(np.int32)
    spec = [(pressure, 20), (cached, 20)]
    assert pair.run(spec) == _cold(models, spec, **kw)
    pair.stats()


def test_prefix_cache_cow_falls_back_on_tight_pool(models):
    kw = dict(rows=2, max_len=64, page_size=16, prefill_bucket=16,
              n_pages=5)
    prompt = np.random.RandomState(9).randint(0, V, 48).astype(np.int32)
    spec = [(prompt, 16)]
    want = _cold(models, spec, **kw)
    pair = Pair(models, prefix_cache_pages=8, **kw)
    assert pair.run(spec) == want
    assert pair.run(spec) == want
    st = pair.stats()
    assert st["cow_copies"] == 0 and st["hits"] == 1
    assert st["hit_pages"] == 2


def test_prefix_cache_with_chunked_prefill(models):
    kw = dict(rows=2, max_len=96, page_size=16, prefill_chunk=16)
    pair = Pair(models, prefix_cache_pages=8, **kw)
    want = _cold(models, _shared(5), **kw)
    assert pair.run(_shared(5)) == want
    st = pair.stats()
    assert st["hits"] >= 3 and st["hit_pages"] >= 6
    assert pair.run(_shared(5)) == want
    assert pair.stats()["hits"] >= st["hits"] + 5


def test_prefix_cache_bypassed_under_int8_pool(models):
    _, _, tcfg, tparams = models
    b = ts.ContinuousBatcher(tcfg, tparams, rows=2, max_len=64,
                             page_size=16, prefill_bucket=16,
                             quantized_cache=True, prefix_cache_pages=8,
                             device="cpu")
    assert not b.prefix_cache_active
    assert b.prefix_cache_bypass_reason == "quantized kv cache"
    assert b.prefix_cache_stats() is None
    assert b.prefix_cache_summary() is None
    assert len(list(b.run([ts.Request(np.arange(20) % V, 3)]))) == 1


def test_prefix_cache_warmup_names_match_jax(models):
    jcfg, jparams, tcfg, tparams = models
    kw = dict(rows=2, max_len=64, page_size=16, prefill_bucket=16,
              prefix_cache_pages=4)
    jnames = js.ContinuousBatcher(jcfg, jparams, **kw).warmup()["compiled"]
    tb = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    assert tb.warmup()["compiled"] == [
        n for n in jnames
        if n.startswith(("chunk_prefill", "decode", "prefill"))]


def test_prefix_cache_clear_returns_every_page(models):
    """``clear`` drops every resident page back to the free list, and
    refuses while a row still maps one."""
    _, _, tcfg, tparams = models
    b = ts.ContinuousBatcher(tcfg, tparams, rows=2, max_len=96,
                             page_size=16, prefill_bucket=16,
                             prefix_cache_pages=8, device="cpu")
    list(b.run(ts.Request(p, n) for p, n in _shared(3)))
    cached = b.prefix_cache_stats()["cached_pages"]
    assert cached > 0
    free = len(b.alloc.free)
    loop = b.run(ts.Request(p, n) for p, n in _shared(2))
    next(loop)                  # a row maps the system prompt's pages
    with pytest.raises(RuntimeError, match="live row"):
        b._pcache.clear()
    list(loop)
    st = b.prefix_cache_stats()
    assert b._pcache.clear() == st["cached_pages"] >= cached
    after = b.prefix_cache_stats()
    assert after["cached_pages"] == after["retained_pages"] == 0
    assert after["evicted"] == st["evicted"] + st["cached_pages"]
    assert len(b.alloc.free) == b.n_pages - 1 and free < b.n_pages - 1
    assert b._pcache.clear() == 0
