"""The port batcher's static shared ``prefix`` against the JAX batcher
on the CPU (the JAX tiny model's weights via ``convert.params_from_jax``):
the reserved pages, the shared length and the partial-page template are
the reference's; streams are identical in the synchronous tick, the
K-step block, overlap, chunked prefill, the prefix cache and an int8
pool; every stream equals ``generate(prefix=)``; the prefix cache's
chunk geometry (``first``, ``seed``) and digests, and the KV tier's
``prefix_geometry``, follow the reference's rule; export/import
artifacts carry the reference's ``prefix_len`` / ``shared_len`` header
and cross frameworks; warmup names every prompt width below
``max_len - prefix_len``."""

import numpy as np
import pytest
import torch
from torch_parity import jax_compile_cache_off, tiny_models  # noqa: F401

from tfmesos_tpu import serving as js
from tfmesos_tpu.fleet import kvtier as jkv
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.fleet import kvtier as tkv
from tfmesos_tpu_torch.models import transformer as tt

KW = dict(rows=2, max_len=96, page_size=16, prefill_bucket=16)


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def _prefix(n):
    return np.random.RandomState(50 + n).randint(1, 97, size=n).astype(
        np.int32)


def _specs():
    rs = np.random.RandomState(6)
    return [(rs.randint(1, 97, size=n).astype(np.int32), m)
            for n, m in ((5, 8), (19, 6), (3, 11), (27, 7))]


def _pair(models, **kw):
    jcfg, jparams, tcfg, tparams = models
    return (js.ContinuousBatcher(jcfg, jparams, **dict(KW, **kw)),
            ts.ContinuousBatcher(tcfg, tparams, device="cpu",
                                 **dict(KW, **kw)))


def _streams(mod, b, specs):
    return {c.rid: list(c.tokens) for c in b.run(
        mod.Request(p.copy(), n) for p, n in specs)}


@pytest.mark.parametrize("n", [16, 20, 9])
def test_prefix_pages_are_the_references(models, n):
    jb, tb = _pair(models, prefix=_prefix(n))
    for side in ("t_side",):
        j, t = getattr(jb, side), getattr(tb, side)
        assert (t.shared_pages, t.shared_len, t.tail_template, t.sink) == \
            (j.shared_pages, j.shared_len, j.tail_template, j.sink)
    assert (tb.prefix_len, tb.n_pages) == (jb.prefix_len, jb.n_pages)
    assert tb._prefill_widths() == jb._prefill_widths()


MODES = {"sync": {}, "multi_step": dict(multi_step=4),
         "overlap": dict(overlap=True), "chunked": dict(prefill_chunk=16),
         "prefix_cache": dict(prefix_cache_pages=8),
         "int8_pool": dict(quantized_cache=True),
         "pipeline": dict(pipeline_depth=1)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefixed_streams_equal_the_jax_batchers(models, mode):
    pfx = _prefix(20)
    jb, tb = _pair(models, prefix=pfx, **MODES[mode])
    specs = _specs()
    if mode == "prefix_cache":
        specs = specs + [(specs[3][0].copy(), 5)]
    want = _streams(js, jb, specs)
    assert _streams(ts, tb, specs) == want
    if mode == "prefix_cache":
        assert tb.prefix_cache_stats() == jb.prefix_cache_stats()
        assert tb.prefix_cache_summary() == jb.prefix_cache_summary()
        assert tb.prefix_cache_stats()["hits"] >= 1


def test_prefixed_streams_equal_generate_with_the_prefix(models):
    """Each request's stream is ``generate(prefix=)``'s continuation (the
    prefix is invisible but for attention)."""
    _, _, tcfg, tparams = models
    pfx = _prefix(20)
    _, tb = _pair(models, prefix=pfx)
    got = _streams(ts, tb, _specs())
    for rid, (p, n) in enumerate(_specs()):
        out = tt.generate(tcfg, tparams, torch.from_numpy(p)[None], n,
                          prefix=torch.from_numpy(pfx))
        assert got[rid] == out[0, pfx.size + p.size:].tolist()


def test_prefix_cache_geometry_follows_the_references_rule(models):
    """With a partial prefix page the chunk chain starts ``page - off``
    tokens in and is seeded by the partial page's digest: the same
    ``first``/``seed`` and the same digests as the JAX cache, and the KV
    tier's ``prefix_geometry`` says so."""
    pfx = _prefix(20)
    stores = (jkv.KVTierStore(ram_bytes=1 << 20, token="t"),
              tkv.KVTierStore(ram_bytes=1 << 20, token="t"))
    jb, tb = _pair(models, prefix=pfx, prefix_cache_pages=8)
    jb2 = js.ContinuousBatcher(models[0], models[1],
                               **dict(KW, prefix=pfx, prefix_cache_pages=8,
                                      kv_tier=stores[0]))
    tb2 = ts.ContinuousBatcher(models[2], models[3], device="cpu",
                               **dict(KW, prefix=pfx, prefix_cache_pages=8,
                                      kv_tier=stores[1]))
    assert (tb._pcache.first, tb._pcache.seed) == \
        (jb._pcache.first, jb._pcache.seed) == (12, tb._pcache.seed)
    assert stores[1].prefix_geometry == stores[0].prefix_geometry
    assert tb2._pcache.first == jb2._pcache.first
    req = ts.Request(_specs()[3][0], 4)
    assert tb._req_digests(req) == jb._req_digests(
        js.Request(prompt=req.prompt, max_new_tokens=4))


def test_prefixed_artifacts_cross_frameworks(models):
    """A prefixed export carries the reference's header (prefix_len,
    shared_len, pos past the prefix); JAX exports import into the port
    and decode the JAX unified stream, and a batcher with another prefix
    refuses them."""
    pfx = _prefix(20)
    jb, tb = _pair(models, prefix=pfx)
    specs = _specs()
    arts = [jb.export_kv(js.Request(prompt=p.copy(), max_new_tokens=n))
            for p, n in specs]
    port_art = tb.export_kv(ts.Request(specs[0][0].copy(), specs[0][1]))
    for key in ("prefix_len", "shared_len", "pos", "prompt_len",
                "first_token", "step"):
        assert port_art[key] == arts[0][key], key
    assert port_art["k"].shape == arts[0]["k"].shape
    imp = ts.ContinuousBatcher(models[2], models[3], device="cpu",
                               **dict(KW, prefix=pfx))
    got = {c.rid: list(c.tokens) for c in imp.run(
        ts.Prefilled(ts.Request(p.copy(), n), ts.unpack_prefilled(
            *js.pack_prefilled(a)))
        for (p, n), a in zip(specs, arts))}
    want = _streams(js, js.ContinuousBatcher(
        models[0], models[1], **dict(KW, prefix=pfx)), specs)
    assert got == want
    other = ts.ContinuousBatcher(models[2], models[3], device="cpu",
                                 **dict(KW, prefix=_prefix(16)))
    with pytest.raises(ValueError, match="prefix_len"):
        other.validate(ts.Prefilled(ts.Request(specs[0][0], 4),
                                    ts.unpack_prefilled(
                                        *js.pack_prefilled(arts[0]))))


def test_prefixed_warmup_names_every_width(models):
    jb, tb = _pair(models, prefix=_prefix(20))
    names = tb.warmup()["compiled"]
    assert [n for n in names if n.startswith("prefill[")] == [
        f"prefill[{w}]" for w in jb._prefill_widths()]
    assert jb._prefill_widths()[-1] <= KW["max_len"] - 20


def test_prefix_validation_errors(models):
    _, _, tcfg, tparams = models
    for bad, what in ((np.zeros((0,), np.int32), "non-empty"),
                      (np.ones((96,), np.int32), "leaves no room")):
        with pytest.raises(ValueError, match=what):
            ts.ContinuousBatcher(tcfg, tparams, device="cpu",
                                 **dict(KW, prefix=bad))
