"""Speculative rows moving between batchers, the port's against the JAX
package's on the CPU: export/import artifacts carry the draft pool's
paired pages (``dk``/``dv`` and the ``draft`` header) byte-compatibly in
both directions (JAX -> port -> JAX and back, bit for bit), an imported
spec export decodes the exporter's stream, a draftless prefill
artifact imported by a speculative batcher rebuilds the draft's prompt
KV, the draft validation refuses what the reference refuses with its
messages, ``preempt_all`` suspends spec rows that resume in either
framework token-identically, and a speculative batcher's sessions park
and resume, and its prefix pages spill and promote, with both pools'
pages, as the JAX batcher's do."""

import numpy as np
import pytest
from torch_parity import (jax_compile_cache_off,  # noqa: F401
                          tiny_draft_params, tiny_models)

from tfmesos_tpu import serving as js
from tfmesos_tpu.fleet import kvtier as jkv
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.fleet import kvtier as tkv
from tfmesos_tpu_torch.models import presets

K = 3
KW = dict(rows=2, max_len=64, page_size=16, prefill_bucket=16, n_draft=K)


@pytest.fixture(scope="module")
def models():
    jcfg, jparams, tcfg, tparams = tiny_models()
    jdcfg, jdparams, tdparams = tiny_draft_params(max_len=64, n_draft=K)
    tdcfg = presets.tiny_draft_model(max_len=64, n_draft=K)[0]
    return dict(jax=(jcfg, jparams, jdcfg, jdparams),
                port=(tcfg, tparams, tdcfg, tdparams))


def _batcher(models, side, draft=True, **kw):
    cfg, params, dcfg, dparams = models[side]
    kw = dict(KW, **kw)
    if draft:
        kw.update(draft_cfg=dcfg, draft_params=dparams)
    else:
        kw.pop("n_draft")
    mod = js if side == "jax" else ts
    extra = {} if side == "jax" else {"device": "cpu"}
    return mod.ContinuousBatcher(cfg, params, **kw, **extra)


def _mod(side):
    return js if side == "jax" else ts


def _prompts():
    rs = np.random.RandomState(21)
    return [(rs.randint(1, 97, size=n).astype(np.int32), m)
            for n, m in ((7, 8), (20, 6), (33, 9))]


def _reexport(b, side, art, req):
    """Install ``art`` into row 0 of ``b`` and export that row again."""
    mod = _mod(side)
    active = {}
    wt, wd, need = b._worst_pages(req)
    res = b._admit_import(0, mod.Prefilled(req, art), wt, wd, need, active)
    first = res[2] if side == "port" else int(res[2][0])
    active[0].out = [first] if not active[0].out else active[0].out
    try:
        return b._export_row(0, active[0])
    finally:
        b._finish(0, active, [])


def _packed(side, art):
    meta, body = _mod(side).pack_prefilled(art)
    return meta, bytes(body)


@pytest.mark.parametrize("kind", ["bf16_pool", "draft_int8"])
def test_spec_artifacts_cross_frameworks_bit_exact(models, kind):
    """A JAX spec export re-exported by the port packs to the JAX bytes,
    and a port spec export re-exported by JAX packs to the port's."""
    kw = dict(draft_quantized_cache=True) if kind == "draft_int8" else {}
    for src, dst in (("jax", "port"), ("port", "jax")):
        a = _batcher(models, src, **kw)
        b = _batcher(models, dst, **kw)
        for p, n in _prompts():
            req = _mod(src).Request(p.copy(), n)
            art = a.export_kv(req)
            assert art["draft"] == {"n_layers": 1, "kv_heads": 2,
                                    "head_dim": 8,
                                    "quantized": bool(kw), "n_draft": K}
            meta, body = _packed(src, art)
            back = _mod(dst).unpack_prefilled(meta, body)
            again = _reexport(b, dst, back, _mod(dst).Request(p.copy(), n))
            assert _packed(dst, again) == (meta, body)


def test_imported_spec_export_decodes_the_exporters_stream(models):
    """A JAX spec batcher's exports imported by a port spec batcher
    decode the JAX unified spec batcher's streams, and the other way
    round."""
    specs = _prompts()
    for src, dst in (("jax", "port"), ("port", "jax")):
        exp = _batcher(models, src)
        arts = [exp.export_kv(_mod(src).Request(p.copy(), n))
                for p, n in specs]
        imp = _batcher(models, dst)
        mod = _mod(dst)
        got = {c.rid: list(c.tokens) for c in imp.run(
            mod.Prefilled(mod.Request(p.copy(), n),
                          mod.unpack_prefilled(*_packed(src, art)))
            for (p, n), art in zip(specs, arts))}
        uni = _batcher(models, src)
        want = {c.rid: list(c.tokens) for c in uni.run(
            _mod(src).Request(p.copy(), n) for p, n in specs)}
        assert got == want


def test_draftless_prefill_artifact_feeds_a_spec_batcher(models):
    """A draftless prefill tier's fresh artifact imported by a
    speculative batcher rebuilds the draft's prompt KV: the port decodes
    the JAX spec batcher's import of the same artifact, non-chunked and
    chunked."""
    specs = _prompts()
    for extra in ({}, dict(prefill_chunk=16)):
        exp = _batcher(models, "jax", draft=False, **extra)
        arts = [exp.export_kv(js.Request(p.copy(), n)) for p, n in specs]
        streams = {}
        for side in ("jax", "port"):
            b = _batcher(models, side, **extra)
            mod = _mod(side)
            streams[side] = {c.rid: list(c.tokens) for c in b.run(
                mod.Prefilled(mod.Request(p.copy(), n),
                              mod.unpack_prefilled(*_packed("jax", art)))
                for (p, n), art in zip(specs, arts))}
            assert b.spec_rounds > 0
        assert streams["port"] == streams["jax"]


def test_draft_validation_refuses_as_the_reference(models):
    p, n = _prompts()[0]
    spec_art = _batcher(models, "port").export_kv(ts.Request(p.copy(), n))
    plain_art = _batcher(models, "port", draft=False).export_kv(
        ts.Request(p.copy(), n))
    cases = [
        ("draftless_gets_draft", False, spec_art, {}),
        ("no_payload_mid_stream", True, plain_art,
         dict(step=2, tokens=[plain_art["first_token"], 5], pos=8)),
        ("no_header", True, spec_art, dict(draft=None)),
        ("n_draft", True, spec_art,
         dict(draft=dict(spec_art["draft"], n_draft=K + 1))),
        ("dk_shape", True, spec_art, dict(dk=spec_art["dk"][:, :0])),
    ]
    for name, draft, art, patch in cases:
        errs = {}
        for side in ("jax", "port"):
            meta, body = _packed("port", art)
            back = _mod(side).unpack_prefilled(meta, body)
            back.update(patch)
            b = _batcher(models, side, draft=draft)
            req = _mod(side).Request(p.copy(), n)
            with pytest.raises(ValueError) as e:
                b.validate(_mod(side).Prefilled(req, back))
            errs[side] = str(e.value)
        if name != "dk_shape":      # numpy's shape repr, not the port's
            assert errs["port"] == errs["jax"], name


def test_preempted_spec_rows_resume_in_either_framework(models):
    """``preempt_all`` mid-stream gives back spec rows with both pools'
    pages; each resumes token-identically on a port and on a JAX spec
    batcher (the uninterrupted stream)."""
    specs = [(p, 14) for p, _ in _prompts()]
    uni = _batcher(models, "port", rows=3)
    want = {c.rid: list(c.tokens) for c in uni.run(
        ts.Request(p.copy(), n) for p, n in specs)}
    b = _batcher(models, "port", rows=3)
    reqs = [ts.Request(p.copy(), n) for p, n in specs]

    def on_tokens(toks, off):
        if off + len(toks) >= 4:
            b.preempt_all()

    reqs[0].on_tokens = on_tokens
    out = list(b.run(reqs))
    suspended = [s for s in out if isinstance(s, ts.Suspended)]
    assert len(suspended) == 3
    assert all(s.artifact is not None and s.artifact["step"] > 1
               and "dk" in s.artifact for s in suspended)
    for side in ("port", "jax"):
        r = _batcher(models, side, rows=3)
        mod = _mod(side)
        got = {c.rid: list(c.tokens) for c in r.run(
            mod.Prefilled(mod.Request(s.request.prompt.copy(),
                                      s.request.max_new_tokens),
                          mod.unpack_prefilled(*_packed("port",
                                                        s.artifact)))
            for s in suspended)}
        assert got == want, side


def _converse(side, b, store, turns=3):
    mod = _mod(side)
    rs = np.random.RandomState(4)
    hist = [int(t) for t in rs.randint(1, 97, size=18)]
    replies = []
    for turn in range(turns):
        (c,) = list(b.run([mod.Request(np.asarray(hist, np.int32), 5,
                                       session_id="s1")]))
        replies.append(list(c.tokens))
        hist += list(c.tokens) + [int(t) for t in
                                  rs.randint(1, 97, size=3 + turn)]
    st = store.stats()
    return replies, (st["park"], st["resume"])


def test_spec_sessions_park_and_resume_as_jax(models):
    out = {}
    for side in ("jax", "port"):
        kv = jkv if side == "jax" else tkv
        store = kv.KVTierStore(ram_bytes=8 << 20, token="t")
        b = _batcher(models, side, kv_tier=store)
        out[side] = _converse(side, b, store)
    assert out["port"] == out["jax"]
    assert out["port"][1] == (3, 2)


def test_spec_prefix_pages_spill_and_promote_as_jax(models):
    """A 2-page prefix cache over a tier: evicted target pages spill with
    their draft twins and promote back into both pools; streams, cache
    and tier counters equal the JAX batcher's."""
    rs = np.random.RandomState(8)
    shared = rs.randint(1, 97, size=34).astype(np.int32)
    other = rs.randint(1, 97, size=34).astype(np.int32)
    seq = [shared, other, shared, other]
    out = {}
    for side in ("jax", "port"):
        kv = jkv if side == "jax" else tkv
        mod = _mod(side)
        store = kv.KVTierStore(ram_bytes=8 << 20, token="t")
        b = _batcher(models, side, kv_tier=store, prefix_cache_pages=2)
        toks = [list(c.tokens) for p in seq
                for c in b.run([mod.Request(p.copy(), 4)])]
        st = store.stats()
        out[side] = (toks, b.prefix_cache_stats(), st["promotions"],
                     st.get("spills", st.get("put_prefix")))
    assert out["port"] == out["jax"]
    assert out["port"][2] > 0
