"""Disaggregated KV export/import of the port's ContinuousBatcher across
frameworks, on the CPU: a port ``export_kv`` artifact imported by the
JAX batcher and a JAX artifact imported by the port, each through
``pack_prefilled`` bytes, decode greedy streams equal to the unified
batcher's (float32, and over int8 pools); bf16 and int8 page bytes
round-trip bit-exact through the other side's import and re-export; and
``_validate_artifact`` rejects what the reference rejects."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu import serving as js
from tfmesos_tpu.fleet.replica import tiny_model as jax_tiny_model
from tfmesos_tpu_torch import convert
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.models import presets

KW = dict(rows=2, max_len=64, page_size=16, prefill_bucket=16)
SPEC = [(5, 6), (19, 9), (33, 4)]       # (prompt length, new tokens)


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = jax_tiny_model(seed=0)
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, presets.tiny_model()[0], tparams


def _prompts():
    rng = np.random.RandomState(41)
    return [(rng.randint(0, 97, n).astype(np.int32), new)
            for n, new in SPEC]


def _cross(art, pack, unpack):
    """``art`` through the wire encoding: packed by its own side, the
    meta through JSON, unpacked by the other side."""
    meta, body = pack(art)
    return unpack(json.loads(json.dumps(meta)), bytes(body))


@pytest.mark.parametrize("int8", [False, True])
def test_port_export_imports_into_jax(models, int8):
    jcfg, jparams, tcfg, tparams = models
    kw = dict(KW, quantized_cache=int8)
    exp = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    arts = [exp.export_kv(ts.Request(p, n)) for p, n in _prompts()]
    assert exp.alloc.rows == {}
    imp = js.ContinuousBatcher(jcfg, jparams, **kw)
    got = {c.rid: c.tokens for c in imp.run(
        js.Prefilled(js.Request(prompt=p, max_new_tokens=n),
                     _cross(a, ts.pack_prefilled,
                            js.unpack_prefilled))
        for (p, n), a in zip(_prompts(), arts))}
    uni = js.ContinuousBatcher(jcfg, jparams, **kw)
    want = {c.rid: c.tokens for c in uni.run(
        js.Request(prompt=p, max_new_tokens=n) for p, n in _prompts())}
    assert got == want


@pytest.mark.parametrize("int8", [False, True])
def test_jax_export_imports_into_port(models, int8):
    jcfg, jparams, tcfg, tparams = models
    kw = dict(KW, quantized_cache=int8)
    exp = js.ContinuousBatcher(jcfg, jparams, **kw)
    arts = [exp.export_kv(js.Request(prompt=p, max_new_tokens=n))
            for p, n in _prompts()]
    imp = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    for (p, n), a in zip(_prompts(), arts):
        imp.submit(ts.Request(p, n), prefilled=_cross(
            a, js.pack_prefilled, ts.unpack_prefilled))
    imp.close()
    got = {c.rid: c.tokens for c in imp.serve()}
    uni = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    want = {c.rid: c.tokens for c in uni.run(
        ts.Request(p, n) for p, n in _prompts())}
    assert got == want
    assert imp.alloc.rows == {}


def _reexport_port(b, art, req):
    """Install ``art`` into a port row and export that row again."""
    active = {}
    wt, wd, need = b._worst_pages(req)
    row, state, first = b._admit_import(0, ts.Prefilled(req, art), wt,
                                        wd, need, active)
    state.out = [first]                 # what the burst's sync records
    try:
        return b._export_row(row, active[row])
    finally:
        b._finish(row, active, [])


def _reexport_jax(b, art, req):
    active = {}
    wt, wd, need = b._worst_pages(req)
    row, state, first, _ = b._admit_import(0, js.Prefilled(req, art), wt,
                                           wd, need, active)
    state.out = [int(first[0])]
    try:
        return b._export_row(row, active[row])
    finally:
        b._finish(row, active, [])


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_artifact_bytes_round_trip_bit_exact(models, kind):
    jcfg, jparams, tcfg, tparams = models
    int8 = kind == "int8"
    if not int8:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    kw = dict(KW, quantized_cache=int8)
    jb = js.ContinuousBatcher(jcfg, jparams, **kw)
    tb = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    p, n = _prompts()[1]
    # JAX -> port -> JAX bytes.
    jmeta, jbody = js.pack_prefilled(jb.export_kv(
        js.Request(prompt=p, max_new_tokens=n)))
    art = ts.unpack_prefilled(dict(jmeta), bytes(jbody))
    if not int8:
        assert art["k"].dtype == torch.bfloat16
    tmeta, tbody = ts.pack_prefilled(_reexport_port(tb, art,
                                                    ts.Request(p, n)))
    assert tmeta == jmeta and bytes(tbody) == bytes(jbody)
    # port -> JAX -> port bytes.
    tmeta, tbody = ts.pack_prefilled(tb.export_kv(ts.Request(p, n)))
    art = js.unpack_prefilled(dict(tmeta), bytes(tbody))
    jmeta, jbody = js.pack_prefilled(_reexport_jax(
        jb, art, js.Request(prompt=p, max_new_tokens=n)))
    assert jmeta == tmeta and bytes(jbody) == bytes(tbody)
    assert [s["dtype"] for s in tmeta["arrays"]] == (
        ["int8", "int8", "float32", "float32"] if int8
        else ["bfloat16", "bfloat16"])


def _mutations(art):
    k = art["k"]
    yield "version", dict(art, version=2)
    yield "page_size", dict(art, page_size=8)
    yield "quantized", dict(art, quantized=True)
    yield "model", dict(art, model=dict(art["model"], n_layers=3))
    yield "step", dict(art, step=0)
    yield "tokens", dict(art, tokens=[art["first_token"] + 1])
    yield "pos", dict(art, pos=art["pos"] + 1)
    yield "shape", dict(art, k=k[:, :-1])
    yield "dtype", dict(art, k=k.astype(np.float64))
    yield "missing", {key: v for key, v in art.items() if key != "v"}
    yield "draft", dict(art, dk=k, draft={"n_layers": 1})


def test_validate_artifact_rejects_what_jax_rejects(models):
    jcfg, jparams, tcfg, tparams = models
    jb = js.ContinuousBatcher(jcfg, jparams, **KW)
    tb = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **KW)
    p, n = _prompts()[1]
    art = jb.export_kv(js.Request(prompt=p, max_new_tokens=n))
    jreq, treq = js.Request(prompt=p, max_new_tokens=n), ts.Request(p, n)
    jb.validate(js.Prefilled(jreq, art))
    tb.validate(ts.Prefilled(treq, art))
    for name, bad in _mutations(art):
        with pytest.raises(ValueError):
            jb.validate(js.Prefilled(jreq, bad))
        with pytest.raises(ValueError):
            tb.validate(ts.Prefilled(treq, bad))
    # A request the artifact does not cover.
    with pytest.raises(ValueError):
        tb.validate(ts.Prefilled(ts.Request(p[:-1], n), art))
    with pytest.raises(ValueError, match="trailing"):
        meta, body = ts.pack_prefilled(art)
        ts.unpack_prefilled(meta, bytes(body) + b"\0")


def test_export_refused_while_the_loop_runs(models):
    _, _, tcfg, tparams = models
    b = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **KW)
    loop = b.run(ts.Request(p, n) for p, n in _prompts())
    next(loop)
    with pytest.raises(RuntimeError, match="serve loop"):
        b.export_kv(ts.Request(np.arange(5), 3))
    list(loop)
    with pytest.raises(TypeError):
        b.export_kv(np.arange(5))
    assert b.export_kv(ts.Request(np.arange(5), 3))["step"] == 1
