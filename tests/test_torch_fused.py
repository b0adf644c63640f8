"""The fused prefill + decode tick (``fused_prefill``, with
``tokens_per_tick``) of the port's ContinuousBatcher on the CPU: one
dispatch a tick for the decode block and the budgeted chunk slots.

Over the reference's own variants of
``tests/test_serving.py::test_fused_tick_token_identical`` — greedy,
sampled, int8, multistep, budget, plus ``prefix_cache_pages`` without a
static prefix — the fused streams equal the JAX batcher's synchronous
phase-split one-token streams on the same weights (exact token
equality), the fused counters move, and the analytic
``fused_tokens_per_tick`` is the reference's.  ``fused_prefill`` without
a chunk raises; under a lagged carry it bypasses with the reference's
reason; ``warmup`` names ``fused[w,S]`` as the reference does.
"""

import numpy as np
import pytest
from test_torch_warmup import _stub_graphs, zero_launches  # noqa: F401
from torch_parity import jax_compile_cache_off  # noqa: F401
from torch_parity import Golden, batcher_streams, tiny_models

from tfmesos_tpu import serving as js
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.ops import prng

V = 97
KW = dict(rows=4, max_len=96, page_size=16, prefill_bucket=16,
          prefill_chunk=8)
VARIANTS = {"greedy": ({}, {}),
            "sampled": (dict(temperature=0.8, top_k=20, rng=3), {}),
            "int8": (dict(quantized_cache=True), {}),
            "multistep": (dict(multi_step=4), {}),
            # One chunk slot a tick: rows * K plus one chunk.
            "budget": ({}, dict(tokens_per_tick=4 + 8)),
            "pcache": (dict(prefix_cache_pages=16), {})}


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(scope="module")
def golden(models):
    return Golden(models)


def _specs(variant="greedy"):
    """The reference test's staggered lengths (long prompts still
    chunking while short ones decode); the prefix-cache variant shares
    a 24-token lead so later admissions hit."""
    rng = np.random.RandomState(41)
    prompts = [rng.randint(0, V, size=n).astype(np.int32)
               for n in (3, 21, 13, 34, 16, 5)]
    if variant == "pcache":
        lead = rng.randint(0, V, size=24).astype(np.int32)
        prompts = [np.concatenate([lead, p]) for p in prompts]
    return [(p, 2 + i % 5) for i, p in enumerate(prompts)]


def _batcher(models, **kw):
    tcfg, tparams = models[2:]
    if "rng" in kw:
        kw = dict(kw, rng=prng.PRNGKey(kw["rng"]))
    return ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fused_streams_equal_jax_phase_split(models, golden, variant):
    kw, fkw = VARIANTS[variant]
    kw = dict(KW, **kw)
    specs = _specs(variant)
    sync = {k: v for k, v in kw.items() if k != "multi_step"}
    b = _batcher(models, fused_prefill=True, **kw, **fkw)
    got = batcher_streams(b.run(ts.Request(p.copy(), n) for p, n in specs))
    assert got == golden(variant, specs, **sync)
    assert b._inflight is None and b.alloc.rows == {}
    assert b.fused_prefill_bypass_reason is None
    assert b.fused_ticks > 0 and b.fused_chunk_tokens > 0
    assert b.fused_decode_tokens > 0
    jcfg, jparams = models[:2]
    jkw = {k: v for k, v in kw.items() if k != "rng"}
    jb = js.ContinuousBatcher(jcfg, jparams, fused_prefill=True, **jkw,
                              **fkw)
    assert b.tokens_per_tick == jb.tokens_per_tick
    for n in (None, 0, 1, 3):
        assert b.fused_tokens_per_tick(n) == jb.fused_tokens_per_tick(n)
    assert b.fused_tokens_per_tick() >= kw["rows"] * kw.get("multi_step", 1)
    if variant == "pcache":
        plain = _batcher(models, **kw)
        batcher_streams(plain.run(ts.Request(p.copy(), n)
                                  for p, n in specs))
        assert b.prefix_cache_stats() == plain.prefix_cache_stats()
        assert b.prefix_cache_stats()["hits"] > 0


def test_fused_streams_equal_jax_own_fused_run(models):
    """Where JAX's own fused tick completes (greedy), the port's fused
    streams and counters equal it."""
    jcfg, jparams = models[:2]
    specs = _specs()
    jb = js.ContinuousBatcher(jcfg, jparams, fused_prefill=True, **KW)
    want = batcher_streams(jb.run(js.Request(prompt=p.copy(),
                                             max_new_tokens=n)
                                  for p, n in specs))
    b = _batcher(models, fused_prefill=True, **KW)
    got = batcher_streams(b.run(ts.Request(p.copy(), n) for p, n in specs))
    assert got == want
    assert (b.fused_ticks, b.fused_chunk_tokens, b.fused_decode_tokens) == \
        (jb.fused_ticks, jb.fused_chunk_tokens, jb.fused_decode_tokens)


def test_fused_prefill_requires_chunked(models):
    tcfg, tparams = models[2:]
    with pytest.raises(ValueError, match="fused_prefill"):
        ts.ContinuousBatcher(tcfg, tparams, rows=2, max_len=64,
                             page_size=16, fused_prefill=True, device="cpu")
    with pytest.raises(ValueError, match="tokens_per_tick"):
        ts.ContinuousBatcher(tcfg, tparams, rows=2, max_len=64,
                             page_size=16, prefill_chunk=8,
                             fused_prefill=True, tokens_per_tick=0,
                             device="cpu")


@pytest.mark.parametrize("lag", [dict(overlap=True), dict(pipeline_depth=1)],
                         ids=["overlap", "pipeline"])
def test_fused_bypasses_under_a_lagged_carry(models, golden, lag):
    """The reference's bypass: reason recorded, no fused dispatch, the
    phase-split lagged path serves the same streams."""
    specs = _specs()
    b = _batcher(models, fused_prefill=True, **lag, **KW)
    assert b.fused_prefill_bypass_reason == \
        js.compute_bypass_reasons(**lag)["fused_prefill"] == \
        "lagged decode carry"
    got = batcher_streams(b.run(ts.Request(p.copy(), n) for p, n in specs))
    assert got == golden("greedy", specs, **KW)
    assert b.fused_ticks == 0 and b.fused_tokens_per_tick() == b.rows


@pytest.mark.parametrize("k", [1, 4])
def test_fused_warmup_names_match_jax(models, k):
    jcfg, jparams, tcfg, tparams = models
    kw = dict(KW, multi_step=k, max_len=48)
    jb = js.ContinuousBatcher(jcfg, jparams, fused_prefill=True, **kw)
    tb = ts.ContinuousBatcher(tcfg, tparams, fused_prefill=True,
                              device="cpu", **kw)
    want = [n for n in jb.warmup()["compiled"]
            if n.startswith(("chunk_prefill", "decode", "prefill", "fused"))]
    assert tb._fused_slot_buckets() == jb._fused_slot_buckets()
    assert tb.warmup()["compiled"] == want
    assert "fused[2,4]" in want


def test_fused_graphed_and_eager_alike(monkeypatch, models,
                                       zero_launches):  # noqa: F811
    """Fused ticks through the stub capture: the streams of the eager
    path, one graph a (width, slot count) with the K-block inside."""
    specs = _specs()
    runs = {}
    for eager in (True, False):
        b = _batcher(models, fused_prefill=True, multi_step=2, **KW)
        if not eager:
            b._graphs, made = _stub_graphs(monkeypatch)
        runs[eager] = (batcher_streams(b.run(ts.Request(p.copy(), n)
                                             for p, n in specs)),
                       b.fused_ticks, b.decode_ticks)
    assert runs[True] == runs[False]
    assert any(isinstance(k, tuple) and k[0] == "fused"
               for k in b._graphs._graphs)
