"""Chunked prefill (``prefill_chunk``) of the port's ContinuousBatcher
against the JAX batcher in the same mode, on the CPU, with the JAX tiny
model's weights carried across by ``convert.params_from_jax``.

- Streams identical to the JAX chunked batcher's over the prompt mix of
  ``tests/test_serving.py::test_chunked_prefill_matches_unchunked``
  (prompts spanning one, several and exactly-full chunks), float32 and
  over an int8 pool; the pool is fully recycled after.
- A request whose first token is its stop completes straight out of its
  last chunk.
- ``warmup`` reports JAX's ``chunk_prefill[c]`` name.
- Graphed and eager ticks and chunks count alike (a stub capture stands
  in for the card).
"""

import jax
import numpy as np
import pytest
from test_torch_warmup import _stub_graphs, zero_launches  # noqa: F401
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu import serving as js
from tfmesos_tpu.fleet.replica import tiny_model as jax_tiny_model
from tfmesos_tpu_torch import convert, graphs
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.ops import attention

KW = dict(rows=3, max_len=96, page_size=16, prefill_chunk=8)


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = jax_tiny_model(seed=0)
    from tfmesos_tpu_torch.models import presets
    tcfg = presets.tiny_model()[0]
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def _prompts():
    rng = np.random.RandomState(29)
    return [rng.randint(0, 97, size=n).astype(np.int32)
            for n in (3, 8, 13, 19, 16, 5)]


def _streams(completions):
    return {c.rid: list(c.tokens) for c in completions}


@pytest.mark.parametrize("int8", [False, True])
def test_chunked_streams_identical_to_jax_chunked_batcher(models, int8):
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts()
    kw = dict(KW, quantized_cache=int8)
    tb = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    got = _streams(tb.run(ts.Request(p, 2 + i % 4)
                          for i, p in enumerate(prompts)))
    jb = js.ContinuousBatcher(jcfg, jparams, **kw)
    want = _streams(jb.run(js.Request(prompt=p, max_new_tokens=2 + i % 4)
                           for i, p in enumerate(prompts)))
    assert got == want
    assert tb.alloc.rows == {} and jb.alloc.rows == {}
    assert tb.peak_pages_used == jb.peak_pages_used
    # Every chunk of every padded prompt ran once; nothing prefilled whole.
    assert tb.prefill_chunks == sum(-(-p.size // 8) for p in prompts)
    assert tb.prefills == 0


def test_chunked_stop_at_first_token(models):
    _, _, tcfg, tparams = models
    prompt = np.random.RandomState(31).randint(0, 97, 13).astype(np.int32)
    b = ts.ContinuousBatcher(tcfg, tparams, rows=2, max_len=64,
                             page_size=16, prefill_chunk=8, device="cpu")
    first = list(b.run([ts.Request(prompt, 6)]))[0].tokens[0]
    done = list(b.run([ts.Request(prompt, 6, stop_token=first)]))
    assert len(done) == 1 and done[0].tokens == [first]
    assert 0.0 < done[0].ttft_s <= done[0].total_s
    assert b.alloc.rows == {}


def test_chunked_warmup_names_match_jax(models):
    jcfg, jparams, tcfg, tparams = models
    jb = js.ContinuousBatcher(jcfg, jparams, **KW)
    tb = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **KW)
    jnames = [n for n in jb.warmup()["compiled"]
              if n.startswith(("chunk_prefill", "decode", "prefill"))]
    assert tb.warmup()["compiled"] == jnames
    assert jnames[0] == "chunk_prefill[8]"


def test_chunked_graphed_and_eager_count_alike(monkeypatch, models,
                                               zero_launches):  # noqa: F811
    """Ticks and chunks through the stub capture: the same streams and
    the same counts as the eager path (each call's layers counted as the
    card's wrappers count them), and the chunk step captured a table
    width."""
    _, _, tcfg, tparams = models
    prompts = _prompts()
    runs = {}
    for eager in (True, False):
        b = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **KW)
        made = None
        if not eager:
            b._graphs, made = _stub_graphs(monkeypatch)
        for name in ("_tick", "_chunk_step"):
            inner = getattr(b, name)

            def counted(*a, inner=inner):
                attention.LAUNCHES["flash_decode_paged"] += tcfg.n_layers
                inner(*a)

            monkeypatch.setattr(b, name, counted)
        before = graphs.launch_counts()["flash_decode_paged"]
        got = _streams(b.run(ts.Request(p, 4) for p in prompts))
        n = graphs.launch_counts()["flash_decode_paged"] - before
        runs[eager] = (got, n, b.decode_ticks + b.prefill_chunks)
        if made is not None:
            assert any(k[0] == "chunk" for k in b._graphs._graphs)
    assert runs[True][0] == runs[False][0]
    assert runs[True][1] == runs[False][1] == \
        tcfg.n_layers * runs[True][2]
