"""The admission prefill and the prefix-cache tails as graph steps over
static buffers (``ContinuousBatcher._prefill_step`` a prompt width,
``_chunk_step`` a (tail tokens, table width)), on the CPU:

- a prefill through its static buffers equals the eager ``decode_step``
  call from an empty cache in first token (greedy and sampled, at
  ``fold_in(fold_in(rng, rid), 0)``) and in the pool's bytes, bf16
  compute and an int8 pool alike;
- a tail through its static buffers equals the eager ``decode_step`` at
  its offset over the row's mapped pages;
- ``warmup()`` names every shape as the JAX batcher does for the same
  config, across the schedule modes;
- through a stub capture each prefill width and each tail is one graph,
  and the streams are the eager path's.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_warmup import _stub_graphs
from torch_parity import jax_compile_cache_off  # noqa: F401
from torch_parity import batcher_streams, tiny_models

from tfmesos_tpu import serving as js
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.models import transformer as tt
from tfmesos_tpu_torch.ops import prng

V = 97
KW = dict(rows=2, max_len=96, page_size=16, prefill_bucket=16)


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def _pool_copy(b):
    return {k: (tt.QTensor(v.values.clone(), v.scales.clone())
                if isinstance(v, tt.QTensor) else v.clone())
            for k, v in b.pool.items()}


def _leaves(pool):
    return ts._pool_leaves(pool)


def _eager_first(b, logits, cap, rid):
    last = logits[0, cap][None]
    return int(b._sample(last, torch.tensor([rid]), torch.tensor([0]))[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["greedy", "sampled", "int8"])
def test_prefill_step_equals_eager_decode_step(models, variant, dtype):
    tcfg, tparams = models[2:]
    tcfg = dataclasses.replace(tcfg, dtype=getattr(torch, dtype))
    kw = dict(KW)
    if variant == "sampled":
        kw.update(temperature=0.9, top_k=30, rng=prng.PRNGKey(5))
    if variant == "int8":
        kw.update(quantized_cache=True)
    rng = np.random.RandomState(3)
    for length, rid in ((5, 0), (16, 7), (37, 12)):
        b = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
        prompt = rng.randint(0, V, length).astype(np.int32)
        width = -(-length // 16) * 16
        row = 1
        b.t_side.ensure(row, width)
        table = torch.from_numpy(b.t_side.table_np()[row:row + 1].copy())
        ref_pool = _pool_copy(b)
        padded = torch.zeros((1, width), dtype=torch.long)
        padded[0, :length] = torch.from_numpy(prompt)
        logits, _ = tt.decode_step(b.cfg, b.params,
                                   dict(ref_pool, pages=table), padded, 0)
        want = _eager_first(b, logits, length - 1, rid)
        got = int(b._prefill_call(row, prompt, width, rid))
        assert got == want
        for a, c in zip(_leaves(b.pool), _leaves(ref_pool)):
            assert torch.equal(a, c)
        assert width in b._prefill_bufs


@pytest.mark.parametrize("t", [16, 32])
def test_tail_step_equals_eager_decode_step(models, t):
    """A tail of ``t`` tokens at position 32 over two mapped pages."""
    tcfg, tparams = models[2:]
    b = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **KW)
    rng = np.random.RandomState(t)
    head = rng.randint(0, V, 32).astype(np.int32)
    b.t_side.ensure(0, 32)
    b._prefill_call(0, head, 32, 1)
    tail = rng.randint(0, V, t).astype(np.int32)
    b.t_side.ensure(0, 32 + t)
    w = b._chunk_width(32, t)
    ref_pool = _pool_copy(b)
    table = torch.from_numpy(b.t_side.table_np()[0:1, :w].copy())
    logits, _ = tt.decode_step(b.cfg, b.params, dict(ref_pool, pages=table),
                               torch.from_numpy(tail).long()[None],
                               torch.tensor([32]))
    cap = t - 3
    want = _eager_first(b, logits, cap, 4)
    got = int(b._chunk_call(0, tail, 32, cap, 4)[0])
    assert got == want
    for a, c in zip(_leaves(b.pool), _leaves(ref_pool)):
        assert torch.equal(a, c)
    assert (t, w) in b._chunk_bufs


CONFIGS = {"plain": {}, "pcache": dict(prefix_cache_pages=8),
           "chunked": dict(prefill_chunk=16),
           "multistep": dict(multi_step=4),
           "overlap": dict(overlap=True),
           "pipeline": dict(pipeline_depth=1, multi_step=2)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_warmup_names_equal_the_references(models, name):
    jcfg, jparams, tcfg, tparams = models
    kw = dict(KW, max_len=48, **CONFIGS[name])
    jb = js.ContinuousBatcher(jcfg, jparams, **kw)
    tb = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    want = [n for n in jb.warmup()["compiled"]
            if n.startswith(("chunk_prefill", "decode", "prefill", "fused"))]
    assert tb.warmup()["compiled"] == want


def test_prefill_and_tails_graphed_and_eager_alike(monkeypatch, models):
    """A prefix-cache run through the stub capture: the eager path's
    streams; one graph a prompt width and one a (tail tokens, table
    width), each replayed on later admissions at that shape."""
    tcfg, tparams = models[2:]
    rng = np.random.RandomState(9)
    lead = rng.randint(0, V, 32).astype(np.int32)
    specs = [(np.concatenate([lead, rng.randint(0, V, n).astype(np.int32)]),
              3) for n in (4, 9, 4, 20, 9)]
    runs = {}
    for eager in (True, False):
        b = ts.ContinuousBatcher(tcfg, tparams, device="cpu",
                                 prefix_cache_pages=8, **KW)
        if not eager:
            b._graphs, made = _stub_graphs(monkeypatch)
        runs[eager] = (batcher_streams(b.run(ts.Request(p.copy(), n)
                                             for p, n in specs)),
                       b.prefills, b.tail_prefills)
    assert runs[True] == runs[False]
    assert runs[True][1] == 1 and runs[True][2] == 4
    keys = [k for k in b._graphs._graphs if isinstance(k, tuple)]
    assert ("prefill", 48) in keys
    tails = [k for k in keys if k[0] == "chunk"]
    assert len(tails) == 2          # tails of 16 and 32 tokens
    assert sum(g.replays for g in made) > 0


def test_warmup_covers_every_tail_width(monkeypatch, models):
    """A tail starts past its cached prefix, where its table is wider
    than at position 0: warmup captures each tail width at every table
    width a start can give it, so serving prefix traffic after warmup
    captures nothing."""
    tcfg, tparams = models[2:]
    rng = np.random.RandomState(9)
    lead = rng.randint(0, V, 32).astype(np.int32)
    specs = [(np.concatenate([lead, rng.randint(0, V, n).astype(np.int32)]),
              3) for n in (4, 9, 4, 20, 9)]
    b = ts.ContinuousBatcher(tcfg, tparams, device="cpu",
                             prefix_cache_pages=8, **KW)
    b._graphs, made = _stub_graphs(monkeypatch)
    b.warmup()
    warmed = b._graphs.keys()
    assert ("chunk", 16, b._chunk_width(32, 16)) in warmed
    assert b._chunk_width(32, 16) != b._chunk_width(0, 16)
    list(b.run(ts.Request(p.copy(), n) for p, n in specs))
    assert b.tail_prefills == 4
    assert b._graphs.keys() == warmed
