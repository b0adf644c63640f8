"""``ContinuousBatcher.warmup`` and the CUDA-graph helper
(``tfmesos_tpu_torch/graphs.py``) on the CPU.

- ``warmup`` reports the JAX batcher's names for the same config:
  ``prefill[w]`` at every reachable prompt width, ``decode[w]`` at every
  table width of the reference's ``_decode_widths()``.
- A warmed batcher serves bit-identical streams, and leaves the page pool
  bit-identical but for the sink page, to a cold one's (greedy and
  sampled).
- ``warmup`` raises while the serve loop is active.
- The helper's launch accounting, with a stub capture standing in for
  the card: the capture's counts are taken back, every replay adds them,
  and an eager run and a graphed run count alike.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu import serving as js
from tfmesos_tpu.fleet.replica import tiny_model as jax_tiny_model
from tfmesos_tpu_torch import graphs
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.models import presets
from tfmesos_tpu_torch.ops import attention, prng, quant

KW = dict(rows=2, page_size=16, prefill_bucket=16)


def _prompts():
    rng = np.random.RandomState(11)
    return [rng.randint(0, 97, n).astype(np.int32)
            for n in (3, 17, 40, 9, 25, 33)]


def _streams(completions):
    return {c.rid: list(c.tokens) for c in completions}


@pytest.mark.parametrize("max_len,page_size,bucket", [
    (128, 16, 16), (64, 16, 16), (100, 8, 32), (1024, 64, 64)])
def test_warmup_names_match_jax(max_len, page_size, bucket):
    jcfg, jparams = jax_tiny_model(seed=0)
    cfg, params = presets.tiny_model()
    kw = dict(rows=2, max_len=max_len, page_size=page_size,
              prefill_bucket=bucket)
    if max_len > cfg.max_seq_len:
        cfg = dataclasses.replace(cfg, max_seq_len=max_len)
        jcfg = dataclasses.replace(jcfg, max_seq_len=max_len)
    jb = js.ContinuousBatcher(jcfg, jparams, **kw)
    tb = ts.ContinuousBatcher(cfg, params, device="cpu", **kw)
    assert tb._decode_widths() == jb._decode_widths()
    assert tb._prefill_widths() == jb._prefill_widths()
    info = tb.warmup()
    want = ([f"prefill[{w}]" for w in jb._prefill_widths()]
            + [f"decode[{w}]" for w in jb._decode_widths()])
    assert info["compiled"] == want
    assert info["seconds"] >= 0.0
    assert tb.warmup(prefill=False)["compiled"] == [
        f"decode[{w}]" for w in jb._decode_widths()]
    assert tb.warmup(decode=False, prefill=False)["compiled"] == []


def test_flagship_serving_shape_warms_four_decode_widths():
    """max_len 1024 over pages of 64 (16 a row): widths 2, 4, 8, 16."""
    cfg, params = presets.tiny_model()
    cfg = dataclasses.replace(cfg, max_seq_len=1024)
    b = ts.ContinuousBatcher(cfg, params, rows=8, page_size=64,
                             prefill_bucket=64, device="cpu")
    assert b._decode_widths() == [2, 4, 8, 16]
    assert len(b._prefill_widths()) == 16


@pytest.mark.parametrize("sampled", [False, True])
def test_warmed_batcher_is_bit_identical_to_a_cold_one(sampled):
    cfg, params = presets.tiny_model(seed=1)
    kw = dict(KW, device="cpu")
    if sampled:
        kw.update(temperature=0.9, top_p=0.95, rng=prng.PRNGKey(4))
    prompts = _prompts()
    news = [6, 10, 5, 12, 8, 7]
    cold = ts.ContinuousBatcher(cfg, params, **kw)
    warm = ts.ContinuousBatcher(cfg, params, **kw)
    assert warm.warmup()["compiled"]
    want = _streams(cold.run(ts.Request(p, n) for p, n in zip(prompts, news)))
    got = _streams(warm.run(ts.Request(p, n) for p, n in zip(prompts, news)))
    assert got == want
    sink = warm.t_side.sink
    assert sink == cold.t_side.sink
    for leaf in ("k", "v"):
        a, b = warm.pool[leaf], cold.pool[leaf]
        keep = [p for p in range(warm.n_pages) if p != sink]
        assert torch.equal(a[:, keep], b[:, keep])


def test_warmup_raises_while_the_loop_is_active():
    cfg, params = presets.tiny_model()
    b = ts.ContinuousBatcher(cfg, params, device="cpu", **KW)
    prompts = _prompts()
    loop = b.run(ts.Request(p, 3) for p in prompts)
    next(loop)
    with pytest.raises(RuntimeError, match="serve loop"):
        b.warmup()
    rest = list(loop)
    assert len(rest) == len(prompts) - 1
    assert b.warmup()["compiled"]               # the loop has ended
    loop = b.run(ts.Request(p, 3) for p in prompts)
    next(loop)
    loop.close()                                # abandoned: not active
    assert b.warmup(prefill=False)["compiled"]


class _StubGraph:
    """What a capture leaves behind: replays run the recorded step."""

    def __init__(self, step):
        self.step = step
        self.replays = 0

    def replay(self):
        self.replays += 1
        saved = graphs.launch_counts()
        self.step()                 # the work; a real replay counts none
        graphs.add_launches({k: n - saved[k]
                             for k, n in graphs.launch_counts().items()},
                            -1)


def _stub_graphs(monkeypatch, capturing=None):
    """A StepGraphs that captures as the card would, on the CPU: the
    capture runs the step's Python (the wrappers count) with
    ``capturing[0]`` set, where a step does no device work."""
    g = graphs.StepGraphs("cpu")
    g.eager = False
    g._stream = "capture stream"
    made = []
    capturing = [False] if capturing is None else capturing

    def capture(step):
        capturing[0] = True
        try:
            step()
        finally:
            capturing[0] = False
        made.append(_StubGraph(step))
        return made[-1].replay

    monkeypatch.setattr(g, "_capture", capture)
    monkeypatch.setattr(g, "_on_stream", lambda step: step())
    monkeypatch.setattr(g, "_reserved", lambda: 0)
    return g, made


@pytest.fixture
def zero_launches():
    saved = graphs.launch_counts()
    for counters in (attention.LAUNCHES, quant.LAUNCHES):
        for k in counters:
            counters[k] = 0
    yield
    for counters in (attention.LAUNCHES, quant.LAUNCHES):
        for k in counters:
            counters[k] = saved[k]


def test_replay_accounting_with_a_stub_capture(monkeypatch, zero_launches):
    capturing = [False]
    g, made = _stub_graphs(monkeypatch, capturing)
    buf = torch.zeros(3)

    def step():
        attention.LAUNCHES["flash_decode_paged"] += 8
        attention.LAUNCHES["flash_decode_paged_merge"] += 8
        quant.LAUNCHES["quant_int8_commit"] += 1
        if not capturing[0]:
            buf.add_(1)

    g.run(4, step)              # the eager call does the work: 1 step
    counts = graphs.launch_counts()
    assert (counts["flash_decode_paged"], counts["quant_int8_commit"]) \
        == (8, 1)
    assert 4 in g and len(made) == 1 and float(buf[0]) == 1.0
    for _ in range(5):
        g.run(4, step)          # replays
    counts = graphs.launch_counts()
    assert counts["flash_decode_paged"] == 6 * 8
    assert counts["flash_decode_paged_merge"] == 6 * 8
    assert counts["quant_int8_commit"] == 6
    assert made[0].replays == 5 and float(buf[0]) == 6.0
    g.warm(8, step)             # ahead of time: the eager call only
    assert 8 in g and graphs.launch_counts()["quant_int8_commit"] == 7
    g.warm(8, step)             # already captured: nothing
    g.run(8, step)
    assert graphs.launch_counts()["quant_int8_commit"] == 8
    assert len(made) == 2 and float(buf[0]) == 8.0


def test_graphed_and_eager_ticks_count_alike(monkeypatch, zero_launches):
    """The batcher's ticks through the stub capture: the same streams and
    the same wrapper counts as the eager path (the counts the card's
    wrappers keep are emulated by counting each tick's layers)."""
    cfg, params = presets.tiny_model()
    prompts = _prompts()
    runs = {}
    for eager in (True, False):
        b = ts.ContinuousBatcher(cfg, params, device="cpu", **KW)
        if not eager:
            b._graphs, made = _stub_graphs(monkeypatch)
        tick = b._tick

        def counted(width, tick=tick):
            attention.LAUNCHES["flash_decode_paged"] += cfg.n_layers
            tick(width)

        monkeypatch.setattr(b, "_tick", counted)
        before = graphs.launch_counts()["flash_decode_paged"]
        got = _streams(b.run(ts.Request(p, 5) for p in prompts))
        n = graphs.launch_counts()["flash_decode_paged"] - before
        runs[eager] = (got, n, b.decode_ticks)
    assert runs[True][0] == runs[False][0]
    assert runs[True][1] == runs[False][1] == cfg.n_layers * runs[True][2]
    assert made                                  # the ticks were captured
