"""Deadlines, class-ranked admission and token streaming of the port's
ContinuousBatcher on the CPU (the JAX batcher's
``tests/test_serving.py`` deadline, class-rank and streaming cases run
on the port), with the live streams held to the JAX batcher's on the
same weights: an expired arrival is shed before its prefill, an
expired resident row is cancelled and its slot freed."""

import threading
import time

import jax
import numpy as np
import pytest
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu import serving as js
from tfmesos_tpu.fleet.replica import tiny_model as jax_tiny_model
from tfmesos_tpu_torch import convert
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.models import presets

V = 97
KW = dict(rows=2, max_len=64, page_size=16, prefill_bucket=16)


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = jax_tiny_model(seed=0)
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, presets.tiny_model()[0], tparams


def _prompts(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, size=rng.randint(3, 20)).astype(np.int32)
            for _ in range(n)]


def _jax_stream(models, prompt, new, **kw):
    jcfg, jparams, _, _ = models
    b = js.ContinuousBatcher(jcfg, jparams, **dict(KW, **kw))
    return list(b.run([js.Request(prompt=prompt, max_new_tokens=new)]))[0] \
        .tokens


def test_deadline_expired_arrival_shed_before_prefill(models):
    _, _, tcfg, tparams = models
    b = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **KW)
    ps = _prompts(2, seed=5)
    doomed = ts.Request(ps[0], 8, deadline_ms=1.0)
    live = ts.Request(ps[1], 4)
    time.sleep(0.01)            # the 1 ms budget is long gone
    out = list(b.run([doomed, live]))
    exp = [c for c in out if isinstance(c, ts.Expired)]
    comps = [c for c in out if isinstance(c, ts.Completion)]
    assert len(exp) == 1 and exp[0].request is doomed and exp[0].rid == -1
    assert len(comps) == 1 and comps[0].request is live
    assert comps[0].tokens == _jax_stream(models, ps[1], 4)
    assert b.deadline_cancels == 1 and b.prefills == 1
    # An expired import is shed too, keeping its exporter's rid.
    art = b.export_kv(ts.Request(ps[1], 4))
    late = ts.Request(ps[1], 4, deadline_ms=1.0)
    time.sleep(0.01)
    out = list(b.run([ts.Prefilled(late, art)]))
    assert [type(c) for c in out] == [ts.Expired]
    assert out[0].rid == art["rid"] and b.deadline_cancels == 2


@pytest.mark.parametrize("chunked", [False, True])
def test_deadline_cancels_resident_row_and_frees_slot(models, chunked):
    _, _, tcfg, tparams = models
    kw = dict(KW, rows=1)
    if chunked:
        kw.update(prefill_chunk=16)
    b = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    ps = _prompts(2, seed=6)
    doomed = ts.Request(ps[0], 48, deadline_ms=3_600_000.0)
    live = ts.Request(ps[1], 6)
    out = []
    t = threading.Thread(target=lambda: out.extend(b.serve()), daemon=True)
    t.start()
    b.submit(doomed)
    deadline = time.monotonic() + 120.0
    while b._next_rid == 0:
        assert time.monotonic() < deadline, "never admitted"
        time.sleep(0.005)
    doomed.deadline = 0.0       # the client's budget "expires" now
    b.submit(live)
    b.close()
    t.join(timeout=300.0)
    assert not t.is_alive()
    exp = [c for c in out if isinstance(c, ts.Expired)]
    comps = [c for c in out if isinstance(c, ts.Completion)]
    assert len(exp) == 1 and exp[0].rid == 0 and exp[0].request is doomed
    assert b.deadline_cancels == 1
    jkw = {"prefill_chunk": 16} if chunked else {}
    assert len(comps) == 1 and comps[0].request is live
    assert comps[0].tokens == _jax_stream(models, ps[1], 6, **jkw)
    assert out.index(exp[0]) < out.index(comps[0])
    assert b.alloc.rows == {}


def test_deadline_validation():
    with pytest.raises(ValueError):
        ts.Request(np.asarray([1, 2]), 2, deadline_ms=0.0)
    with pytest.raises(ValueError):
        ts.Request(np.asarray([1, 2]), 2, deadline_ms=-5.0)
    r = ts.Request(np.asarray([1, 2]), 2, session_id=7)
    assert r.deadline is None and not r.expired and r.session_id == "7"
    assert r.trace is None and r.on_tokens is None and r.priority == 0


def test_admission_orders_by_class_rank(models):
    _, _, tcfg, tparams = models
    ps = _prompts(4, seed=7)
    b = ts.ContinuousBatcher(tcfg, tparams, rows=1, device="cpu")
    reqs = [ts.Request(ps[0], 2, priority=0), ts.Request(ps[1], 2, priority=5),
            ts.Request(ps[2], 2, priority=5), ts.Request(ps[3], 2, priority=0)]
    for r in reqs:
        b.submit(r)
    b.close()
    rid_of = {id(c.request): c.rid for c in b.serve()}
    assert [rid_of[id(r)] for r in reqs] == [2, 0, 1, 3]


class _Trace:
    def __init__(self):
        self.events, self.spans = [], []

    def event(self, component, name, **attrs):
        self.events.append((component, name))

    def span_between(self, component, name, t0, t1, **attrs):
        assert t1 >= t0
        self.spans.append((component, name))


@pytest.mark.parametrize("chunked", [False, True])
def test_streaming_chunks_match_stream(models, chunked):
    """on_tokens gets contiguous, correctly offset chunks whose
    concatenation is a prefix of the completion; a raising callback
    costs its stream, never the request; a trace gets the admit event
    and the prefill/decode spans."""
    _, _, tcfg, tparams = models
    kw = dict(KW, prefill_chunk=16) if chunked else KW
    ps = _prompts(6, seed=7)
    reqs = [ts.Request(p, 5 + i % 6) for i, p in enumerate(ps)]
    got = {i: [] for i in range(len(reqs))}
    for i, r in enumerate(reqs):
        def cb(chunk, off, i=i):
            assert off == len(got[i])
            got[i].extend(chunk)
        r.on_tokens = cb

    def boom(chunk, off):
        got[3].extend(chunk)
        raise RuntimeError("broken consumer")
    reqs[3].on_tokens = boom
    reqs[0].trace = tr = _Trace()
    b = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    done = {c.rid: c.tokens for c in b.run(reqs)}
    plain = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    assert done == {c.rid: c.tokens for c in plain.run(
        ts.Request(p, 5 + i % 6) for i, p in enumerate(ps))}
    for rid in done:
        assert got[rid] == done[rid][:len(got[rid])]
        assert len(got[rid]) >= 1
    assert reqs[3].on_tokens is None
    assert ("batcher", "admit") in tr.events
    assert tr.spans == [("batcher", "prefill"), ("batcher", "decode")]
