"""Priority preemption, the ``preempt_all`` drain and resumption of the
port's ContinuousBatcher on the CPU, the JAX batcher's tests
(``tests/test_serving.py``: ``test_preempt_resume_token_identical``,
``test_preempt_strictness_and_parked_resume``,
``test_suspended_artifact_validation``) run on the port, with the
uninterrupted streams held to the JAX batcher's on the same weights and
a port suspension resumed by the JAX batcher through packed bytes."""

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
from tfmesos_tpu_torch.ops import prng

V = 97


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = jax_tiny_model(seed=0)
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, presets.tiny_model()[0], tparams


def _kw(variant, jax_side=False):
    kw = dict(rows=1, max_len=64, page_size=16, prefill_bucket=16)
    if variant == "sampled":
        kw.update(temperature=0.8, top_k=20,
                  rng=(jax.random.PRNGKey(7) if jax_side
                       else prng.PRNGKey(7)))
    elif variant == "int8":
        kw.update(quantized_cache=True)
    elif variant == "chunked":
        kw.update(prefill_chunk=16)
    elif variant == "pcache":
        kw.update(prefix_cache_pages=8)
    return kw


def _wait(cond, what):
    deadline = time.monotonic() + 120.0
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _drive(b, sink):
    t = threading.Thread(target=lambda: sink.extend(b.serve()),
                         daemon=True)
    t.start()
    return t


@pytest.mark.parametrize("variant",
                         ["greedy", "sampled", "int8", "chunked", "pcache"])
def test_preempt_resume_token_identical(models, variant):
    """rows=1: a higher-priority arrival suspends the resident row;
    preempt_all() hands back everything in flight, a second batcher
    resumes it, and every stream equals the uninterrupted run's (and
    the JAX batcher's uninterrupted run's)."""
    jcfg, jparams, tcfg, tparams = models
    kw = _kw(variant)
    rng = np.random.RandomState(31)
    pA, pB = (rng.randint(0, V, size=n).astype(np.int32) for n in (9, 7))
    refs = {c.rid: c.tokens for c in ts.ContinuousBatcher(
        tcfg, tparams, device="cpu", **kw).run(
            [ts.Request(pA.copy(), 12), ts.Request(pB.copy(), 24)])}
    jrefs = {c.rid: c.tokens for c in js.ContinuousBatcher(
        jcfg, jparams, **_kw(variant, jax_side=True)).run(
            [js.Request(prompt=pA.copy(), max_new_tokens=12),
             js.Request(prompt=pB.copy(), max_new_tokens=24)])}
    if variant != "sampled":    # a sampled draw may fork at an ulp tie
        assert refs == jrefs

    b1 = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    out = []
    t = _drive(b1, out)
    b1.submit(ts.Request(pA.copy(), 12, priority=0))
    _wait(lambda: b1._next_rid > 0, "first request never admitted")
    b1.submit(ts.Request(pB.copy(), 24, priority=5))
    _wait(lambda: b1.preemptions >= 1, "preemption never happened")
    b1.preempt_all()
    b1.close()
    t.join(timeout=300.0)
    assert not t.is_alive()
    streams = {c.rid: c.tokens for c in out
               if isinstance(c, ts.Completion)}
    susp = {s.rid: s for s in out if isinstance(s, ts.Suspended)}
    assert susp and all(s.artifact is not None for s in susp.values())
    art0 = susp[0].artifact
    assert art0["step"] > 1 and art0["tokens"] == refs[0][:art0["step"]]
    b2 = ts.ContinuousBatcher(tcfg, tparams, device="cpu",
                              **dict(kw, rows=2))
    for c in b2.run([ts.Prefilled(s.request, s.artifact)
                     for _, s in sorted(susp.items())]):
        streams[c.rid] = c.tokens
    assert streams == refs, f"{variant}: resumed streams diverged"
    if variant in ("greedy", "int8"):
        # The same suspensions resumed by the JAX batcher, over the wire.
        jb = js.ContinuousBatcher(jcfg, jparams,
                                  **dict(_kw(variant, True), rows=2))
        jstreams = {c.rid: c.tokens for c in out
                    if isinstance(c, ts.Completion)}
        for c in jb.run([js.Prefilled(
                js.Request(prompt=s.request.prompt,
                           max_new_tokens=s.request.max_new_tokens),
                js.unpack_prefilled(*ts.pack_prefilled(s.artifact)))
                for _, s in sorted(susp.items())]):
            jstreams[c.rid] = c.tokens
        assert jstreams == refs


def test_preempt_strictness_and_parked_resume(models):
    _, _, tcfg, tparams = models
    kw = dict(rows=1, max_len=64, page_size=16, prefill_bucket=16)
    rng = np.random.RandomState(33)
    pA, pB = (rng.randint(0, V, size=n).astype(np.int32) for n in (8, 6))
    refs = {c.rid: c.tokens for c in ts.ContinuousBatcher(
        tcfg, tparams, device="cpu", **kw).run(
            [ts.Request(pA.copy(), 10), ts.Request(pB.copy(), 4)])}
    b = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    out = []
    t = _drive(b, out)
    b.submit(ts.Request(pA.copy(), 10, priority=3))
    _wait(lambda: b._next_rid > 0, "first request never admitted")
    b.submit(ts.Request(pB.copy(), 4, priority=5))
    _wait(lambda: b.resumes >= 1, "parked row never resumed")
    b.close()
    t.join(timeout=300.0)
    assert b.preemptions == 1 and b.resumes == 1
    assert {c.rid: c.tokens for c in out} == refs
    # Equal priorities: FIFO, no suspension.
    b3 = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    got = {c.rid: c.tokens for c in b3.run(
        [ts.Request(pA.copy(), 10, priority=5),
         ts.Request(pB.copy(), 4, priority=5)])}
    assert b3.preemptions == 0 and got == refs


def test_suspended_artifact_validation(models):
    jcfg, jparams, tcfg, tparams = models
    kw = dict(rows=1, max_len=64, page_size=16, prefill_bucket=16)
    rng = np.random.RandomState(35)
    p, pB = (rng.randint(0, V, size=n).astype(np.int32) for n in (9, 6))
    b = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    req = ts.Request(p, 12, priority=0)
    out = []
    t = _drive(b, out)
    b.submit(req)
    _wait(lambda: b._next_rid > 0, "first request never admitted")
    b.submit(ts.Request(pB, 24, priority=5))
    _wait(lambda: b.preemptions >= 1, "preemption never happened")
    b.preempt_all()
    b.close()
    t.join(timeout=300.0)
    art = next(s.artifact for s in out
               if isinstance(s, ts.Suspended) and s.request is req)
    assert art is not None and art["step"] > 1
    b2 = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    jb = js.ContinuousBatcher(jcfg, jparams, **kw)
    jreq = js.Request(prompt=p, max_new_tokens=12)
    b2.validate(ts.Prefilled(req, art))
    jb.validate(js.Prefilled(jreq, art))
    for bad, jbad_req in (
            (dict(art, tokens=list(art["tokens"][:-1])), jreq),
            (dict(art, step=art["step"] + 1), jreq),
            (art, js.Request(prompt=p, max_new_tokens=art["step"]))):
        with pytest.raises(ValueError):
            b2.validate(ts.Prefilled(
                ts.Request(jbad_req.prompt, jbad_req.max_new_tokens), bad))
        with pytest.raises(ValueError):
            jb.validate(js.Prefilled(jbad_req, bad))


def test_preempt_all_requeues_what_holds_no_state(models, monkeypatch):
    """A still-filling chunked row comes back with no artifact (it reruns
    from scratch) and its pages are freed; the loop then serves what
    arrives after."""
    _, _, tcfg, tparams = models
    b = ts.ContinuousBatcher(tcfg, tparams, rows=1, max_len=64,
                             page_size=16, prefill_chunk=8, device="cpu")
    advance = b._advance_prefill
    fired = []

    def advance_then_drain(active):
        out = advance(active)
        if not fired:
            fired.append(True)
            b.preempt_all()     # after the first of four chunks
        return out

    monkeypatch.setattr(b, "_advance_prefill", advance_then_drain)
    reqs = [ts.Request(np.arange(30) % V, 5), ts.Request(np.arange(7), 5)]
    out = list(b.run(iter(reqs)))
    assert [type(x) for x in out] == [ts.Suspended, ts.Completion]
    assert out[0].request is reqs[0] and out[0].artifact is None
    assert out[0].rid == 0 and out[1].request is reqs[1]
    assert b.alloc.rows == {} and b.preemptions == 0
    assert b.preemptible and b.suspend_bypass_reason is None
