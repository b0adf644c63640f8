"""The lagged schedule modes of the port's ContinuousBatcher on the CPU
— ``overlap`` (block N+1 dispatched before block N syncs, rows chaining
from its last token on the device) and ``pipeline_depth=1`` (the whole
carry on the device, host inputs uploaded only when the dispatch set
changes) — with K in {1, 4}, held to the JAX batcher's synchronous one
token tick on the same weights with exact token equality (and to JAX's
own lagged run, where it completes):

- greedy, sampled and over an int8 pool, more requests than rows, so
  rows are re-admitted while an overshoot block of the row's previous
  request is still in flight;
- at the end nothing is in flight and every page is released;
- the registry: under either lag no row is suspendable, and
  ``preempt_all`` gives every request back with no artifact, dropping
  the block in flight; the requeued requests rerun
  to the uninterrupted streams;
- the pipeline uploads host inputs only when the dispatch set changes;
- with chunked prefill and the prefix cache, chunk calls and table
  changes fall between lagged blocks: the streams are still the golden
  ones, and every host-to-device copy (tables included) stages in a
  buffer of its own.
"""

import numpy as np
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401
from torch_parity import Golden, batcher_streams, tiny_models

from tfmesos_tpu import serving as js
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.ops import prng

V = 97
KW = dict(rows=2, max_len=96, page_size=16, prefill_bucket=16)
MODES = {"overlap": dict(overlap=True), "pipeline": dict(pipeline_depth=1)}
VARIANTS = {"greedy": {}, "sampled": dict(temperature=0.8, top_k=20, rng=3),
            "int8": dict(quantized_cache=True)}


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(scope="module")
def golden(models):
    return Golden(models)


def _specs():
    rng = np.random.RandomState(43)
    return [(rng.randint(0, V, size=n).astype(np.int32), q)
            for n, q in ((5, 9), (18, 3), (11, 6), (30, 1), (7, 12),
                         (2, 5))]


def _batcher(models, **kw):
    tcfg, tparams = models[2:]
    if "rng" in kw:
        kw = dict(kw, rng=prng.PRNGKey(kw["rng"]))
    return ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mode", list(MODES))
def test_lagged_streams_equal_jax_sync(models, golden, mode, variant, k):
    specs = _specs()
    kw = dict(KW, **VARIANTS[variant])
    b = _batcher(models, multi_step=k, **MODES[mode], **kw)
    got = batcher_streams(b.run(ts.Request(p.copy(), n) for p, n in specs))
    assert got == golden(variant, specs, **kw)
    assert b._inflight is None and b._pipe_carry is None
    assert b.alloc.rows == {} and b.t_side.row_cached == {}
    assert b.alloc.free_count() == b.n_pages - 1        # all but the sink
    assert b.decode_tokens == sum(n - 1 for _, n in specs)
    assert (b._pipelined, b.overlap) == ((True, False) if mode == "pipeline"
                                         else (False, True))


@pytest.mark.parametrize("mode", list(MODES))
def test_lagged_streams_equal_jax_own_lagged_run(models, golden, mode):
    """JAX's own batcher in the same mode (K = 4) gives the same streams
    as its synchronous one and as the port's."""
    jcfg, jparams = models[:2]
    specs = _specs()
    kw = dict(KW, multi_step=4, **MODES[mode])
    jb = js.ContinuousBatcher(jcfg, jparams, **kw)
    want = batcher_streams(jb.run(js.Request(prompt=p.copy(),
                                             max_new_tokens=n)
                                  for p, n in specs))
    b = _batcher(models, **kw)
    got = batcher_streams(b.run(ts.Request(p.copy(), n) for p, n in specs))
    assert got == want == golden("greedy", specs, **KW)


def test_readmission_into_a_freed_row_under_an_overshoot_block(models,
                                                                golden):
    """One row: every request after the first is admitted into the row
    whose previous request's overshoot block is still in flight (its
    tokens fail the rid check); each stream is the golden one."""
    specs = _specs()
    kw = dict(KW, rows=1)
    for mode in MODES.values():
        b = _batcher(models, multi_step=4, **mode, **kw)
        got = batcher_streams(b.run(ts.Request(p.copy(), n)
                                    for p, n in specs))
        assert got == golden("one row", specs, **kw)
        assert b.alloc.rows == {} and b._inflight is None


@pytest.mark.parametrize("mode", list(MODES))
def test_lagged_registry_and_preempt_all_requeues(models, mode):
    specs = _specs()
    b = _batcher(models, multi_step=4, **MODES[mode], **KW)
    want = js.compute_bypass_reasons(**MODES[mode])
    assert b.suspend_bypass_reason == want["suspend"] == \
        "lagged decode carry"
    assert not b.preemptible
    # Two requests, one a row: both resident when the drain fires.
    reqs = [ts.Request(p.copy(), n + 8) for p, n in specs[:2]]
    fired = []
    step = b._step_lagged

    def step_then_drain(active, free_rows):
        yield from step(active, free_rows)
        if len(fired) == 0 and b._inflight is not None:
            fired.append(b.decode_ticks)
            b.preempt_all()

    b._step_lagged = step_then_drain
    out = list(b.run(iter(reqs)))
    assert fired and all(isinstance(x, ts.Suspended) for x in out)
    assert sorted(id(x.request) for x in out) == sorted(map(id, reqs))
    assert all(x.artifact is None for x in out)
    assert b._inflight is None and b._pipe_carry is None
    assert b._pipe_host is None and b.alloc.rows == {}
    assert b.preemptions == 0
    # The requeued requests rerun from scratch to the uninterrupted
    # streams (completions are deterministic).
    again = _batcher(models, multi_step=4, **MODES[mode], **KW)
    rerun = [c.tokens for c in sorted(again.run(x.request for x in out),
                                      key=lambda c: c.rid)]
    plain = _batcher(models, **KW)
    by_req = {id(c.request): c.tokens for c in plain.run(iter(reqs))}
    assert rerun == [by_req[id(x.request)] for x in out]


def test_pipeline_uploads_only_when_the_dispatch_set_changes(models):
    """Two long requests on two rows: after the first blocks, the key
    (ticket plus fresh rows) stays put and no host input is uploaded."""
    b = _batcher(models, pipeline_depth=1, **KW)
    uploads = []
    specs = [(np.arange(1, 6, dtype=np.int32), 30),
             (np.arange(2, 9, dtype=np.int32), 30)]
    stage = b._staging

    def staging(*shape, **kw):
        if shape == (5, b.rows):
            uploads.append(b.decode_ticks)
        return stage(*shape, **kw)

    b._staging = staging
    got = batcher_streams(b.run(ts.Request(p, n) for p, n in specs))
    assert len(got) == 2
    # Fresh rows upload, the next block clears their flags, then nothing
    # until a row leaves the dispatch set.
    assert 2 <= len(uploads) <= 5 < b.decode_ticks


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_lagged_with_chunks_and_prefix_cache(models, golden, mode, k):
    """Chunk calls run between a block's dispatch and its retire, and the
    decode table changes under a block in flight (a row's chunks end, a
    row leaves the block): no staging buffer is ever written twice."""
    rng = np.random.RandomState(21)
    system = rng.randint(0, V, size=36).astype(np.int32)
    specs = [(np.concatenate([system, rng.randint(0, V, 5 + 3 * i)
                              .astype(np.int32)]), 3 + i % 4)
             for i in range(6)]
    kw = dict(KW, prefill_chunk=16, prefix_cache_pages=12)
    b = _batcher(models, multi_step=k, **MODES[mode], **kw)
    staged = []
    stage = b._staging

    def staging(*shape, **skw):
        staged.append(stage(*shape, **skw))
        return staged[-1]

    b._staging = staging
    got = batcher_streams(b.run(ts.Request(p.copy(), n) for p, n in specs))
    assert got == golden("chunked+pcache", specs, **kw)
    assert b._inflight is None and b.alloc.rows == {}
    assert b.prefill_chunks > 0 and b.prefix_cache_stats()["hits"] > 0
    tables = [x for x in staged if x.dtype == torch.int32]
    assert len(tables) > 1
    assert len({x.data_ptr() for x in staged}) == len(staged)
