"""The port's greedy ContinuousBatcher against the JAX ContinuousBatcher
on the CPU, on the same weights (the JAX tiny_model carried across by
``convert.params_from_jax``): greedy token streams must be IDENTICAL
and the pool's high-water mark equal."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu import serving as js
from tfmesos_tpu.fleet.replica import tiny_model as jax_tiny_model
from tfmesos_tpu_torch import convert
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.models import presets

# Staggered prompt lengths across the prefill buckets (16/32/48) and
# mixed quotas, more requests than rows so admission waits on finishes.
PROMPT_LENS = [3, 17, 40, 9, 25, 33]
NEW_TOKENS = [6, 10, 5, 12, 8, 7]
STOP_ROW = 3
KW = dict(rows=2, page_size=16, prefill_bucket=16)


def _prompts():
    rng = np.random.RandomState(11)
    return [rng.randint(0, 97, n).astype(np.int32) for n in PROMPT_LENS]


def _streams(completions):
    return {c.rid: list(c.tokens) for c in completions}


def test_greedy_streams_identical_to_jax_batcher():
    jcfg, jparams = jax_tiny_model(seed=0)
    tcfg = presets.tiny_model()[0]
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    prompts = _prompts()

    # Pick a stop token the stop row really emits mid-stream (from a
    # stop-free port run), so the stop path is exercised.
    probe = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **KW)
    free = _streams(probe.run(
        ts.Request(p, n) for p, n in zip(prompts, NEW_TOKENS)))
    stop = free[STOP_ROW][2]
    stops = [stop if i == STOP_ROW else None for i in range(len(prompts))]

    tb = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **KW)
    got = _streams(tb.run(ts.Request(p, n, s) for p, n, s
                          in zip(prompts, NEW_TOKENS, stops)))
    jb = js.ContinuousBatcher(jcfg, jparams, **KW)
    want = _streams(jb.run(js.Request(p, n, stop_token=s) for p, n, s
                           in zip(prompts, NEW_TOKENS, stops)))
    assert got == want
    assert got[STOP_ROW][-1] == stop
    assert len(got[STOP_ROW]) < NEW_TOKENS[STOP_ROW]
    assert tb.peak_pages_used == jb.peak_pages_used
    assert tb.prefills == len(prompts)


def test_entry_points_raise_without_a_card(monkeypatch):
    """No card and no device="cpu": the batcher refuses instead of
    dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params = presets.tiny_model()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.ContinuousBatcher(cfg, params)
    from tfmesos_tpu_torch.device import resolve_device
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_sampling_is_refused_until_ported():
    """Sampling is ported (tests/test_torch_sampling.py): temperature > 0
    is served, and only the reference's own argument checks refuse."""
    cfg, params = presets.tiny_model()
    b = ts.ContinuousBatcher(cfg, params, temperature=0.7, device="cpu",
                             **KW)
    done = list(b.run([ts.Request(np.arange(5), 3)]))
    assert len(done) == 1 and len(done[0].tokens) == 3
    with pytest.raises(ValueError, match="top_k"):
        ts.ContinuousBatcher(cfg, params, temperature=0.7, top_k=0,
                             device="cpu")
    with pytest.raises(ValueError, match="top_p"):
        ts.ContinuousBatcher(cfg, params, temperature=0.7, top_p=0.0,
                             device="cpu")


def test_online_submit_serve_close_matches_run():
    cfg, params = presets.tiny_model(seed=2)
    prompts = _prompts()[:3]
    offline = _streams(ts.ContinuousBatcher(
        cfg, params, device="cpu", **KW).run(
            ts.Request(p, 4) for p in prompts))
    b = ts.ContinuousBatcher(cfg, params, device="cpu", **KW)
    for p in prompts:
        b.submit(ts.Request(p, 4))
    b.close()
    assert _streams(b.serve()) == offline
    with pytest.raises(RuntimeError):
        b.submit(ts.Request(prompts[0], 4))


def test_oversized_request_raises_after_draining():
    cfg, params = presets.tiny_model()
    b = ts.ContinuousBatcher(cfg, params, device="cpu", **KW)
    reqs = [ts.Request(np.arange(5), 3), ts.Request(np.arange(120) % 97, 40)]
    done = []
    with pytest.raises(ValueError, match="max_len"):
        for c in b.run(reqs):
            done.append(c)
    assert len(done) == 1 and len(done[0].tokens) == 3
    assert b.t_side.alloc.free_count() == b.n_pages - 1     # all released


def test_out_of_vocab_prompt_is_refused():
    cfg, params = presets.tiny_model()
    b = ts.ContinuousBatcher(cfg, params, device="cpu", **KW)
    with pytest.raises(ValueError, match="token ids"):
        b.validate(ts.Request(np.array([3, 97]), 2))


def test_page_table_buckets_and_sink():
    side = ts._PagedSide(n_pages=9, page_size=16, rows=2, np_max=8)
    assert side.sink == 0
    side.ensure(0, 40)                      # 3 pages
    t = side.decode_table()
    assert t.shape == (2, 4)                # next power of two above 3
    assert list(t[1]) == [side.sink] * 4    # idle row: all sink
    assert side.peak == 4
    side.release(0)
    assert side.decode_table().shape == (2, 2)
