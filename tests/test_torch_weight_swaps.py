"""The port batcher's online weight updates against the JAX batcher's on
the CPU: ``swap_adapter`` (a param-path delta folded in) and
``set_weights`` (a whole tree) validate as the reference does, apply
synchronously without a serve loop and behind the fence with one (rows
resident when the update is queued finish on the old weights, later
admissions serve the new ones), give identical streams and the same
``weight_swaps`` / ``adapter_version``, clear the prefix trie and
restamp the KV tier (parked entries read as version misses).  The
card's hazard, held here: every update writes into the existing
parameter storage (the captured graphs read it by address), for float
and int8 trees alike, and never into the caller's tensors."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import jax_compile_cache_off, tiny_models  # noqa: F401

from tfmesos_tpu import serving as js
from tfmesos_tpu.fleet import kvtier as jkv
from tfmesos_tpu.models import transformer as jt
from tfmesos_tpu_torch import convert
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.fleet import kvtier as tkv
from tfmesos_tpu_torch.models import transformer as tt

KW = dict(rows=2, max_len=64, page_size=16, prefill_bucket=16)


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def _delta(seed=5, path="layers/wq", scale=0.5):
    shape = {"layers/wq": (2, 32, 32), "embed": (97, 32)}[path]
    rs = np.random.RandomState(seed)
    return {path: (scale * rs.standard_normal(shape)).astype(np.float32)}


def _prompts(n, seed=11):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 97, size=rs.randint(3, 20)).astype(np.int32)
            for _ in range(n)]


def _pair(models, **kw):
    jcfg, jparams, tcfg, tparams = models
    return (js.ContinuousBatcher(jcfg, jparams, **dict(KW, **kw)),
            ts.ContinuousBatcher(tcfg, tparams, device="cpu",
                                 **dict(KW, **kw)))


def _one(mod, b, prompt, n):
    (c,) = list(b.run([mod.Request(prompt.copy(), n)]))
    return list(c.tokens)


def _ptrs(params):
    out = []
    for v in params.values():
        if isinstance(v, dict):
            out += _ptrs(v)
        elif hasattr(v, "values") and not isinstance(v, torch.Tensor):
            out += [v.values.data_ptr(), v.scales.data_ptr()]
        else:
            out.append(v.data_ptr())
    return out


BAD = {"empty": ({}, "v"), "no_label": ("delta", ""),
       "unknown": ({"nope/nope": np.zeros((2, 2))}, "v"),
       "shape": ({"layers/wq": np.zeros((1, 1, 7))}, "v"),
       "interior": ({"layers": np.zeros((2, 2))}, "v"),
       "empty_path": ({"": np.zeros((2, 2))}, "v")}


@pytest.mark.parametrize("case", sorted(BAD))
def test_invalid_deltas_raise_as_the_reference(models, case):
    delta, label = BAD[case]
    if delta == "delta":
        delta = _delta()
    jb, tb = _pair(models)
    msgs = []
    for b in (jb, tb):
        with pytest.raises(ValueError) as e:
            b.swap_adapter(delta, label)
        msgs.append(str(e.value))
        assert b.adapter_version == "" and b.weight_swaps == 0
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("path", ["layers/wq", "embed"])
def test_swap_adapter_streams_equal_jax(models, path):
    """Without a serve loop the fold applies at once; the next run
    serves the folded weights, as the JAX batcher's does."""
    jb, tb = _pair(models)
    delta = _delta(path=path)
    p = _prompts(1, seed=3)[0]
    before = _one(ts, tb, p, 8)
    for b in (jb, tb):
        b.swap_adapter(delta, "d1")
    got, want = _one(ts, tb, p, 8), _one(js, jb, p, 8)
    assert got == want and got != before
    assert (tb.adapter_version, tb.weight_swaps) == \
        (jb.adapter_version, jb.weight_swaps) == ("d1", 1)
    # Folds accumulate on the float32 masters, as the reference's.
    for b in (jb, tb):
        b.swap_adapter(_delta(seed=6, path=path, scale=0.1), "d2")
    assert _one(ts, tb, p, 8) == _one(js, jb, p, 8)


def test_set_weights_streams_equal_jax_and_reset_the_label(models):
    jcfg = models[0]
    other = jt.init_params(jcfg, jax.random.PRNGKey(42))
    tother = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            other))
    jb, tb = _pair(models)
    for b in (jb, tb):
        b.swap_adapter(_delta(), "d1")
    jb.set_weights(other, version="v0@other")
    tb.set_weights(tother, version="v0@other")
    assert tb.adapter_version == jb.adapter_version == ""
    p = _prompts(1, seed=7)[0]
    assert _one(ts, tb, p, 6) == _one(js, jb, p, 6)
    assert tb.weight_swaps == jb.weight_swaps == 2
    with pytest.raises(ValueError, match="does not match"):
        tb.set_weights({"embed": tother["embed"]})


def test_fence_in_the_serve_loop_equals_jax(models):
    """A swap queued while rows are resident applies once they finish:
    in-flight streams end on the old weights, the request queued behind
    the fence serves the new ones, on both frameworks alike."""
    p = _prompts(3, seed=11)
    delta = _delta()
    out = {}
    for name, mod, b in zip(("jax", "port"), (js, ts), _pair(models)):
        gen = b.serve()
        ra = mod.Request(p[0].copy(), 10)
        rb = mod.Request(p[1].copy(), 2)
        rc = mod.Request(p[2].copy(), 6)
        b.submit(ra)
        b.submit(rb)
        first = next(gen)
        applied = []
        b.swap_adapter(delta, "lora1",
                       on_applied=lambda b=b: applied.append(
                           b.adapter_version))
        b.submit(rc)
        rest = [next(gen), next(gen)]
        b.close()
        assert list(gen) == []
        assert applied == ["lora1"] and b.weight_swaps == 1
        out[name] = [(c.request.prompt.tolist(), list(c.tokens))
                     for c in [first] + rest]
    assert out["port"] == out["jax"]


def test_idle_loop_applies_a_queued_update_at_once(models):
    """With a serve loop idle on an empty queue, the update's kick
    applies it without waiting for traffic."""
    import threading
    import time

    _, tb = _pair(models)
    done = threading.Event()
    t = threading.Thread(target=lambda: list(tb.serve()), daemon=True)
    t.start()
    deadline = time.monotonic() + 30.0
    while not tb._loop_active and time.monotonic() < deadline:
        time.sleep(0.01)
    assert tb._loop_active
    tb.swap_adapter(_delta(), "k1", on_applied=done.set)
    assert done.wait(30.0) and tb.adapter_version == "k1"
    tb.close()
    t.join(30.0)
    assert not t.is_alive()


def test_updates_clear_the_trie_and_restamp_the_tier(models):
    """The fold clears the prefix trie (no spill) and restamps the tier's
    adapter; a set restamps its weights version: a session parked before
    reads as a version miss after, and the next turn prefills cold, on
    both frameworks alike."""
    jcfg, jparams, tcfg, tparams = models
    hist = _prompts(1, seed=9)[0]
    out = {}
    for name, mod, kv, cfg, params in (("jax", js, jkv, jcfg, jparams),
                                       ("port", ts, tkv, tcfg, tparams)):
        store = kv.KVTierStore(ram_bytes=8 << 20, token="t",
                               stamp={"weights_version": "v1", "gen": 0})
        extra = {} if name == "jax" else {"device": "cpu"}
        b = mod.ContinuousBatcher(cfg, params, kv_tier=store,
                                  prefix_cache_pages=8, **KW, **extra)
        (c,) = list(b.run([mod.Request(hist.copy(), 4, session_id="s")]))
        assert b.prefix_cache_stats()["cached_pages"] >= 0
        b.swap_adapter(_delta(), "a1")
        assert b.prefix_cache_stats()["cached_pages"] == 0
        nxt = np.concatenate([hist, np.asarray(c.tokens, np.int32),
                              np.array([3, 4], np.int32)])
        (c2,) = list(b.run([mod.Request(nxt.copy(), 4, session_id="s")]))
        st = store.stats()
        b.set_weights(params, version="v2")
        out[name] = (list(c.tokens), list(c2.tokens), st["park"],
                     st["resume"], st.get("version_miss",
                                          st.get("stale", None)),
                     b.weight_swaps, b.prefix_cache_stats()["cached_pages"])
    assert out["port"] == out["jax"]
    assert out["port"][3] == 0          # the parked turn was a miss


def test_updates_write_into_the_existing_storage(models):
    """The graph-address hazard: ``set_weights`` and the fold copy into
    the batcher's own parameter tensors (same ``data_ptr``, new values)
    and never touch the caller's tree; an int8 tree copies values and
    scales in place too."""
    _, _, tcfg, tparams = models
    keep = {k: (v.clone() if isinstance(v, torch.Tensor) else
                {kk: vv.clone() for kk, vv in v.items()})
            for k, v in tparams.items()}
    b = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **KW)
    ptrs = _ptrs(b.params)
    assert not set(ptrs) & set(_ptrs(tparams))
    wq = b.params["layers"]["wq"].clone()
    b.swap_adapter(_delta(), "d1")
    assert _ptrs(b.params) == ptrs
    assert not torch.equal(b.params["layers"]["wq"], wq)
    assert torch.equal(tparams["layers"]["wq"], keep["layers"]["wq"])
    other = tt.init_params(tcfg, torch.Generator().manual_seed(3))
    b.set_weights(other)
    assert _ptrs(b.params) == ptrs
    assert torch.equal(b.params["embed"], other["embed"])
    q = tt.quantize_params(tcfg, tparams)
    qb = ts.ContinuousBatcher(tcfg, q, device="cpu", **KW)
    qptrs = _ptrs(qb.params)
    q2 = tt.quantize_params(tcfg, other)
    qb.set_weights(q2)
    assert _ptrs(qb.params) == qptrs
    assert torch.equal(qb.params["layers"]["wq"].values,
                       q2["layers"]["wq"].values)
    with pytest.raises(ValueError, match="int8 weight"):
        qb.swap_adapter({"layers/wq": np.zeros((2, 32, 32))}, "x")
    p = _prompts(1, seed=2)[0]
    fresh = ts.ContinuousBatcher(tcfg, q2, device="cpu", **KW)
    assert _one(ts, qb, p, 5) == _one(ts, fresh, p, 5)
