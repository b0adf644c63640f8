"""The port's speculative ``ContinuousBatcher`` against the JAX batcher
on the CPU (the JAX tiny model and its tiny draft carried across by
``convert.params_from_jax``): the same requests give identical streams,
the same ``acceptance_rate`` and the same speculative counters in every
mode that composes (synchronous, ``multi_step`` as R rounds a dispatch,
``overlap``, chunked prefill, the prefix cache with twin pages, an int8
draft pool, an int8 target pool, a stop token, sampled rounds under the
reference's key folds), with the preset draft and with a self-draft
(the target as its own draft: every proposal accepted).  Warmup covers
every shape the speculative serve loop dispatches (no capture after it,
under a capture stub), and the port's analytic launch metric is the
reference's."""

import numpy as np
import pytest
from torch_parity import (jax_compile_cache_off,  # noqa: F401
                          tiny_draft_params, tiny_models)

from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.models import presets
from tfmesos_tpu_torch.ops import prng

K = 3
BASE = dict(rows=2, max_len=64, page_size=16, prefill_bucket=16, n_draft=K)


@pytest.fixture(scope="module")
def models():
    jcfg, jparams, tcfg, tparams = tiny_models()
    jdcfg, jdparams, tdparams = tiny_draft_params(max_len=64, n_draft=K)
    tdcfg = presets.tiny_draft_model(max_len=64, n_draft=K)[0]
    return (jcfg, jparams, tcfg, tparams), (jdcfg, jdparams, tdcfg,
                                            tdparams)


def _specs(stop=False):
    rs = np.random.RandomState(0)
    return [(rs.randint(1, 97, size=n).astype(np.int32), m)
            for n, m in ((5, 9), (17, 6), (3, 12), (30, 10))]


def _kwargs(models, draft, **mode):
    (jcfg, jparams, tcfg, tparams), (jdcfg, jdparams, tdcfg, tdparams) = \
        models
    if draft == "self":
        jdcfg, jdparams, tdcfg, tdparams = jcfg, jparams, tcfg, tparams
    jkw = dict(BASE, draft_cfg=jdcfg, draft_params=jdparams, **mode)
    tkw = dict(BASE, draft_cfg=tdcfg, draft_params=tdparams, device="cpu",
               **mode)
    if "rng" in mode:
        import jax

        jkw["rng"] = jax.random.PRNGKey(mode["rng"])
        tkw["rng"] = prng.PRNGKey(mode["rng"])
    return jkw, tkw


def _run(mod, cfg, params, specs, stop=None, **kw):
    b = mod.ContinuousBatcher(cfg, params, **kw)
    out = {c.rid: list(c.tokens) for c in b.run(
        mod.Request(prompt=p.copy(), max_new_tokens=n, stop_token=stop)
        for p, n in specs)}
    assert b.alloc.rows == {}
    return out, b


MODES = {
    "sync": ("preset", {}),
    "sync_self": ("self", {}),
    "multi_step": ("self", dict(multi_step=8)),
    "multi_step_preset": ("preset", dict(multi_step=5)),
    "overlap": ("self", dict(overlap=True)),
    "overlap_preset_stop": ("preset", dict(overlap=True, stop=45)),
    "chunked": ("preset", dict(prefill_chunk=16)),
    "prefix_cache": ("self", dict(prefix_cache_pages=8)),
    "draft_int8": ("self", dict(draft_quantized_cache=True)),
    "target_int8": ("preset", dict(quantized_cache=True)),
    "sampled": ("self", dict(temperature=0.8, top_k=50, top_p=0.9, rng=3)),
    "sampled_preset": ("preset", dict(temperature=0.8, top_k=20, rng=5)),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_spec_batcher_streams_equal_the_jax_batchers(models, mode):
    from tfmesos_tpu import serving as js

    draft, flags = MODES[mode]
    flags = dict(flags)
    stop = flags.pop("stop", None)
    jkw, tkw = _kwargs(models, draft, **flags)
    specs = _specs()
    if "prefix_cache_pages" in flags:   # repeats hit the cache
        specs = specs + [(specs[1][0].copy(), 5), (specs[3][0].copy(), 4)]
    want, jb = _run(js, models[0][0], models[0][1], specs, stop, **jkw)
    got, tb = _run(ts, models[0][2], models[0][3], specs, stop, **tkw)
    assert got == want
    assert tb.acceptance_rate == jb.acceptance_rate
    for k in ("spec_rounds", "spec_row_rounds", "spec_committed"):
        assert getattr(tb, k) == getattr(jb, k), k
    if draft == "self" and "temperature" not in flags:
        assert tb.acceptance_rate == 1.0
    if "prefix_cache_pages" in flags:
        assert tb.prefix_cache_stats() == jb.prefix_cache_stats()
    assert tb.paged_launches_per_block() == jb.paged_launches_per_block()
    assert tb.d_side.alloc.rows == {} or all(
        not p for p in tb.d_side.alloc.rows.values())


def test_spec_streams_equal_target_only_when_greedy(models):
    """Greedy speculation serves the target-only batcher's streams,
    whatever the draft proposes."""
    specs = _specs()
    _, tkw = _kwargs(models, "preset")
    got, _ = _run(ts, models[0][2], models[0][3], specs, **tkw)
    plain = {k: v for k, v in tkw.items()
             if k not in ("draft_cfg", "draft_params", "n_draft")}
    want, _ = _run(ts, models[0][2], models[0][3], specs, **plain)
    assert got == want


class _Stub:
    """A capture stub: the first call of a key runs the step eagerly and
    records the key; later calls replay (run) it."""

    def __init__(self, g):
        self.keys = []
        g._warm_capture = self._capture
        g.eager = False

    def _capture(self, key, step):
        step()
        self.keys.append(key)


def test_warmup_covers_every_speculative_shape(models, monkeypatch):
    """After ``warmup()`` the speculative serve loop (admission
    prefill, draft chunks, rounds at every table width, prefix-cache
    tails) captures nothing new, and the warmed batcher's streams equal
    a cold one's."""
    specs = _specs() + [(np.arange(1, 40, dtype=np.int32), 20)]
    _, tkw = _kwargs(models, "preset", prefix_cache_pages=8)
    cold, _ = _run(ts, models[0][2], models[0][3], specs, **tkw)
    b = ts.ContinuousBatcher(models[0][2], models[0][3], **tkw)
    stub = _Stub(b._graphs)
    names = b.warmup()["compiled"]
    assert any(n.startswith("spec_round[") for n in names)
    assert any(n.startswith("draft_chunk[") for n in names)
    assert not any(n.startswith("decode[") for n in names)
    warmed = set(stub.keys)
    got = {c.rid: list(c.tokens) for c in b.run(
        ts.Request(prompt=p.copy(), max_new_tokens=n) for p, n in specs)}
    assert got == cold
    assert set(stub.keys) == warmed, set(stub.keys) - warmed


def test_multi_step_runs_r_rounds_a_dispatch(models):
    """``multi_step=8`` at k = 3 fuses R = ceil(8 / 4) = 2 rounds into
    each dispatch (the reference's ``_spec_rounds``)."""
    _, tkw = _kwargs(models, "preset", multi_step=8)
    b = ts.ContinuousBatcher(models[0][2], models[0][3], **tkw)
    assert b._spec_rounds == 2
    list(b.run([ts.Request(prompt=np.arange(1, 6, dtype=np.int32),
                           max_new_tokens=4)]))
    assert b.spec_rounds == 2 * b.decode_ticks and b.decode_ticks >= 1
