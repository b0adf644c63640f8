"""The port's bypass registry against the reference's
(``serving.compute_bypass_reasons``): over every flag combination the
port accepts, the same reasons; every reason within
``BYPASS_ALLOWLIST`` (the same allowlist, key for key); a mode the port
does not have yet raises ``NotImplementedError``, in the registry and in
the batcher alike, never silently ignored."""

import itertools

import numpy as np
import pytest

from tfmesos_tpu import serving as js
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.models import presets


def test_allowlist_is_the_references():
    assert ts.BYPASS_ALLOWLIST == js.BYPASS_ALLOWLIST


@pytest.mark.parametrize("quantized", [False, True])
def test_reasons_equal_the_references_over_every_ported_config(quantized):
    got = ts.compute_bypass_reasons(quantized_cache=quantized)
    assert got == js.compute_bypass_reasons(quantized_cache=quantized)
    for reg, val in got.items():
        assert val is None or val in ts.BYPASS_ALLOWLIST[reg]
    cfg, params = presets.tiny_model()
    for pcache in (0, 4):
        b = ts.ContinuousBatcher(cfg, params, rows=2, max_len=64,
                                 page_size=16, prefill_bucket=16,
                                 quantized_cache=quantized,
                                 prefix_cache_pages=pcache, device="cpu")
        want = got["prefix_cache"] if pcache else None
        assert b.prefix_cache_bypass_reason == want
        assert b.prefix_cache_active == (bool(pcache) and not quantized)
        assert b.suspend_bypass_reason == got["suspend"]
        assert b.preemptible


UNPORTED = [dict(speculative=True), dict(draft_quantized_cache=True),
            dict(n_shards=2), dict(pipeline_depth=1), dict(overlap=True),
            dict(multi_step=2)]


@pytest.mark.parametrize("flags", UNPORTED,
                         ids=lambda f: next(iter(f)))
def test_unported_modes_raise(flags):
    for q in (False, True):
        with pytest.raises(NotImplementedError):
            ts.compute_bypass_reasons(quantized_cache=q, **flags)
        js.compute_bypass_reasons(quantized_cache=q, **flags)


def test_every_unported_combination_raises():
    for spec, shards, pd, ov, ms in itertools.product(
            (False, True), (1, 2), (0, 1), (False, True), (1, 4)):
        flags = dict(speculative=spec, n_shards=shards, pipeline_depth=pd,
                     overlap=ov, multi_step=ms)
        if flags == dict(speculative=False, n_shards=1, pipeline_depth=0,
                         overlap=False, multi_step=1):
            continue
        with pytest.raises(NotImplementedError):
            ts.compute_bypass_reasons(**flags)


@pytest.mark.parametrize("kw", [
    dict(overlap=True), dict(multi_step=2), dict(pipeline_depth=1),
    dict(mesh=object()), dict(prefix=np.arange(4)), dict(kv_tier=object()),
    dict(fused_prefill=True, prefill_chunk=16), dict(tokens_per_tick=8),
    dict(draft_cfg=object(), draft_params={})],
    ids=lambda kw: next(iter(kw)))
def test_batcher_refuses_unported_modes(kw):
    cfg, params = presets.tiny_model()
    with pytest.raises(NotImplementedError):
        ts.ContinuousBatcher(cfg, params, rows=2, max_len=64, page_size=16,
                             device="cpu", **kw)
