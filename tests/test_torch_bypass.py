"""The port's bypass registry against the reference's
(``serving.compute_bypass_reasons``): over the whole flag grid the
port accepts (speculation and its int8 draft pool, the schedule modes
``pipeline_depth``, ``overlap``, ``multi_step``, and ``fused_prefill``
with ``tokens_per_tick``), the same reasons, on the registry and on a
live batcher alike; every reason within ``BYPASS_ALLOWLIST`` (the same
allowlist, key for key), a mesh's data shards included; a mesh over
an axis the batcher does not shard over is refused by name, never
silently ignored."""

import itertools

import numpy as np
import pytest
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu import serving as js
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.models import presets
from tfmesos_tpu_torch.parallel import mesh as tmesh


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
            dict(n_shards=2)]


@pytest.mark.parametrize("flags", UNPORTED,
                         ids=lambda f: next(iter(f)))
def test_unported_modes_raise(flags):
    """Speculation, the int8 draft pool (with and without speculation)
    and a mesh's data shards all give the reference's reasons now."""
    for q in (False, True):
        for spec in (False, True):
            kw = dict(flags, quantized_cache=q)
            if "speculative" not in flags:
                kw["speculative"] = spec
            want = js.compute_bypass_reasons(**kw)
            got = ts.compute_bypass_reasons(**kw)
            assert got == want
            for reg, val in got.items():
                assert val is None or val in ts.BYPASS_ALLOWLIST[reg]


LAG_MODES = [dict(pipeline_depth=1), dict(overlap=True), dict(multi_step=2)]


@pytest.mark.parametrize("flags", LAG_MODES, ids=lambda f: next(iter(f)))
def test_schedule_modes_equal_the_references(flags):
    for q in (False, True):
        got = ts.compute_bypass_reasons(quantized_cache=q, **flags)
        assert got == js.compute_bypass_reasons(quantized_cache=q, **flags)


GRID = list(itertools.product((False, True), (1, 2), (0, 1), (False, True),
                              (1, 4)))


@pytest.mark.parametrize("spec,shards,pd,ov,ms", GRID,
                         ids=lambda v: str(int(v)))
def test_every_combination_equals_the_references_or_raises(spec, shards, pd,
                                                           ov, ms):
    """The whole flag grid, an int8 target and draft pool each way, with
    and without a mesh's data shards: the port's reasons are the
    reference's (and within the allowlist)."""
    for q, dq in itertools.product((False, True), repeat=2):
        flags = dict(speculative=spec, n_shards=shards, pipeline_depth=pd,
                     overlap=ov, multi_step=ms, quantized_cache=q,
                     draft_quantized_cache=dq)
        want = js.compute_bypass_reasons(**flags)
        got = ts.compute_bypass_reasons(**flags)
        assert got == want
        for reg, val in got.items():
            assert val is None or val in ts.BYPASS_ALLOWLIST[reg]


@pytest.mark.parametrize("kw", [
    dict(mesh="sp"), dict(prefix=np.arange(4)),
    dict(draft_cfg=object(), draft_params={}), dict(draft_n_pages=8)],
    ids=lambda kw: next(iter(kw)))
def test_batcher_refuses_unported_modes(kw):
    """A mesh that is not a data x tp mesh is refused by name; a static
    prefix, a draft model and the draft pool's size build a batcher that
    records the reference batcher's reasons and geometry."""
    from tfmesos_tpu.fleet.replica import tiny_draft_model as jax_draft
    from tfmesos_tpu.fleet.replica import tiny_model as jax_tiny_model

    cfg, params = presets.tiny_model()
    base = dict(rows=2, max_len=64, page_size=16, prefill_bucket=16)
    if "mesh" in kw:
        other = tmesh.RankMesh({kw["mesh"]: 2}, 0, "cpu", make_groups=False)
        with pytest.raises(ValueError, match=r"data \(dp/fsdp\) x tp "
                                             r"meshes; got axes \['sp'\]"):
            ts.ContinuousBatcher(cfg, params, device="cpu", **base,
                                 mesh=other)
        return
    jkw, tkw = dict(kw), dict(kw)
    if "draft_cfg" in kw or "draft_n_pages" in kw:
        jkw.update(zip(("draft_cfg", "draft_params"),
                       jax_draft(max_len=64)))
        tkw.update(zip(("draft_cfg", "draft_params"),
                       presets.tiny_draft_model(max_len=64)))
    b = ts.ContinuousBatcher(cfg, params, device="cpu", **base, **tkw)
    jcfg, jparams = jax_tiny_model(seed=0)
    jb = js.ContinuousBatcher(jcfg, jparams, **base, **jkw)
    for attr in ("prefix_len", "n_pages", "pipeline_bypass_reason",
                 "overlap_bypass_reason", "multi_step_bypass_reason",
                 "suspend_bypass_reason", "fused_prefill_bypass_reason",
                 "preemptible", "_spec_rounds"):
        assert getattr(b, attr) == getattr(jb, attr), attr
    for side in ("t_side", "d_side"):
        ps, js_ = getattr(b, side), getattr(jb, side)
        assert (ps is None) == (js_ is None)
        if ps is not None:
            assert (ps.n_pages, ps.sink, ps.shared_pages, ps.shared_len,
                    ps.tail_template) == (js_.n_pages, js_.sink,
                                          js_.shared_pages, js_.shared_len,
                                          js_.tail_template)
    assert b.paged_launches_per_block() == jb.paged_launches_per_block()


MODES = {"overlap": dict(overlap=True), "multi_step": dict(multi_step=2),
         "pipeline_depth": dict(pipeline_depth=1),
         "overlap+pipeline": dict(overlap=True, pipeline_depth=1),
         "fused_prefill": dict(fused_prefill=True, prefill_chunk=16),
         "fused+overlap": dict(fused_prefill=True, prefill_chunk=16,
                               overlap=True),
         "tokens_per_tick": dict(fused_prefill=True, prefill_chunk=16,
                                 tokens_per_tick=8)}


@pytest.mark.parametrize("name", list(MODES))
def test_batcher_records_the_mode_reasons(name):
    """A live batcher built with the mode records the reference's
    reasons, and its effective modes are the reference batcher's."""
    from tfmesos_tpu.fleet.replica import tiny_model as jax_tiny_model

    kw = dict(rows=2, max_len=64, page_size=16, prefill_bucket=16,
              **MODES[name])
    cfg, params = presets.tiny_model()
    b = ts.ContinuousBatcher(cfg, params, device="cpu", **kw)
    jcfg, jparams = jax_tiny_model(seed=0)
    jb = js.ContinuousBatcher(jcfg, jparams, **kw)
    for attr in ("pipeline_bypass_reason", "overlap_bypass_reason",
                 "multi_step_bypass_reason", "suspend_bypass_reason",
                 "fused_prefill_bypass_reason", "prefix_cache_bypass_reason",
                 "_pipelined", "overlap", "multi_step", "preemptible",
                 "_fused", "tokens_per_tick"):
        assert getattr(b, attr) == getattr(jb, attr), attr
    assert b.paged_launches_per_block() == jb.paged_launches_per_block()
    assert b.fused_tokens_per_tick() == jb.fused_tokens_per_tick()
