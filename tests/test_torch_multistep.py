"""``multi_step`` (K decode steps a block, one host sync a block) of the
port's ContinuousBatcher on the CPU, held to the JAX batcher's
synchronous one-token tick on the same weights (the JAX tiny model's,
``convert.params_from_jax``) with exact token equality:

- K in {1, 2, 4}: greedy, sampled and over an int8 pool;
- with chunked prefill, and with the prefix cache (stats equal too);
- a row whose quota ends mid-block at a page boundary: its overrun
  writes land on the sink page only (the pool is bit-identical to the K
  = 1 run's elsewhere) and a neighbour's stream is untouched;
- K-block replays through a stub capture count K ticks of launches.
"""

import numpy as np
import pytest
import torch
from test_torch_warmup import _stub_graphs, zero_launches  # noqa: F401
from torch_parity import jax_compile_cache_off  # noqa: F401
from torch_parity import Golden, batcher_streams, tiny_models

from tfmesos_tpu_torch import graphs
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.ops import attention, prng

V = 97
KW = dict(rows=3, max_len=96, page_size=16, prefill_bucket=16)


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(scope="module")
def golden(models):
    return Golden(models)


def _specs():
    """Staggered prompts and quotas, more requests than rows (rows are
    re-admitted), quotas that end mid-block for every K > 1."""
    rng = np.random.RandomState(41)
    return [(rng.randint(0, V, size=n).astype(np.int32), q)
            for n, q in ((3, 7), (21, 5), (13, 9), (34, 2), (16, 11),
                         (5, 6), (9, 1))]


def _port(models, specs, **kw):
    tcfg, tparams = models[2:]
    if "rng" in kw:
        kw = dict(kw, rng=prng.PRNGKey(kw["rng"]))
    b = ts.ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
    got = batcher_streams(b.run(ts.Request(p.copy(), n) for p, n in specs))
    assert b.alloc.rows == {}
    return got, b


VARIANTS = {"greedy": {}, "sampled": dict(temperature=0.8, top_k=20, rng=3),
            "int8": dict(quantized_cache=True)}


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_multistep_streams_equal_jax_sync(models, golden, variant, k):
    specs = _specs()
    kw = dict(KW, **VARIANTS[variant])
    got, b = _port(models, specs, multi_step=k, **kw)
    assert got == golden(variant, specs, **kw)
    assert b.multi_step == k and b.multi_step_bypass_reason is None
    # One sync a block: fewer blocks than tokens once K > 1.
    assert b.decode_tokens == sum(n - 1 for _, n in specs)
    if k > 1:
        assert b.decode_ticks < b.decode_tokens


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("mode", ["chunked", "pcache", "chunked+pcache"])
def test_multistep_with_chunks_and_prefix_cache(models, golden, mode, k):
    rng = np.random.RandomState(21)
    system = rng.randint(0, V, size=36).astype(np.int32)
    specs = [(np.concatenate([system, rng.randint(0, V, 5 + 3 * i)
                              .astype(np.int32)]), 3 + i % 4)
             for i in range(6)]
    kw = dict(KW)
    if "chunked" in mode:
        kw.update(prefill_chunk=16)
    if "pcache" in mode:
        kw.update(prefix_cache_pages=12)
    got, b = _port(models, specs, multi_step=k, **kw)
    assert got == golden(mode, specs, **kw)
    if "pcache" in mode:
        want, b1 = _port(models, specs, **kw)
        assert b.prefix_cache_stats() == b1.prefix_cache_stats()
        assert b.prefix_cache_stats()["hits"] > 0


def test_quota_ending_mid_block_at_a_page_boundary(models, golden):
    """Prompt 21 (padded to 32) plus 28 tokens reserves exactly 48
    positions, three pages of 16: K = 4 blocks from position 21 end
    with the block at 45, which writes 48 past the reservation (the
    table is 4 wide throughout, for K = 1 too).  Alone, the pool after
    the run equals the K = 1 run's bit for bit on every page but the
    sink; beside a neighbour, both streams are the golden ones."""
    rng = np.random.RandomState(5)
    edge = (rng.randint(0, V, 21).astype(np.int32), 28)
    pools = {}
    for k in (1, 4):
        got, b = _port(models, [edge], multi_step=k, **KW)
        assert got == golden("edge", [edge], **KW)
        pools[k] = (b.t_side.sink, [x.clone() for x in (b.pool["k"],
                                                          b.pool["v"])])
    sink = pools[1][0]
    assert pools[4][0] == sink
    keep = [p for p in range(pools[1][1][0].shape[1]) if p != sink]
    for a, c in zip(pools[1][1], pools[4][1]):
        assert torch.equal(a[:, keep], c[:, keep])
    specs = [edge, (rng.randint(0, V, 20).astype(np.int32), 30)]
    got, _ = _port(models, specs, multi_step=4, **KW)
    assert got == golden("edge+neighbour", specs, **KW)


def test_multistep_graphed_and_eager_count_alike(monkeypatch, models,
                                                 zero_launches):  # noqa: F811
    """K = 4 blocks through the stub capture: the same streams as the
    eager path and K x n_layers paged launches a block (each step's
    layers counted as the card's wrappers count them)."""
    tcfg, tparams = models[2:]
    specs = _specs()
    runs = {}
    for eager in (True, False):
        b = ts.ContinuousBatcher(tcfg, tparams, device="cpu", multi_step=4,
                                 **KW)
        if not eager:
            b._graphs, made = _stub_graphs(monkeypatch)
        step = ts.decode_step

        def counted(*a, **kw):
            if a[3].shape[1] == 1:      # a decode step, not a prefill
                attention.LAUNCHES["flash_decode_paged"] += tcfg.n_layers
            return step(*a, **kw)

        monkeypatch.setattr(ts, "decode_step", counted)
        before = graphs.launch_counts()["flash_decode_paged"]
        got = batcher_streams(b.run(ts.Request(p.copy(), n)
                                    for p, n in specs))
        n = graphs.launch_counts()["flash_decode_paged"] - before
        monkeypatch.setattr(ts, "decode_step", step)
        runs[eager] = (got, n, b.decode_ticks)
    assert runs[True][0] == runs[False][0]
    assert runs[True][2] == runs[False][2]
    assert runs[True][1] == runs[False][1] == \
        4 * tcfg.n_layers * runs[True][2]
    assert any(isinstance(k, int) for k in b._graphs._graphs)
