"""The port's linear-cache ``decode_step`` and greedy ``generate``
against the JAX package on the CPU (float32), for fp and int8 weights
(``quantize_params``) over fp and int8 KV caches — the four
combinations of ``examples/generate.py``'s ``--int8`` and
``--int8-kv``.

The same JAX ``init_params`` weights go to both sides through
``convert.params_from_jax``; each side quantizes them itself (the two
``quantize_params`` are bit-equal: tests/test_torch_quant.py).  Greedy
token streams must be IDENTICAL; logits atol 1e-4 (two float32 layers
of matmuls summed in different orders); dequantized cache contents
atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401
from torch_parity import to_torch as _t

from tfmesos_tpu.models import transformer as jt
from tfmesos_tpu_torch import convert
from tfmesos_tpu_torch.models import transformer as tt

LOGITS_ATOL = 1e-4
CACHE_ATOL = 1e-5
COMBOS = [(w8, kv8) for w8 in (False, True) for kv8 in (False, True)]


@pytest.fixture(scope="module")
def models():
    """(jcfg, tcfg, {int8 weights: (JAX params, port params)}): the CI
    model's GQA variant (2 layers, 4 heads over 2 kv heads)."""
    base = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=64, max_seq_len=128)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **base)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **base)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(3))
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, {False: (jp, tp),
                        True: (jt.quantize_params(jcfg, jp),
                               tt.quantize_params(tcfg, tp))}


def _prompt(b=2, t=9, seed=0):
    return np.random.RandomState(seed).randint(0, 97, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize("int8_weights,int8_kv", COMBOS)
def test_generate_streams_identical_to_jax(models, int8_weights, int8_kv):
    jcfg, tcfg, params = models
    jp, tp = params[int8_weights]
    prompt = _prompt()
    want = np.asarray(jt.generate(jcfg, jp, jnp.asarray(prompt), 10,
                                  quantized_cache=int8_kv))
    got = tt.generate(tcfg, tp, _t(prompt), 10, quantized_cache=int8_kv)
    assert got.dtype == torch.int32 and got.shape == (2, 19)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("int8_weights,int8_kv", COMBOS)
def test_prefill_logits_match_jax(models, int8_weights, int8_kv):
    """Logits of the prompt chunk, prefilled from empty and over a
    7-token prefix (the chunk then reads the cache, int8 or not)."""
    jcfg, tcfg, params = models
    jp, tp = params[int8_weights]
    prompt, prefix = _prompt(), np.arange(7, dtype=np.int32) * 5
    for pre in (None, prefix):
        jl, jc = jt._prefill(jcfg, jp, jnp.asarray(prompt), 30,
                             quantized=int8_kv,
                             prefix=None if pre is None else jnp.asarray(pre))
        tl, tc = tt._prefill(tcfg, tp, _t(prompt).long(), 30,
                             quantized=int8_kv,
                             prefix=None if pre is None else _t(pre).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGITS_ATOL, rtol=0)
        for leaf in ("k", "v"):
            for li in range(jcfg.n_layers):
                np.testing.assert_allclose(
                    tt._cache_read(tc[leaf], li, torch.float32).numpy(),
                    np.asarray(jt._cache_read(jc[leaf], li, jnp.float32)),
                    atol=CACHE_ATOL, rtol=0)


def test_int8_weights_change_the_logits(models):
    """The quantized tree is really what runs: its logits move well past
    the parity tolerance from the float32 weights'."""
    _, tcfg, params = models
    tokens = _t(_prompt()).long()
    fp = tt.forward(tcfg, params[False][1], tokens)
    q8 = tt.forward(tcfg, params[True][1], tokens)
    assert float((fp - q8).abs().max()) > 100 * LOGITS_ATOL


def test_decode_steps_over_an_int8_cache_match_jax(models):
    """Prefill, then ragged single-token steps and a 3-token chunk over
    an int8 linear cache with int8 weights: per-step logits and the
    dequantized cache."""
    jcfg, tcfg, params = models
    jp, tp = params[True]
    rng = np.random.RandomState(1)
    jcache = jt.init_cache(jcfg, 2, 40, quantized=True)
    tcache = tt.init_cache(tcfg, 2, 40, quantized=True)
    prompt = _prompt(t=12, seed=2)
    jl, jcache = jt.decode_step(jcfg, jp, jcache, jnp.asarray(prompt), 0)
    tl, tcache = tt.decode_step(tcfg, tp, tcache, _t(prompt).long(), 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL,
                               rtol=0)
    pos = np.array([5, 12], np.int32)            # ragged: row 0 is shorter
    for t in (1, 1, 3):
        tok = rng.randint(0, 97, (2, t)).astype(np.int32)
        jl, jcache = jt.decode_step(jcfg, jp, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos))
        tl, tcache = tt.decode_step(tcfg, tp, tcache, _t(tok).long(),
                                    _t(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGITS_ATOL, rtol=0)
        pos = pos + t
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(tcache[leaf].values.numpy(),
                                      np.asarray(jcache[leaf].values))
        np.testing.assert_allclose(tcache[leaf].scales.numpy(),
                                   np.asarray(jcache[leaf].scales),
                                   atol=CACHE_ATOL, rtol=0)


def test_generate_ragged_prefix_and_stop_match_jax(models):
    """The full int8 configuration with ``prompt_lens``, a shared
    ``prefix`` and a ``stop_token`` (one the stop-free stream emits
    mid-way, so the freeze is exercised)."""
    jcfg, tcfg, params = models
    jp, tp = params[True]
    prompt = _prompt()
    lens = np.array([5, 9], np.int32)
    want = np.asarray(jt.generate(jcfg, jp, jnp.asarray(prompt), 8,
                                  quantized_cache=True,
                                  prompt_lens=jnp.asarray(lens)))
    got = tt.generate(tcfg, tp, _t(prompt), 8, quantized_cache=True,
                      prompt_lens=_t(lens))
    np.testing.assert_array_equal(got.numpy(), want)

    prefix = np.arange(7, dtype=np.int32) * 3
    want = np.asarray(jt.generate(jcfg, jp, jnp.asarray(prompt), 8,
                                  quantized_cache=True,
                                  prefix=jnp.asarray(prefix)))
    got = tt.generate(tcfg, tp, _t(prompt), 8, quantized_cache=True,
                      prefix=_t(prefix))
    assert got.shape == (2, 7 + 9 + 8)
    np.testing.assert_array_equal(got.numpy(), want)

    free = tt.generate(tcfg, tp, _t(prompt), 8, quantized_cache=True)
    stop = int(free[0, 9 + 3])
    want = np.asarray(jt.generate(jcfg, jp, jnp.asarray(prompt), 8,
                                  quantized_cache=True, stop_token=stop))
    got = tt.generate(tcfg, tp, _t(prompt), 8, quantized_cache=True,
                      stop_token=stop)
    np.testing.assert_array_equal(got.numpy(), want)
    row = got[0, 9:].tolist()
    assert row[row.index(stop):] == [stop] * (8 - row.index(stop))


def test_generate_over_a_paged_int8_cache_matches_jax(models):
    """A caller's paged int8 pool (the batcher's cache) under generate:
    the deferred-write decode path with the int8 self operand."""
    jcfg, tcfg, params = models
    jp, tp = params[True]
    prompt = _prompt()
    alloc = jt.PageAllocator(8, 8)
    for r in range(2):
        alloc.ensure(r, 9 + 8)
    table = np.asarray(alloc.table([0, 1]))
    jcache = dict(jt.init_paged_cache(jcfg, 8, 8, quantized=True),
                  pages=jnp.asarray(table))
    tcache = dict(tt.init_paged_cache(tcfg, 8, 8, quantized=True),
                  pages=_t(table))
    want = np.asarray(jt.generate(jcfg, jp, jnp.asarray(prompt), 8,
                                  cache=jcache))
    got = tt.generate(tcfg, tp, _t(prompt), 8, cache=tcache)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_refusals(models):
    _, tcfg, params = models
    tp = params[False][1]
    prompt = _t(_prompt())
    with pytest.raises(ValueError, match="top_k"):
        tt.generate(tcfg, tp, prompt, 4, temperature=0.8, top_k=0)
    with pytest.raises(ValueError, match="top_p"):
        tt.generate(tcfg, tp, prompt, 4, temperature=0.8, top_p=1.5)
    with pytest.raises(ValueError, match="positions"):
        tt.generate(tcfg, tp, prompt, 8, cache=tt.init_cache(tcfg, 2, 12))
    # Rolling caches are ported (tests/test_torch_rolling.py): a window
    # config's cache holds the window, and the reference's refusals stay.
    wcfg = tt.TransformerConfig(window=8)
    assert tt.init_cache(wcfg, 1, 16)["k"].shape[3] == 8
    wtcfg = dataclasses.replace(tcfg, window=8)
    with pytest.raises(ValueError, match="rolling"):
        tt.generate(wtcfg, tp, prompt, 4, prompt_lens=[2, 3])
    assert torch.equal(tt.generate(tcfg, tp, prompt, 0), prompt)
