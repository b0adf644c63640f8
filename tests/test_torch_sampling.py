"""Sampling in the port against the JAX package on the CPU (float32):
``filter_logits`` masks and ``sample_logits`` draws, sampled
``generate`` (plain, ragged, with a prefix, with ``stop_token``, over an
int8 cache) and the sampled ``ContinuousBatcher``, each on the same
weights (``convert.params_from_jax``) and the same threefry keys.

Streams must be identical.  The port's gumbel noise is jax's to a few
float32 ulps (its ``log`` is torch's, not XLA's: tests/test_torch_prng.py),
so a draw may fork where the two largest ``filtered + gumbel`` of the
reference lie within 1e-4 of each other: every fork is shown to be such
a near-tie, from the reference's own logits and keys, and counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401
from torch_parity import to_torch as _t

from tfmesos_tpu import serving as js
from tfmesos_tpu.fleet.replica import tiny_model as jax_tiny_model
from tfmesos_tpu.models import transformer as jt
from tfmesos_tpu_torch import convert
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.models import presets
from tfmesos_tpu_torch.models import transformer as tt
from tfmesos_tpu_torch.ops import prng

NEAR_TIE = 1e-4
MODES = {"temperature": dict(temperature=0.8),
         "top_k": dict(temperature=0.8, top_k=5),
         "top_p": dict(temperature=1.2, top_p=0.9),
         "both": dict(temperature=0.7, top_k=20, top_p=0.8)}


@pytest.fixture(scope="module")
def models():
    """(jcfg, tcfg, {int8 weights: (JAX params, port params)}), as
    tests/test_torch_generate.py builds them."""
    base = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=64, max_seq_len=128)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **base)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **base)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(3))
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, {False: (jp, tp),
                        True: (jt.quantize_params(jcfg, jp),
                               tt.quantize_params(tcfg, tp))}


def _logits(shape=(6, 97), seed=0, scale=3.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.9), (8, 0.7),
                                         (None, 1.0), (97, None)])
@pytest.mark.parametrize("temperature", [0.5, 1.0, 1.7])
def test_filter_logits_masks_equal_jax(top_k, top_p, temperature):
    for seed in range(4):
        x = _logits(seed=seed)
        want = np.asarray(jt.filter_logits(jnp.asarray(x), temperature,
                                           top_k, top_p))
        got = tt.filter_logits(torch.from_numpy(x), temperature, top_k,
                               top_p).numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        kept = ~np.isneginf(want)
        np.testing.assert_array_equal(got[kept], want[kept])
        assert kept.any(axis=-1).all()           # the argmax survives
        if top_p == 1.0 and top_k in (None, 97):
            assert kept.all()


def test_filter_and_sample_refusals():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="temperature"):
        tt.filter_logits(x, 0.0)
    for kw, what in ((dict(top_k=0), "top_k"), (dict(top_p=0.0), "top_p"),
                     (dict(top_p=1.5), "top_p")):
        with pytest.raises(ValueError, match=what):
            tt.sample_logits(x, prng.PRNGKey(0), 0.0, **kw)
        with pytest.raises(ValueError, match=what):
            tt.filter_logits(x, 1.0, **kw)


def _gap(z):
    top = np.sort(np.asarray(z, np.float32).reshape(-1))[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("mode", ["greedy"] + list(MODES))
def test_sample_logits_draws_equal_jax(mode):
    """One key for a [B, V] batch and a key a row: the same tokens,
    forks only at near-ties of the reference's filtered + gumbel."""
    kw = MODES.get(mode, dict(temperature=0.0))
    forks = draws = 0
    for seed in range(8):
        x = _logits(shape=(4, 97), seed=seed, scale=2.0)
        jkey = jax.random.PRNGKey(seed)
        rows_j = jax.vmap(lambda r: jax.random.fold_in(jkey, r))(
            jnp.arange(4))
        rows_t = prng.fold_in(prng.PRNGKey(seed), torch.arange(4))
        for jk, tk in ((jkey, prng.PRNGKey(seed)), (rows_j, rows_t)):
            if jk.ndim == 1:
                want = np.asarray(jt.sample_logits(jnp.asarray(x), jk, **kw))
            else:
                want = np.asarray(jax.vmap(
                    lambda l, k: jt.sample_logits(l, k, **kw))(
                        jnp.asarray(x), jk))
            got = tt.sample_logits(torch.from_numpy(x), tk, **kw).numpy()
            for i in np.flatnonzero(got != want):
                f = np.asarray(jt.filter_logits(jnp.asarray(x[i]), **kw))
                g = (jax.random.gumbel(jk, x.shape)[i] if jk.ndim == 1
                     else jax.random.gumbel(jk[i], x.shape[1:]))
                assert _gap(f + np.asarray(g)) < NEAR_TIE
                forks += 1
            draws += got.size
    assert forks <= draws // 100, f"{forks} forks in {draws} draws"


def _generate_key(seed, steps):
    """The reference's key of each token of a generate call: one split
    before the first token, one a step."""
    rng, keys = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, key = jax.random.split(rng)
        keys.append(key)
    return keys


def _check_generate(jcfg, jp, want, got, start, kw, seed, prefix=None):
    """Rows of ``got`` equal ``want`` from ``start`` (per row) on, or fork
    at a near-tie of the reference's filtered + gumbel; returns the
    forks.  The reference's logits at a fork come from its ``forward``
    over the common prefix."""
    forks = 0
    n = want.shape[1] - int(np.max(start))
    keys = _generate_key(seed, n)
    lead = [] if prefix is None else list(prefix)
    for b in range(want.shape[0]):
        s = int(start[b])
        diff = np.flatnonzero(got[b, s:s + n] != want[b, s:s + n])
        if not diff.size:
            continue
        j = int(diff[0])
        seq = np.asarray(lead + list(want[b, :s + j]), np.int32)[None]
        logits = jt.forward(jcfg, jp, jnp.asarray(seq))[0, -1]
        f = np.asarray(jt.filter_logits(logits, **kw))
        g = np.asarray(jax.random.gumbel(keys[j], (want.shape[0],
                                                   logits.shape[-1])))[b]
        assert _gap(f + g) < NEAR_TIE, f"row {b} forks at token {j}"
        forks += 1
    return forks


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("int8", [False, True])
def test_sampled_generate_streams_equal_jax(models, mode, int8):
    """Plain, ragged, over a shared prefix and with a stop token; int8
    weights with an int8 cache."""
    jcfg, tcfg, params = models
    jp, tp = params[int8]
    kw = MODES[mode]
    prompt = np.random.RandomState(0).randint(0, 97, (3, 9)).astype(np.int32)
    lens = np.array([5, 9, 2], np.int32)
    prefix = np.arange(6, dtype=np.int32) * 7
    forks = 0
    for seed, extra, start in (
            (1, {}, np.full(3, 9)),
            (2, dict(prompt_lens=lens), lens),
            (3, dict(prefix=prefix), np.full(3, 15))):
        jx = {k: jnp.asarray(v) for k, v in extra.items()}
        tx = {k: _t(v) for k, v in extra.items()}
        want = np.asarray(jt.generate(jcfg, jp, jnp.asarray(prompt), 10,
                                      rng=jax.random.PRNGKey(seed),
                                      quantized_cache=int8, **jx, **kw))
        got = tt.generate(tcfg, tp, _t(prompt), 10, rng=prng.PRNGKey(seed),
                          quantized_cache=int8, **tx, **kw).numpy()
        assert got.shape == want.shape
        forks += _check_generate(
            jcfg, jp, want, got, start, kw, seed,
            prefix=list(prefix) if "prefix" in extra else None)
    free = want[:, 15:]
    stop = int(free[0, 3])
    want = np.asarray(jt.generate(jcfg, jp, jnp.asarray(prompt), 10,
                                  rng=jax.random.PRNGKey(4),
                                  quantized_cache=int8, stop_token=stop,
                                  **kw))
    got = tt.generate(tcfg, tp, _t(prompt), 10, rng=prng.PRNGKey(4),
                      quantized_cache=int8, stop_token=stop, **kw).numpy()
    forks += _check_generate(jcfg, jp, want, got, np.full(3, 9), kw, 4)
    assert forks <= 1, f"{forks} forks"


def _jax_batcher_model():
    jcfg, jparams = jax_tiny_model(seed=0)
    tcfg = presets.tiny_model()[0]
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


PROMPT_LENS = [3, 17, 40, 9, 25, 33]
NEW_TOKENS = [6, 10, 5, 12, 8, 7]
KW = dict(rows=2, page_size=16, prefill_bucket=16)


def _prompts():
    rng = np.random.RandomState(11)
    return [rng.randint(0, 97, n).astype(np.int32) for n in PROMPT_LENS]


def _streams(completions):
    return {c.rid: list(c.tokens) for c in completions}


@pytest.mark.parametrize("mode", list(MODES))
def test_sampled_batcher_streams_equal_jax(mode):
    """The same requests, rid_seed and key through both batchers (more
    requests than rows, staggered prompt lengths): the same streams."""
    jcfg, jparams, tcfg, tparams = _jax_batcher_model()
    kw = MODES[mode]
    prompts = _prompts()
    jb = js.ContinuousBatcher(jcfg, jparams, rid_seed=5,
                              rng=jax.random.PRNGKey(3), **KW, **kw)
    want = _streams(jb.run(js.Request(p, n)
                           for p, n in zip(prompts, NEW_TOKENS)))
    tb = ts.ContinuousBatcher(tcfg, tparams, rid_seed=5,
                              rng=prng.PRNGKey(3), device="cpu", **KW, **kw)
    got = _streams(tb.run(ts.Request(p, n)
                          for p, n in zip(prompts, NEW_TOKENS)))
    assert got == want
    assert tb.peak_pages_used == jb.peak_pages_used


def test_sampled_request_same_alone_and_in_a_mix():
    """A request's draws follow its (rid, step) keys only: served alone
    under its rid, it gives the tokens it gives inside a staggered mix."""
    _, _, tcfg, tparams = _jax_batcher_model()
    prompts = _prompts()
    kw = dict(temperature=0.9, top_k=30, rng=prng.PRNGKey(8), device="cpu",
              **KW)
    mix = _streams(ts.ContinuousBatcher(tcfg, tparams, rid_seed=100,
                                        **kw).run(
        ts.Request(p, n) for p, n in zip(prompts, NEW_TOKENS)))
    for i in (0, 3, 5):
        alone = _streams(ts.ContinuousBatcher(
            tcfg, tparams, rid_seed=100 + i, **kw).run(
                [ts.Request(prompts[i], NEW_TOKENS[i])]))
        assert alone == {100 + i: mix[100 + i]}
    # Another key draws another stream.
    other = _streams(ts.ContinuousBatcher(
        tcfg, tparams, rid_seed=100, **dict(kw, rng=prng.PRNGKey(9))).run(
            ts.Request(p, n) for p, n in zip(prompts, NEW_TOKENS)))
    assert other != mix
