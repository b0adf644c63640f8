"""The port's speculative decoding functions against the JAX package's
on the CPU: ``greedy_accept_counts`` and ``rejection_accept`` on seeded
arrays (exact integers, distributions within 1e-6),
``speculative_cache_depth``, and ``speculative_generate`` (the JAX tiny
model and tiny draft carried across by ``convert.params_from_jax``),
greedy and sampled, ragged, with a prefix, an int8 target cache, a
caller's paged cache and a stop token: identical tokens.  Sampled
streams use the reference's key schedule, and on the CPU they are
bit-identical here; a categorical draw at a near-tie could fork by an
ulp of the logarithm (``ops/prng.py``), which these seeds never meet."""

import numpy as np
import pytest
import torch
from torch_parity import (jax_compile_cache_off,  # noqa: F401
                          tiny_draft_params, tiny_models)

from tfmesos_tpu_torch.models import presets
from tfmesos_tpu_torch.models import transformer as tt
from tfmesos_tpu_torch.ops import prng

K = 3
NEW = 12


@pytest.fixture(scope="module")
def models():
    jcfg, jparams, tcfg, tparams = tiny_models()
    jdcfg, jdparams, tdparams = tiny_draft_params(max_len=64, n_draft=K)
    tdcfg = presets.tiny_draft_model(max_len=64, n_draft=K)[0]
    return (jcfg, jparams, tcfg, tparams), (jdcfg, jdparams, tdcfg,
                                            tdparams)


@pytest.mark.parametrize("seed", range(6))
def test_greedy_accept_counts_equal_the_jax_counts(seed):
    import jax.numpy as jnp

    from tfmesos_tpu.models import transformer as jt

    rs = np.random.RandomState(seed)
    b, k, v = 16, 1 + seed % 5, 4      # a tiny vocab: matches are common
    drafts = rs.randint(0, v, (b, k)).astype(np.int32)
    g = rs.randint(0, v, (b, k + 1)).astype(np.int32)
    g[: b // 2, :k] = drafts[: b // 2]  # some rows accept everything
    want = np.asarray(jt.greedy_accept_counts(jnp.asarray(drafts),
                                              jnp.asarray(g)))
    got = tt.greedy_accept_counts(torch.from_numpy(drafts).long(),
                                  torch.from_numpy(g).long())
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("seed", range(6))
def test_rejection_accept_equals_the_jax_math(seed):
    import jax
    import jax.numpy as jnp

    from tfmesos_tpu.models import transformer as jt

    rs = np.random.RandomState(100 + seed)
    b, k, v = 8, 1 + seed % 4, 11
    logits_d = rs.standard_normal((b, k, v)).astype(np.float32) * 2
    logits_t = rs.standard_normal((b, k + 1, v)).astype(np.float32) * 2
    if seed % 2:                        # filtered: zeros in both
        logits_d[..., :3] = -np.inf
        logits_t[..., 5:7] = -np.inf
    pd = np.asarray(jax.nn.softmax(jnp.asarray(logits_d), -1))
    pt = np.asarray(jax.nn.softmax(jnp.asarray(logits_t), -1))
    drafts = rs.randint(0, v, (b, k)).astype(np.int32)
    drafts[0] = np.argmax(pt[0, :k], -1)    # a likely full accept
    u = rs.uniform(size=(b, k)).astype(np.float32)
    a, dist = jt.rejection_accept(*map(jnp.asarray, (drafts, pd, pt, u)))
    ta, tdist = tt.rejection_accept(
        torch.from_numpy(drafts).long(),
        *(torch.from_numpy(np.array(x)) for x in (pd, pt, u)))
    assert ta.tolist() == np.asarray(a).tolist()
    np.testing.assert_allclose(tdist.numpy(), np.asarray(dist), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("args", [(7, 12, 4, 0), (1, 1, 1, 0), (9, 3, 2, 5)])
def test_speculative_cache_depth_is_the_references(args):
    from tfmesos_tpu.models import transformer as jt

    assert tt.speculative_cache_depth(*args[:3], prefix_len=args[3]) == \
        jt.speculative_cache_depth(*args[:3], prefix_len=args[3])


CASES = {
    "greedy": dict(),
    "greedy_self_draft": dict(self_draft=True),
    "ragged": dict(ragged=True),
    "sampled_top_k": dict(temperature=0.8, top_k=20, ragged=True),
    "sampled_top_p_self": dict(temperature=0.9, top_p=0.9, self_draft=True),
    "stop_token": dict(stop=True, ragged=True),
    "sampled_stop": dict(temperature=0.7, stop=True),
    "prefix": dict(prefix=True, ragged=True),
    "int8_cache": dict(quantized_cache=True),
    "paged_cache": dict(paged=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_speculative_generate_equals_jax(models, case):
    import jax
    import jax.numpy as jnp

    from tfmesos_tpu.models import transformer as jt

    (jcfg, jparams, tcfg, tparams), (jdcfg, jdparams, tdcfg, tdparams) = \
        models
    kw = dict(CASES[case])
    if kw.pop("self_draft", False):
        jdcfg, jdparams, tdcfg, tdparams = jcfg, jparams, tcfg, tparams
    rs = np.random.RandomState(sorted(CASES).index(case))
    b, tp = 3, 9
    prompt = rs.randint(1, 97, size=(b, tp)).astype(np.int32)
    jkw, tkw = {}, {}
    if kw.pop("ragged", False):
        lens = np.array([9, 4, 6], np.int32)
        jkw["prompt_lens"] = jnp.asarray(lens)
        tkw["prompt_lens"] = torch.from_numpy(lens)
    if kw.pop("stop", False):
        # A token the greedy target emits early in some row.
        jkw["stop_token"] = tkw["stop_token"] = 45
    if kw.pop("prefix", False):
        pfx = rs.randint(1, 97, size=7).astype(np.int32)
        jkw["prefix"], tkw["prefix"] = jnp.asarray(pfx), torch.from_numpy(pfx)
    if kw.pop("paged", False):
        depth = jt.speculative_cache_depth(tp, NEW, K)
        page = 8
        per_row = -(-depth // page)
        jpool = jt.init_paged_cache(jcfg, b * per_row + 1, page)
        tpool = tt.init_paged_cache(tcfg, b * per_row + 1, page)
        table = np.arange(1, b * per_row + 1, dtype=np.int32).reshape(
            b, per_row)
        jkw["cache"] = dict(jpool, pages=jnp.asarray(table))
        tkw["cache"] = dict(tpool, pages=torch.from_numpy(table))
    jkw.update(kw)
    tkw.update(kw)
    want = np.asarray(jt.speculative_generate(
        jcfg, jparams, jdcfg, jdparams, jnp.asarray(prompt), NEW,
        n_draft=K, rng=jax.random.PRNGKey(3), **jkw))
    got = tt.speculative_generate(
        tcfg, tparams, tdcfg, tdparams, torch.from_numpy(prompt), NEW,
        n_draft=K, rng=prng.PRNGKey(3), **tkw).numpy()
    if "stop_token" in jkw:
        # The tail after a row's first stop is unspecified: compare up
        # to and including it.
        start = (tp if "prompt_lens" not in jkw
                 else np.asarray(jkw["prompt_lens"]))
        for i in range(b):
            s = int(start if np.isscalar(start) else start[i])
            row_w, row_g = list(want[i, s:]), list(got[i, s:])
            cut = row_w.index(45) + 1 if 45 in row_w else len(row_w)
            assert row_g[:cut] == row_w[:cut]
        return
    assert got.shape == want.shape
    assert (got == want).all(), (want, got)


def test_speculative_generate_equals_generate_when_greedy(models):
    """Greedy speculation is exactly the target's greedy continuation
    whatever the draft proposes (held against the port's generate)."""
    (_, _, tcfg, tparams), (_, _, tdcfg, tdparams) = models
    prompt = torch.from_numpy(np.random.RandomState(9).randint(
        1, 97, size=(4, 11)).astype(np.int32))
    lens = torch.tensor([11, 3, 8, 5])
    want = tt.generate(tcfg, tparams, prompt, 20, prompt_lens=lens)
    got = tt.speculative_generate(tcfg, tparams, tdcfg, tdparams, prompt,
                                  20, n_draft=K, prompt_lens=lens)
    assert torch.equal(got, want)
