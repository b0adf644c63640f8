"""Rolling (sliding-window) caches of the port's ``generate`` against the
JAX ``generate`` on the CPU, on the JAX tiny model's weights with a
window: the cache holds ``min(max_len, window)`` slots, generated tokens
are identical over prompts shorter and longer than the window (the
prefill keeps its last M tokens) and generations that wrap it many
times, float32 and int8 caches; and the reference's two refusals —
ragged positions, and a multi-token chunk over a rolling cache."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu.fleet.replica import tiny_model as jax_tiny_model
from tfmesos_tpu.models import transformer as jt
from tfmesos_tpu_torch import convert
from tfmesos_tpu_torch.models import presets
from tfmesos_tpu_torch.models import transformer as tt


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = jax_tiny_model(seed=0)
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, presets.tiny_model()[0], tparams


def _cfgs(models, window):
    jcfg, _, tcfg, _ = models
    return (dataclasses.replace(jcfg, window=window),
            dataclasses.replace(tcfg, window=window))


@pytest.mark.parametrize("window,plen,new,int8", [
    (8, 12, 10, False), (16, 5, 40, False), (8, 12, 10, True),
    (32, 20, 6, False), (8, 3, 30, True)])
def test_windowed_generate_identical_to_jax(models, window, plen, new, int8):
    _, jparams, _, tparams = models
    jcfg, tcfg = _cfgs(models, window)
    prompt = np.random.RandomState(plen).randint(0, 97, (2, plen)).astype(
        np.int32)
    want = np.asarray(jt.generate(jcfg, jparams, jnp.asarray(prompt), new,
                                  quantized_cache=int8))
    got = tt.generate(tcfg, tparams, torch.from_numpy(prompt).long(), new,
                      quantized_cache=int8)
    np.testing.assert_array_equal(got.numpy(), want)
    # The graph helper's eager diagnostic computes the same tokens.
    eager = tt.generate(tcfg, tparams, torch.from_numpy(prompt).long(), new,
                        quantized_cache=int8, _eager=True)
    assert torch.equal(eager, got)


def test_cache_is_window_sized_and_matches_jax_write(models):
    """The cache after a wrapping prefill holds, slot for slot, what the
    reference's modular scatter wrote."""
    _, jparams, _, tparams = models
    jcfg, tcfg = _cfgs(models, 8)
    for int8 in (False, True):
        jc = jt.init_cache(jcfg, 1, 64, quantized=int8)
        tc = tt.init_cache(tcfg, 1, 64, quantized=int8)
        leaf = tc["k"].values if int8 else tc["k"]
        assert leaf.shape[3] == 8
        prompt = np.random.RandomState(2).randint(0, 97, (1, 13))
        _, jc = jt.decode_step(jcfg, jparams, jc, jnp.asarray(prompt), 0)
        tt.decode_step(tcfg, tparams, tc, torch.from_numpy(prompt).long(), 0)
        for name in ("k", "v"):
            if int8:
                np.testing.assert_array_equal(
                    tc[name].values.numpy(), np.asarray(jc[name].values))
                np.testing.assert_allclose(
                    tc[name].scales.numpy(), np.asarray(jc[name].scales),
                    rtol=1e-6)
            else:
                np.testing.assert_allclose(tc[name].numpy(),
                                           np.asarray(jc[name]), atol=1e-5)


def test_rolling_refusals(models):
    _, jparams, _, tparams = models
    jcfg, tcfg = _cfgs(models, 8)
    prompt = np.random.RandomState(4).randint(0, 97, (2, 6)).astype(np.int32)
    with pytest.raises(ValueError, match="ragged"):
        jt.generate(jcfg, jparams, jnp.asarray(prompt), 4,
                    prompt_lens=jnp.asarray([3, 6]))
    with pytest.raises(ValueError, match="ragged"):
        tt.generate(tcfg, tparams, torch.from_numpy(prompt).long(), 4,
                    prompt_lens=[3, 6])
    # A multi-token chunk after the prefill (here: a shared prefix then
    # the prompt chunk at its offset) is refused by both.
    prefix = np.arange(5, dtype=np.int32)
    with pytest.raises(ValueError, match="rolling windowed cache"):
        jt.generate(jcfg, jparams, jnp.asarray(prompt), 4,
                    prefix=jnp.asarray(prefix))
    with pytest.raises(ValueError, match="rolling windowed cache"):
        tt.generate(tcfg, tparams, torch.from_numpy(prompt).long(), 4,
                    prefix=torch.from_numpy(prefix))
    tc = tt.init_cache(tcfg, 2, 16)
    with pytest.raises(ValueError, match="rolling windowed cache"):
        tt.decode_step(tcfg, tparams, tc,
                       torch.from_numpy(prompt).long()[:, :3],
                       torch.tensor(2))
    with pytest.raises(ValueError, match="paged"):
        tt.init_paged_cache(tcfg, 8, 16)
