"""The port's int8 ContinuousBatcher (int8 params from
``quantize_params`` over an int8 page pool, ``quantized_cache=True``)
against the JAX batcher in the same configuration on the CPU, on the
same weights: greedy token streams must be IDENTICAL and the pool's
high-water mark equal."""

import jax
import numpy as np
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu import serving as js
from tfmesos_tpu.fleet.replica import tiny_model as jax_tiny_model
from tfmesos_tpu.models import transformer as jt
from tfmesos_tpu_torch import convert
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.models import presets
from tfmesos_tpu_torch.models import transformer as tt
from tfmesos_tpu_torch.ops.quant import QTensor

PROMPT_LENS = [3, 17, 40, 9, 25]
NEW_TOKENS = [6, 10, 5, 12, 8]
KW = dict(rows=2, page_size=16, prefill_bucket=16, quantized_cache=True)


def test_int8_streams_identical_to_jax_batcher():
    jcfg, jparams = jax_tiny_model(seed=0)
    tcfg = presets.tiny_model()[0]
    jq = jt.quantize_params(jcfg, jparams)
    tq = tt.quantize_params(tcfg, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 97, n).astype(np.int32) for n in PROMPT_LENS]

    tb = ts.ContinuousBatcher(tcfg, tq, device="cpu", **KW)
    assert isinstance(tb.pool["k"], QTensor)
    assert isinstance(tb.params["layers"]["wq"], QTensor)
    got = {c.rid: list(c.tokens) for c in tb.run(
        ts.Request(p, n) for p, n in zip(prompts, NEW_TOKENS))}
    jb = js.ContinuousBatcher(jcfg, jq, **KW)
    want = {c.rid: list(c.tokens) for c in jb.run(
        js.Request(p, n) for p, n in zip(prompts, NEW_TOKENS))}
    assert got == want
    assert tb.peak_pages_used == jb.peak_pages_used
    assert tb.prefills == len(prompts) and tb.decode_ticks > 0
