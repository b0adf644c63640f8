"""Helpers shared by the tests/test_torch_*.py parity tests (the JAX
reference and the PyTorch port in one process, data passed as numpy).

Import :func:`jax_compile_cache_off` into a test module to use it: it is
an autouse module fixture.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def jax_compile_cache_off():
    """Run the module's JAX reference computations without the persistent
    compilation cache, restoring the hooks afterwards.  conftest.py wraps
    jax's ``_cache_read``/``_cache_write`` with the four-argument
    signature of older jax; the installed jax calls them with five, so a
    JAX compile under those wrappers fails at the cache lookup.  The
    parity tests only need JAX to compute: a miss-always read and a
    no-op write keep them off the cache entirely."""
    from jax._src import compiler

    saved = compiler._cache_read, compiler._cache_write
    compiler._cache_read = lambda *args, **kwargs: (None, None)
    compiler._cache_write = lambda *args, **kwargs: None
    try:
        yield
    finally:
        compiler._cache_read, compiler._cache_write = saved


def to_torch(a) -> torch.Tensor:
    """A numpy (or numpy-convertible) array as a CPU tensor."""
    return torch.from_numpy(np.array(a))


def tiny_models():
    """(JAX config, JAX params, port config, port params): the JAX tiny
    model (seed 0) and the same weights carried across by
    ``convert.params_from_jax``."""
    import jax

    from tfmesos_tpu.fleet.replica import tiny_model as jax_tiny_model
    from tfmesos_tpu_torch import convert
    from tfmesos_tpu_torch.models import presets

    jcfg, jparams = jax_tiny_model(seed=0)
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, presets.tiny_model()[0], tparams


def batcher_streams(completions) -> dict:
    """{rid: tokens} of a batcher run's completions."""
    return {c.rid: list(c.tokens) for c in completions}


class Golden:
    """Streams of the JAX batcher in its synchronous, phase-split, one
    token a tick mode (the golden every schedule mode is held to),
    computed once per (requests, config) and kept for the module."""

    def __init__(self, models):
        self.models = models
        self._memo = {}

    def __call__(self, name: str, specs, **kw) -> dict:
        """``specs``: [(prompt, max_new_tokens)]; ``kw``: the batcher's
        arguments (``rng`` as a seed int, made a JAX key here)."""
        import jax

        from tfmesos_tpu import serving as js

        key = (name, tuple(sorted((k, repr(v)) for k, v in kw.items())))
        if key not in self._memo:
            jcfg, jparams = self.models[:2]
            if "rng" in kw:
                kw = dict(kw, rng=jax.random.PRNGKey(kw["rng"]))
            b = js.ContinuousBatcher(jcfg, jparams, **kw)
            self._memo[key] = batcher_streams(b.run(
                js.Request(prompt=p.copy(), max_new_tokens=n)
                for p, n in specs))
            assert b.alloc.rows == {}
        return self._memo[key]
