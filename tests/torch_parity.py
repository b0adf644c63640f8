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
