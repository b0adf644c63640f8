"""The port's rms_norm / rope / swiglu against tfmesos_tpu.ops.layers
(CPU, float32): same numpy inputs through both, atol 1e-5 — float32
elementwise math with the same cast points, so only last-ulp
differences between the two libraries' kernels remain."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401
from torch_parity import to_torch as _t

from tfmesos_tpu.ops import layers as jl
from tfmesos_tpu_torch.ops import layers as tl

ATOL = 1e-5


@pytest.mark.parametrize("shape", [(2, 5, 32), (3, 64)])
def test_rms_norm_matches_jax(shape):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32) * 3.0
    w = rng.randn(shape[-1]).astype(np.float32)
    want = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    got = tl.rms_norm(_t(x), _t(w)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("theta", [10000.0, 500.0])
def test_rope_ragged_positions_matches_jax(theta):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 4, 16).astype(np.float32)
    # Ragged rows: one near the start, one deep into the context.
    pos = np.stack([np.arange(3, 9), np.arange(700, 706)]).astype(np.int32)
    want = np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = tl.rope(_t(x), _t(pos).long(), theta).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_swiglu_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 32).astype(np.float32)
    wg, wu = (rng.randn(32, 48).astype(np.float32) / 6 for _ in range(2))
    wd = rng.randn(48, 32).astype(np.float32) / 7
    want = np.asarray(jl.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd))))
    got = tl.swiglu(*(_t(a) for a in (x, wg, wu, wd))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
