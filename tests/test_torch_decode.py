"""The port's linear-cache ``flash_decode`` and its int8 paged decode
against the JAX package on the CPU, float32 throughout.

The same numpy inputs (seeded) go through the JAX function — its Pallas
kernel in interpret mode (``use_pallas=True, interpret=True``) and its
plain reference — and the port's plain version, which its CUDA kernels
are held to on the card.  int8 caches and pools are the JAX package's
own ``quantize_tensor`` output moved lane-major, carried across as
numpy.  Tolerance atol 1e-5: float32 softmax attention summed in
another order (blocked online softmax vs one dense pass), and for int8
the scale folded after the dot in the kernel but into the dequantized
cache in the plain versions.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401
from torch_parity import to_torch as _t

from tfmesos_tpu.ops import attention as ja
from tfmesos_tpu.ops import quant as jq
from tfmesos_tpu_torch.ops import attention as ta
from tfmesos_tpu_torch.ops import quant as tq

ATOL = 1e-5


def _lane_major(x: np.ndarray):
    """int8-quantize a [..., M, D] cache per position with the JAX
    package, scales moved lane-major ([..., 1, M]): numpy (values,
    scales)."""
    qt = jq.quantize_tensor(jnp.asarray(x))
    return (np.asarray(qt.values),
            np.asarray(jnp.swapaxes(qt.scales, -1, -2)))


def _pair_cache(k, v, int8):
    """The same cache as a JAX and a port operand."""
    if not int8:
        return (jnp.asarray(k), jnp.asarray(v)), (_t(k), _t(v))
    kq, vq = _lane_major(k), _lane_major(v)
    return ((jq.QTensor(*map(jnp.asarray, kq)),
             jq.QTensor(*map(jnp.asarray, vq))),
            (tq.QTensor(*map(_t, kq)), tq.QTensor(*map(_t, vq))))


# (int8, ragged pos, t): fp and int8 caches, scalar and per-row
# positions, single tokens and 4-token chunks — all GQA (4 q heads over
# 2 kv heads) on layer 1 of a stacked 2-layer cache.
DECODE_CASES = [(i8, rg, t) for i8 in (False, True) for rg in (False, True)
                for t in (1, 4)]


@pytest.mark.parametrize("int8,ragged,t", DECODE_CASES)
def test_flash_decode_matches_jax(int8, ragged, t):
    rng = np.random.RandomState(int(int8) * 4 + int(ragged) * 2 + t)
    n_layers, b, h, kv, m, d = 2, 3, 4, 2, 256, 32
    q = rng.randn(b, t, h, d).astype(np.float32)
    kc = rng.randn(n_layers, b, kv, m, d).astype(np.float32)
    vc = rng.randn(n_layers, b, kv, m, d).astype(np.float32)
    pos = (np.array([0, 130, m - t], np.int32) if ragged
           else np.int32(100))
    (jk, jv), (tk, tv) = _pair_cache(kc, vc, int8)
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(pos))
    want_kernel = np.asarray(ja.flash_decode(*jargs, layer=1,
                                             use_pallas=True, interpret=True,
                                             block_m=64))
    want_ref = np.asarray(ja.flash_decode(*jargs, layer=1, use_pallas=False))
    got = ta.flash_decode(_t(q), tk, tv, _t(pos) if ragged else int(pos),
                          layer=1).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=0)


def test_flash_decode_mha_4d_cache_and_squeeze():
    """MHA over an unstacked [B, KV, M, D] cache (lifted to L = 1), and
    [B, H, D] queries come back [B, H, D]."""
    rng = np.random.RandomState(9)
    b, h, m, d = 2, 4, 128, 16
    q = rng.randn(b, 1, h, d).astype(np.float32)
    kc, vc = (rng.randn(b, h, m, d).astype(np.float32) for _ in range(2))
    want = np.asarray(ja.flash_decode(jnp.asarray(q[:, 0]), jnp.asarray(kc),
                                      jnp.asarray(vc), 77, use_pallas=True,
                                      interpret=True, block_m=64))
    got = ta.flash_decode(_t(q[:, 0]), _t(kc), _t(vc), 77)
    assert got.shape == (b, h, d)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    full = ta.flash_decode(_t(q), _t(kc), _t(vc), 77)
    assert torch.equal(full[:, 0], got)
    with pytest.raises(ValueError, match="stacked"):
        ta.flash_decode(_t(q), _t(kc), _t(vc), 77, layer=1)


def _int8_paged_inputs(seed, ps, kv, g, t, with_self, b=3, n_layers=2,
                       n_pages=24, np_=4, d=32):
    rng = np.random.RandomState(seed)
    h = kv * g
    kpool = rng.randn(n_layers, n_pages, kv, ps, d).astype(np.float32)
    vpool = rng.randn(n_layers, n_pages, kv, ps, d).astype(np.float32)
    table = np.stack([rng.permutation(n_pages)[:np_]
                      for _ in range(b)]).astype(np.int32)
    cap = np_ * ps - t
    pos = np.array([0 if with_self else 1, cap // 2 + 3, cap],
                   np.int32)[:b]
    q = rng.randn(b, t, h, d).astype(np.float32)
    self_kv = None
    if with_self:
        # As decode_step hands it over: the chunk quantize-dequantized,
        # so it matches what a committed int8 slot would hold.
        self_kv = tuple(np.asarray(jq.QTensor(*jq.quantize_int8_reference(
            jnp.asarray(rng.randn(b, t, kv, d).astype(np.float32))))
            .dequantize()) for _ in range(2))
    return q, kpool, vpool, table, pos, self_kv


# (page, KV, q_per_kv, t, self_kv): the steady-state deferred step, the
# fused chunk, and the committed-pool inclusive bound.
PAGED_INT8_CASES = [(16, 2, 1, 1, True), (32, 4, 2, 4, True),
                    (16, 4, 2, 4, False), (32, 2, 1, 1, False)]


@pytest.mark.parametrize("ps,kv,g,t,with_self", PAGED_INT8_CASES)
def test_flash_decode_paged_int8_matches_jax(ps, kv, g, t, with_self):
    q, kpool, vpool, table, pos, self_kv = _int8_paged_inputs(
        ps * 3 + kv + g + t, ps, kv, g, t, with_self)
    (jk, jv), (tk, tv) = _pair_cache(kpool, vpool, True)
    jself = None if self_kv is None else tuple(map(jnp.asarray, self_kv))
    tself = None if self_kv is None else tuple(map(_t, self_kv))
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(pos))
    scale = 1.0 / math.sqrt(q.shape[-1])
    want_kernel = np.asarray(ja.flash_decode_paged(
        *jargs, use_pallas=True, interpret=True, layer=1, self_kv=jself))
    want_ref = np.asarray(ja._paged_decode_reference(*jargs, scale, layer=1,
                                                     self_kv=jself))
    got = ta.flash_decode_paged(_t(q), tk, tv, _t(table), _t(pos), layer=1,
                                self_kv=tself).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=0)


def test_decode_wrappers_validate_int8_caches():
    """The CUDA paths refuse an int8 cache that is not a QTensor with
    float32 lane-major scales, before any build or launch (checked here
    on CPU-side shapes and dtypes)."""
    q = torch.zeros(2, 1, 4, 16)
    vals = torch.zeros(1, 2, 2, 32, 16, dtype=torch.int8)
    with pytest.raises(TypeError, match="QTensor"):
        ta._flash_decode_cuda(q, vals, vals, None, None, 0, 1.0, 0)
    bad = torch.ones(1, 2, 2, 32, 1)                 # trailing-1, not lane
    with pytest.raises(TypeError, match="lane-major"):
        ta._flash_decode_cuda(q, vals, vals, bad, bad, 0, 1.0, 0)
    with pytest.raises(TypeError, match="both"):
        ta.flash_decode(q, tq.QTensor(vals, bad), vals, 0)
