"""The port's attention ops against the JAX package on the CPU.

Same numpy inputs (seeded) go through the JAX function and the port's
counterpart, float32 throughout.  The JAX side reaches its Pallas
kernels as tests/test_attention.py does (``interpret=True``), so the
port's plain versions — what its CUDA kernels are held to on the card —
are checked against what the TPU kernels compute.  Tolerance 2e-5:
float32 softmax attention summed in a different order (blocked online
softmax vs one dense pass)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401
from torch_parity import to_torch as _t

from tfmesos_tpu.ops import attention as ja
from tfmesos_tpu_torch.ops import attention as ta

ATOL = 2e-5


def _qkv(seed, b, t, h, kv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, h, d).astype(np.float32),
            rng.randn(b, t, kv, d).astype(np.float32),
            rng.randn(b, t, kv, d).astype(np.float32))


# (T, KV, window, q_offset): the causal grid, one sliding-window case, and
# one q_offset case whose offset window leaves late rows with no key at
# all (zero output, lse -inf — the ring-merge contract).
FLASH_CASES = [(64, 4, None, 0), (64, 2, None, 0), (100, 4, None, 0),
               (100, 2, None, 0), (100, 4, 24, 0), (64, 2, 20, 48)]


@pytest.mark.parametrize("t,kv,window,q_offset", FLASH_CASES)
def test_flash_reference_matches_pallas_kernel(t, kv, window, q_offset):
    b, h, d = 2, 4, 32
    q, k, v = _qkv(t + kv, b, t, h, kv, d)
    scale = 1.0 / math.sqrt(d)
    cfg = ja._FlashCfg(causal=True, scale=scale, block_q=t, block_k=t,
                       interpret=True, q_per_kv=h // kv, window=window,
                       q_offset=q_offset)
    o_j, lse_j = ja._flash_forward(cfg, *(jnp.asarray(a) for a in (q, k, v)))
    o_t, lse_t = ta.flash_attention_reference(
        _t(q), _t(k), _t(v), causal=True, scale=scale, window=window,
        q_offset=q_offset)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=ATOL,
                               rtol=0)
    if q_offset:
        assert np.isneginf(lse_t.numpy()).any()     # empty rows exercised
    # The public wrappers run the plain version on CPU tensors.
    o_w, lse_w = ta.flash_forward(_t(q), _t(k), _t(v), causal=True,
                                  window=window, q_offset=q_offset)
    assert torch.equal(o_w, o_t) and torch.equal(lse_w, lse_t)


@pytest.mark.parametrize("causal,window,kv", [(False, None, 4),
                                              (True, None, 2),
                                              (True, 5, 4)])
def test_mha_reference_matches_jax(causal, window, kv):
    q, k, v = _qkv(7, 2, 24, 4, kv, 16)
    want = np.asarray(ja.mha_reference(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, window=window))
    got = ta.mha_reference(_t(q), _t(k), _t(v), causal=causal,
                           window=window).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if causal and window is None:
        o = ta.flash_attention(_t(q), _t(k), _t(v), causal=True).numpy()
        np.testing.assert_allclose(o, want, atol=ATOL, rtol=0)


def _paged_inputs(seed, ps, kv, g, t, with_self, b=3, n_layers=2,
                  n_pages=24, np_=4, d=32):
    rng = np.random.RandomState(seed)
    h = kv * g
    kpool = rng.randn(n_layers, n_pages, kv, ps, d).astype(np.float32)
    vpool = rng.randn(n_layers, n_pages, kv, ps, d).astype(np.float32)
    table = np.stack([rng.permutation(n_pages)[:np_]
                      for _ in range(b)]).astype(np.int32)
    cap = np_ * ps - t                   # positions up to pos+t-1 backed
    pos = np.array([0 if with_self else 1, cap // 2 + 3, cap],
                   np.int32)[:b]
    q = rng.randn(b, t, h, d).astype(np.float32)
    self_kv = None
    if with_self:
        self_kv = (rng.randn(b, t, kv, d).astype(np.float32),
                   rng.randn(b, t, kv, d).astype(np.float32))
    return q, kpool, vpool, table, pos, self_kv


def _paged_pair(q, kpool, vpool, table, pos, self_kv, layer=1):
    jself = None if self_kv is None else tuple(jnp.asarray(c)
                                               for c in self_kv)
    tself = None if self_kv is None else tuple(_t(c) for c in self_kv)
    j_args = tuple(jnp.asarray(a) for a in (q, kpool, vpool, table, pos))
    t_args = tuple(_t(a) for a in (q, kpool, vpool, table, pos))
    return j_args, jself, t_args, tself


# (page, KV, q_per_kv, t, self_kv): every value of each axis, both decode
# modes — the steady-state deferred step (t=1, self), the fused chunk
# (t=4, self) and the committed-pool inclusive bound (no self).
PAGED_CASES = [(16, 2, 1, 1, True), (32, 4, 2, 4, True),
               (16, 4, 2, 4, False), (32, 2, 1, 1, False)]


@pytest.mark.parametrize("ps,kv,g,t,with_self", PAGED_CASES)
def test_flash_decode_paged_matches_pallas_kernel(ps, kv, g, t, with_self):
    q, kpool, vpool, table, pos, self_kv = _paged_inputs(
        ps + kv + g + t, ps, kv, g, t, with_self)
    j_args, jself, t_args, tself = _paged_pair(q, kpool, vpool, table, pos,
                                               self_kv)
    scale = 1.0 / math.sqrt(q.shape[-1])
    want_kernel = np.asarray(ja.flash_decode_paged(
        *j_args, use_pallas=True, interpret=True, layer=1, self_kv=jself))
    want_ref = np.asarray(ja._paged_decode_reference(
        *j_args, scale, layer=1, self_kv=jself))
    got = ta.flash_decode_paged(*t_args, layer=1, self_kv=tself).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("ps", [16, 32])
@pytest.mark.parametrize("kv", [2, 4])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("with_self", [False, True])
def test_paged_decode_reference_matches_jax(ps, kv, g, t, with_self):
    """The full (page, KV, q_per_kv, t, self_kv) grid of the port's plain
    paged decode against the JAX plain version (no interpret calls)."""
    q, kpool, vpool, table, pos, self_kv = _paged_inputs(
        3 * ps + kv + g + t, ps, kv, g, t, with_self)
    j_args, jself, t_args, tself = _paged_pair(q, kpool, vpool, table, pos,
                                               self_kv)
    scale = 1.0 / math.sqrt(q.shape[-1])
    want = np.asarray(ja._paged_decode_reference(*j_args, scale, layer=1,
                                                 self_kv=jself))
    got = ta._paged_decode_reference(*t_args, scale, layer=1,
                                     self_kv=tself).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_flash_decode_paged_single_token_squeezes():
    """[B, H, D] queries come back [B, H, D] (t = 1 implied)."""
    q, kpool, vpool, table, pos, _ = _paged_inputs(5, 16, 2, 2, 1, False)
    full = ta.flash_decode_paged(_t(q), _t(kpool), _t(vpool), _t(table),
                                 _t(pos), layer=0)
    sq = ta.flash_decode_paged(_t(q[:, 0]), _t(kpool), _t(vpool),
                               _t(table), _t(pos), layer=0)
    assert sq.shape == (3, 4, 32)
    assert torch.equal(sq, full[:, 0])


def test_cuda_wrappers_validate_before_launch(monkeypatch):
    """The CUDA paths refuse what their kernels do not take before any
    build or launch (checked here on CPU-side shapes/dtypes; reaching a
    kernel build fails the test)."""
    def no_build(*args, **kwargs):
        raise AssertionError("a kernel build was reached")

    monkeypatch.setattr(ta.build, "kernel", no_build)
    q = torch.zeros(1, 8, 4, 24)
    with pytest.raises(ValueError, match="head_dim"):
        ta._flash_forward_cuda(q, q, q, True, 1.0, None, 0)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ta._check_cuda_operands("x", q.half())
    # An int8 pool must come as a QTensor with lane-major float32 scales.
    pool = torch.zeros(1, 4, 2, 16, 24, dtype=torch.int8)
    with pytest.raises(TypeError, match="int8 QTensor"):
        ta._flash_decode_paged_cuda(q, pool, pool, None, None, None, 0, 1.0,
                                    0, None)
    # The backward kernels (each, and both as flash_backward launches
    # them): a head_dim they do not take, lse or delta not float32 or of
    # the wrong shape, gradients in a dtype other than the operands' or
    # float32.
    b, t, h = 1, 8, 4
    qb = torch.zeros(b, t, h, 64, dtype=torch.bfloat16)
    lse = torch.zeros(b, h, t, 1)

    def bwd(which, q_=qb, lse_=lse, delta_=lse, out=None):
        ta._flash_bwd_cuda(which, q_, q_, q_, q_, lse_, delta_, True, 0.125,
                           None, 0, out)

    for which in ("flash_bwd_dq", "flash_bwd_dkv", "flash_backward"):
        with pytest.raises(ValueError, match="head_dim"):
            bwd(which, torch.zeros(b, t, h, 48, dtype=torch.bfloat16))
        with pytest.raises(TypeError, match="lse must be float32"):
            bwd(which, lse_=lse.bfloat16())
        with pytest.raises(TypeError, match="delta must be float32"):
            bwd(which, delta_=lse.double())
        with pytest.raises(ValueError, match="lse"):
            bwd(which, lse_=torch.zeros(b, h, t - 1, 1))
        with pytest.raises(ValueError, match="delta"):
            bwd(which, delta_=torch.zeros(b, h + 1, t, 1))
        with pytest.raises(TypeError, match="gradients"):
            bwd(which, out=torch.float16)
