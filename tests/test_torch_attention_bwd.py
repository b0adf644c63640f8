"""The port's attention gradient against the JAX package on the CPU.

Same numpy inputs (seeded) go through the JAX function and the port's
counterpart, float32 throughout.  The JAX side reaches its Pallas
backward kernels as tests/test_attention.py does (``interpret=True``),
so the plain backward that the port's ``flash_bwd.cu`` kernels are held
to on the card is checked against what the TPU kernels compute.
Tolerance atol 1e-5 / rtol 1e-4: float32 gradients summed in other
orders (one dense pass here, blocked on the TPU side).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401
from torch_parity import to_torch as _t

from tfmesos_tpu.ops import attention as ja
from tfmesos_tpu_torch.ops import attention as ta

ATOL, RTOL = 1e-5, 1e-4


def _inputs(seed, b, t, h, kv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, h, d).astype(np.float32),
            rng.randn(b, t, kv, d).astype(np.float32),
            rng.randn(b, t, kv, d).astype(np.float32),
            rng.randn(b, t, h, d).astype(np.float32))


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL, rtol=RTOL)


# (causal, window, kv of 4 q heads, q_offset): causal/full x window
# {None, 16} x kv {H, H/2, 1} x q_offset {0, 32} (a window needs causal,
# and q_offset only moves a causal mask).  T 64 at head_dim 16, and T 128
# at head_dim 32 for kv 1.  With window 16 and q_offset 32 the last rows
# see no key: lse -inf, the select-not-multiply case.
BWD_CASES = ([(True, w, kv, off) for w in (None, 16) for kv in (4, 2, 1)
              for off in (0, 32)]
             + [(False, None, kv, 0) for kv in (4, 2, 1)])


@pytest.mark.parametrize("causal,window,kv,q_offset", BWD_CASES)
def test_bwd_reference_matches_pallas_kernels(causal, window, kv, q_offset):
    t, d = (128, 32) if kv == 1 else (64, 16)
    b, h = 2, 4
    q, k, v, do = _inputs(t + kv + q_offset + d, b, t, h, kv, d)
    scale = 1.0 / math.sqrt(d)
    cfg = ja._FlashCfg(causal=causal, scale=scale, block_q=t, block_k=t,
                       interpret=True, q_per_kv=h // kv, window=window,
                       q_offset=q_offset)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = ja._flash_forward(cfg, jq, jk, jv)
    want = ja._mha_bwd_pallas(cfg, jq, jk, jv, o, lse, jdo)
    got = ta.flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), _t(np.asarray(o)), _t(np.asarray(lse)), _t(do),
        causal=causal, scale=scale, window=window, q_offset=q_offset)
    assert [tuple(g.shape) for g in got] == [q.shape, k.shape, v.shape]
    _close(got, want)
    if window is not None and q_offset:
        assert np.isneginf(np.asarray(lse)).any()   # empty rows exercised
    # The public wrapper runs the same plain version on CPU tensors.
    wrapped = ta.flash_backward(
        _t(q), _t(k), _t(v), _t(np.asarray(o)), _t(np.asarray(lse)), _t(do),
        causal=causal, window=window, q_offset=q_offset)
    assert all(torch.equal(a, c) for a, c in zip(wrapped, got))


@pytest.mark.parametrize("window,kv", [(None, 4), (None, 2), (24, 4)])
def test_bwd_reference_ragged_matches_jax_autodiff(window, kv):
    """A length (100) the Pallas tiling does not block: the port's plain
    backward against jax.vjp of the JAX plain attention."""
    b, t, h, d = 2, 100, 4, 16
    q, k, v, do = _inputs(5 + kv, b, t, h, kv, d)
    _, vjp = jax.vjp(lambda q_, k_, v_: ja.mha_reference(
        q_, k_, v_, causal=True, window=window),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    o, lse = ta.flash_attention_reference(_t(q), _t(k), _t(v), causal=True,
                                          window=window)
    got = ta.flash_attention_bwd_reference(_t(q), _t(k), _t(v), o, lse,
                                           _t(do), causal=True,
                                           window=window)
    _close(got, want)


@pytest.mark.parametrize("causal,window,kv", [(True, None, 2), (True, 16, 4),
                                              (False, None, 4)])
def test_autograd_matches_jax_vjp(causal, window, kv):
    """torch.autograd.grad through the port's flash_attention against
    jax.vjp of the JAX flash_attention on its Pallas kernels."""
    b, t, h, d = 2, 64, 4, 32
    q, k, v, do = _inputs(11 + kv, b, t, h, kv, d)
    _, vjp = jax.vjp(lambda q_, k_, v_: ja.flash_attention(
        q_, k_, v_, causal=causal, window=window, use_pallas=True,
        interpret=True), *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o = ta.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    _close(got, want)


def test_no_grad_call_skips_the_function():
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    with torch.no_grad():
        o = ta.flash_attention(q, q, q, causal=True)
    assert o.grad_fn is None and not o.requires_grad
    o, lse = ta.flash_forward(q, q, q, causal=True)
    assert o.requires_grad and not lse.requires_grad


def test_bwd_out_dtype_float32_from_bf16():
    """``out_dtype=float32`` (the ring's accumulation dtype) returns the
    float32 gradients that the bf16 default rounds."""
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _inputs(3, 1, 32, 4, 2, 16))
    o, lse = ta.flash_forward(q, k, v, causal=True)
    g32 = ta.flash_backward(q, k, v, o, lse, do, causal=True,
                            out_dtype=torch.float32)
    g16 = ta.flash_backward(q, k, v, o, lse, do, causal=True)
    for a, c in zip(g32, g16):
        assert a.dtype == torch.float32 and c.dtype == torch.bfloat16
        assert torch.equal(a.bfloat16(), c)


def test_cuda_bwd_wrappers_validate_before_launch():
    """The CUDA path refuses what its kernels do not take before any
    build or launch (checked here on CPU-side shapes and dtypes)."""
    b, t, h, d = 1, 8, 4, 16
    q = torch.zeros(b, t, h, d)
    lse = torch.zeros(b, h, t, 1)

    def call(q_=q, k_=q, v_=q, do_=q, lse_=lse, delta_=lse, out=None,
             which="flash_bwd_dq"):
        ta._flash_bwd_cuda(which, q_, k_, v_, do_, lse_, delta_, True, 1.0,
                           None, 0, out)

    odd = torch.zeros(b, t, h, 24)
    with pytest.raises(ValueError, match="head_dim"):
        call(odd, odd, odd, odd)
    with pytest.raises(ValueError, match="head_dim"):
        call(*(torch.zeros(b, t, h, 8, dtype=torch.bfloat16),) * 4)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        call(*(q.half(),) * 4, which="flash_bwd_dkv")
    with pytest.raises(ValueError, match="do not fit"):
        call(do_=torch.zeros(b, t + 1, h, d))
    with pytest.raises(TypeError, match="float32"):
        call(lse_=lse.double())
    with pytest.raises(ValueError, match="lse"):
        call(lse_=torch.zeros(b, h, t + 1, 1))
    with pytest.raises(TypeError, match="gradients"):
        call(out=torch.bfloat16)
