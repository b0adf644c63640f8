"""The backward kernels' route rule, and the bf16 rounding points of the
plain backward that ``flash_bwd.cu`` is held to on the card.

``_flash_bwd_route`` is pure arithmetic on shapes, checked here as the
C entry must launch it (chip_smoke reads the launch back on the card).
The parity case feeds the same bf16 inputs (from seeded numpy) through
JAX's ``_mha_bwd_pallas`` in interpret mode and the port's plain
backward: both form p and ds in float32 from the same float32 products
and round p, ds and the gradients to bf16 at the same points, so they
differ only where float32 summation order moves a value across a bf16
rounding boundary.  Tolerances, from the bf16 ulp of the tensor's
largest element (``_bf16_ulp``): bf16 gradients within one ulp (one
flipped rounding of the output); float32 gradients (``out_dtype``)
within 1/16 of it — there only a p or ds element that rounds the other
way shows, one ulp of that element, while leaving out a rounding step
moves every element by up to half an ulp of its own and fails.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu.ops import attention as ja
from tfmesos_tpu_torch.ops import attention as ta

SMS = 132                      # an H100 SXM's streaming multiprocessors

# (dtype, head_dim) -> route; rows per CTA at the training shape
# [8, 2048] with 8 heads, and at [1, 512] with 8 heads.
ROUTES = [(torch.bfloat16, 64, "wgmma", 128, 64),
          (torch.bfloat16, 128, "wgmma", 128, 64),
          (torch.bfloat16, 16, "mma.sync", 64, 64),
          (torch.bfloat16, 32, "mma.sync", 64, 64),
          (torch.float32, 8, "fma", 64, 64),
          (torch.float32, 16, "fma", 64, 64),
          (torch.float32, 64, "fma", 64, 64),
          (torch.float32, 128, "fma", 64, 64)]


@pytest.mark.parametrize("dtype,d,route,rows_train,rows_short", ROUTES)
def test_bwd_route(dtype, d, route, rows_train, rows_short):
    assert ta._flash_bwd_route(dtype, d, 8, 2048, 8, SMS) == (route,
                                                              rows_train)
    assert ta._flash_bwd_route(dtype, d, 1, 512, 8, SMS) == (route,
                                                             rows_short)


def test_bwd_route_counts_the_kernels_own_grid():
    """dk/dv's grid runs over kv heads: GQA at the training shape still
    fills the card with 128 keys a CTA (16 x 2 x 8 = 256 CTAs), but at
    one kv head it takes 64 (16 x 1 x 8 = 128 < 132); the rule is the
    forward's."""
    bf16 = torch.bfloat16
    assert ta._flash_bwd_route(bf16, 64, 8, 2048, 2, SMS) == ("wgmma", 128)
    assert ta._flash_bwd_route(bf16, 64, 8, 2048, 1, SMS) == ("wgmma", 64)
    for args in [(bf16, 64, 4, 1000, 8), (bf16, 128, 1, 333, 2),
                 (torch.float32, 32, 2, 100, 4)]:
        assert ta._flash_bwd_route(*args, SMS) == ta._flash_fwd_route(
            *args, SMS)


def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 bits of significand)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


# (causal, window, kv of 4 q heads, q_offset, T): causal GQA; a window
# and q_offset that end mid-block; full attention.
BF16_CASES = [(True, None, 2, 0, 128), (True, 48, 4, 32, 128),
              (False, None, 4, 0, 64)]


@pytest.mark.parametrize("causal,window,kv,q_offset,t", BF16_CASES)
def test_bwd_reference_bf16_matches_pallas_kernels(causal, window, kv,
                                                   q_offset, t):
    b, h, d = 2, 4, 64
    rng = np.random.RandomState(t + kv + q_offset)
    q, k, v, do = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                   .bfloat16() for s in ((b, t, h, d), (b, t, kv, d),
                                         (b, t, kv, d), (b, t, h, d)))
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                       for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)
    cfg = ja._FlashCfg(causal=causal, scale=scale, block_q=t, block_k=t,
                       interpret=True, q_per_kv=h // kv, window=window,
                       q_offset=q_offset)
    o, lse = ja._flash_forward(cfg, jq, jk, jv)
    want = ja._mha_bwd_pallas(cfg, jq, jk, jv, o, lse, jdo)
    want32 = ja._mha_bwd_pallas(cfg, jq, jk, jv, o, lse, jdo,
                                out_dtype=jnp.float32)
    o_t = torch.from_numpy(np.array(o.astype(jnp.float32))).bfloat16()
    lse_t = torch.from_numpy(np.array(lse))
    for out, ref, share in ((None, want, 1.0), (torch.float32, want32,
                                                1 / 16)):
        got = ta.flash_attention_bwd_reference(
            q, k, v, o_t, lse_t, do, causal=causal, scale=scale,
            window=window, q_offset=q_offset, out_dtype=out)
        for g, w in zip(got, ref):
            assert g.dtype == (out or torch.bfloat16)
            w = np.asarray(w.astype(jnp.float32))
            err = float(np.abs(g.float().numpy() - w).max())
            assert err <= share * _bf16_ulp(float(np.abs(w).max())), err
