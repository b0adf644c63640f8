"""The flash-decoding partition of the port's ``flash_decode`` kernel and
the flash_fwd wrapper's tensor-map stride rule, on the CPU.

``_decode_split_reference`` is the plain version of how ``flash_decode.cu``
splits a row's live 64-key blocks over S CTAs and merges their partials.
The same seeded numpy inputs go through the JAX ``flash_decode`` (its
Pallas kernel in interpret mode) and through the split reference at
S in {1, 2, 3, 8}: shares past a row's live bound stay empty, rows at
position 0 have one live block and S - 1 empty shares.  Tolerances: atol
1e-5 in float32 (the same block arithmetic, merged in another order),
2e-2 in bf16 (p rounds to bf16 against the running max of each warp's
16-key slice of a split instead of the whole row's).

The split count and the stride rule are pure functions of shapes and
strides, checked on fixed cases with the H100's 132 SMs.
"""

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

F32_ATOL = 1e-5
BF16_ATOL = 2e-2
SMS = 132
NEG = float("-inf")

# Two layers of a stacked cache of 200 slots (three full 64-key blocks
# and a ragged one of 8), GQA 4 q heads over 2 kv heads, head_dim 16.
N_LAYERS, B, H, KV, M, D = 2, 3, 4, 2, 200, 16
_JAX_OUT = {}


def _inputs(int8: bool, t: int, dtype: str):
    """Seeded inputs as (JAX args, port args) and the JAX kernel's output
    (computed once per case: it does not depend on S)."""
    rng = np.random.RandomState(100 + 10 * int(int8) + t)
    q = rng.randn(B, t, H, D).astype(np.float32)
    kc = rng.randn(N_LAYERS, B, KV, M, D).astype(np.float32)
    vc = rng.randn(N_LAYERS, B, KV, M, D).astype(np.float32)
    pos = np.array([0, 77, M - t], np.int32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    if int8:
        kq, vq = (jq.quantize_tensor(jnp.asarray(x)) for x in (kc, vc))
        lane = [(np.asarray(x.values), np.asarray(
            jnp.swapaxes(x.scales, -1, -2))) for x in (kq, vq)]
        jk, jv = (jq.QTensor(*map(jnp.asarray, x)) for x in lane)
        tk, tv = (tq.QTensor(*map(_t, x)) for x in lane)
    else:
        jk, jv = jnp.asarray(kc, jdt), jnp.asarray(vc, jdt)
        tk, tv = _t(kc).to(tdt), _t(vc).to(tdt)
    jq_, tq_ = jnp.asarray(q, jdt), _t(q).to(tdt)
    key = (int8, t, dtype)
    if key not in _JAX_OUT:
        _JAX_OUT[key] = np.asarray(ja.flash_decode(
            jq_, jk, jv, jnp.asarray(pos), layer=1, use_pallas=True,
            interpret=True, block_m=64).astype(jnp.float32))
    return (tq_, tk, tv, _t(pos)), _JAX_OUT[key]


# (S, int8, t, dtype): every split count in float32 over fp and int8
# caches, single tokens and a 3-token GQA chunk (6 query rows: two row
# tiles of the kernel's 4); bf16 at two split counts.
SPLIT_CASES = ([(s, i8, t, "f32") for s in (1, 2, 3, 8)
                for i8 in (False, True) for t in (1, 3)]
               + [(s, i8, 1, "bf16") for s in (1, 3) for i8 in (False, True)])


@pytest.mark.parametrize("splits,int8,t,dtype", SPLIT_CASES)
def test_decode_split_reference_matches_jax(splits, int8, t, dtype):
    (q, kc, vc, pos), want = _inputs(int8, t, dtype)
    got = ta._decode_split_reference(q, kc, vc, pos, None, splits, layer=1)
    assert got.shape == q.shape and got.dtype == q.dtype
    atol = BF16_ATOL if dtype == "bf16" else F32_ATOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def test_decode_split_reference_squeezes_and_defaults_scale():
    """[B, H, D] queries come back [B, H, D]; scale None is 1/sqrt(D), as
    in flash_decode."""
    (q, kc, vc, pos), _ = _inputs(False, 1, "f32")
    full = ta._decode_split_reference(q, kc, vc, pos, None, 2, layer=1)
    sq = ta._decode_split_reference(q[:, 0], kc, vc, pos, D ** -0.5, 2,
                                    layer=1)
    assert sq.shape == (B, H, D)
    assert torch.equal(sq, full[:, 0])


@pytest.mark.parametrize("nb", range(0, 21))
def test_split_shares_tile_the_live_blocks(nb):
    """For every S the shares are contiguous, in order, cover [0, nb)
    exactly once, and are empty only past the live bound."""
    for splits in range(1, 10):
        shares = [tuple(int(x) for x in ta._split_share(
            torch.tensor(nb), splits, s)) for s in range(splits)]
        covered = [j for j0, j1 in shares for j in range(j0, j1)]
        assert covered == list(range(nb))
        assert all(j0 <= j1 for j0, j1 in shares)
        busy = [j1 > j0 for j0, j1 in shares]
        assert busy == sorted(busy, reverse=True)


def test_merge_partials_weighs_empty_partials_zero():
    """An empty partial (-inf, 0, 0) adds nothing, whatever its slot;
    the rest merge as one softmax over their union; all-empty stays
    empty (l = 0)."""
    m = torch.tensor([[0.5, NEG, 2.0], [NEG, NEG, NEG]])
    l = torch.tensor([[1.5, 0.0, 2.5], [0.0, 0.0, 0.0]])
    o = torch.tensor([[[1.0, 2.0], [0.0, 0.0], [3.0, -1.0]],
                      [[0.0, 0.0]] * 3])
    mx, lsum, osum = ta._merge_partials(m, l, o, 1)
    w = torch.exp(torch.tensor([0.5, 2.0]) - 2.0)
    assert float(mx[0]) == 2.0 and float(lsum[1]) == 0.0
    torch.testing.assert_close(lsum[0], (torch.tensor([1.5, 2.5]) * w).sum())
    torch.testing.assert_close(
        osum[0], (torch.tensor([[1.0, 2.0], [3.0, -1.0]]) * w[:, None]).sum(0))
    assert torch.equal(osum[1], torch.zeros(2))


@pytest.mark.parametrize("shape,want", [
    ((4, 8, 1, 16384), 9),      # long-context generate: 32 x 9 = 288 CTAs
    ((8, 8, 1, 384), 5),        # int8 generate: 64 x 5 = 320 CTAs
    ((3, 2, 16, 512), 3),       # a 16-token GQA chunk: 16 row tiles
    ((1, 1, 1, 16384), 64),     # one (row, head): the cap
    ((64, 8, 1, 4096), 1),      # enough CTAs already: no split, no merge
    ((1, 8, 1, 100), 2),        # capped by the cache's 2 blocks
])
def test_decode_splits_from_static_shapes(shape, want):
    b, kv, tiles, m = shape
    assert ta._decode_splits(b, kv, tiles, m, SMS) == want


def test_flash_fwd_block_rows_and_route():
    """BQ = 128 only where ceil(T / 128) x H x B CTAs fill 132 SMs; bf16
    head_dim 64/128 take wgmma, other bf16 head dims mma.sync, float32
    the FMA kernel."""
    rows = ta._flash_fwd_block_rows
    assert rows(8, 2048, 8, SMS) == 128
    assert rows(4, 1024, 8, SMS) == 128
    assert rows(4, 1000, 8, SMS) == 128
    assert rows(1, 512, 8, SMS) == 64
    assert rows(1, 1000, 8, SMS) == 64
    assert rows(1, 64, 8, SMS) == 64
    route = ta._flash_fwd_route
    assert route(torch.bfloat16, 64, 8, 2048, 8, SMS) == ("wgmma", 128)
    assert route(torch.bfloat16, 128, 1, 512, 8, SMS) == ("wgmma", 64)
    assert route(torch.bfloat16, 32, 8, 2048, 8, SMS) == ("mma.sync", 64)
    assert route(torch.float32, 64, 8, 2048, 8, SMS) == ("fma", 64)


def _bf16(n):
    return torch.zeros(n, dtype=torch.bfloat16)


def test_tensor_map_stride_rule():
    """The flash_fwd wrapper reads an operand in place only where a
    tensor map can: unit stride on head_dim, a 16-byte aligned base,
    strides of a multiple of 16 bytes that nest without overlap."""
    def ok(t):
        return ta._tensor_map_strides(t) is not None

    x = _bf16(2 * 16 * 4 * 64).view(2, 16, 4, 64)
    assert ta._tensor_map_strides(x) == x.stride()[:3]
    padded = _bf16(2 * 16 * 4 * 72).view(2, 16, 4, 72)[..., :64]  # 144 B
    assert ta._tensor_map_strides(padded) == (16 * 4 * 72, 4 * 72, 72)
    assert not ok(_bf16(2 * 16 * 4 * 68).view(2, 16, 4, 68)[..., :64])
    assert not ok(_bf16(2 * 16 * 64 * 4).view(2, 16, 64, 4).transpose(2, 3))
    assert not ok(_bf16(2 * 16 * 4 * 64 + 1)[1:].view(2, 16, 4, 64))
    # [B, H, T, D] seen as [B, T, H, D]: T's stride nests inside H's.
    assert not ok(_bf16(2 * 4 * 16 * 64).view(2, 4, 16, 64).transpose(1, 2))
    # A fused projection's slice: q heads of a [B, T, H + 2 KV, D] buffer.
    fused = _bf16(2 * 16 * 8 * 64).view(2, 16, 8, 64)
    assert ok(fused[:, :, :4]) and ok(fused[:, :, 4:6])
    assert ok(torch.zeros(2, 16, 4, 8))                    # float32, 32 B


@pytest.mark.parametrize("shape,dtype,want", [
    ((2, 16, 4, 64), torch.bfloat16, (4096, 256, 64)),
    ((1, 7, 3, 16), torch.bfloat16, (336, 48, 16)),
    ((2, 5, 2, 8), torch.float32, (80, 16, 8)),
    ((2, 5, 2, 2), torch.float32, None),          # 8-byte rows
    ((2, 5, 2, 4), torch.bfloat16, None),
])
def test_tensor_map_strides_of_contiguous_operands(shape, dtype, want):
    """A contiguous operand takes its dense strides when a head_dim row
    is a multiple of 16 bytes, and is refused otherwise — the same
    answer as the general stride walk on an equal, non-contiguous view."""
    x = torch.zeros(shape, dtype=dtype)
    assert ta._tensor_map_strides(x) == want
    wide = torch.zeros(shape[:3] + (2 * shape[3],), dtype=dtype)
    view = wide[..., :shape[3]]
    if want is not None:
        assert not view.is_contiguous()
        assert ta._tensor_map_strides(view) == tuple(
            2 * s for s in want[:2]) + (2 * shape[3],)


def test_tensor_map_strides_ignore_size_one_dims():
    """A size-1 dim's recorded stride is meaningless to PyTorch (its
    contiguity check skips it); the kernel gets the dense one."""
    x = _bf16(16 * 64).as_strided((1, 16, 1, 64), (7, 64, 3, 1))
    assert x.is_contiguous()
    assert ta._tensor_map_strides(x) == (1024, 64, 64)
