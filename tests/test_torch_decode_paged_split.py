"""The flash-decoding partition of the port's paged decode kernel, and the
int8 rounding of its deferred self chunk, on the CPU.

``_paged_split_reference`` is the plain version of how
``flash_decode_paged.cu`` splits a row's live 64-key blocks over S CTAs,
chases the page table, takes the deferred self chunk in the last split
and merges the partials.  The same seeded numpy inputs go through the JAX
``flash_decode_paged`` (its Pallas kernel in interpret mode) and through
the split reference at S in {1, 2, 3, 8}, over page sizes 16, 32, 64 and
128, GQA and MHA, float32, bf16 and int8 pools, and self chunks of 0, 1,
4 and 8 tokens.  Each case has a scrambled page table, a row at position
0, a row at the table's end and a parked row at position 0 whose table
row is all sink.  int8 pools take the raw chunk with ``round_self`` on
the port's side and JAX's serving ``rq`` chunk on JAX's.  Tolerances:
atol 1e-5 in float32 (the same block arithmetic, merged in another
order), 2e-2 in bf16 (p rounds to bf16 against the running max of each
warp's 16-key slice of a split instead of a whole page's).

The split count is a pure function of shapes, checked on fixed cases with
the H100's 132 SMs.  The self chunk's rounding is checked bit for bit:
``round_self`` against the pre-rounded chunk, and the rounded slot
against JAX's ``rq``.
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

# Two layers of a pool, 4 rows, head_dim 16; a table of 256 positions
# (512 at page 128), so a row holds 4 (8) 64-key blocks.
N_LAYERS, B, D = 2, 4, 16
_JAX_OUT = {}


def _table_width(ps):
    return max(4, 256 // ps)


def _jax_rq(c, dt):
    """JAX's serving quantize-dequantize of a deferred chunk
    (tfmesos_tpu/models/transformer.py, the int8-pool ``rq``)."""
    v, s = jq.quantize_int8_reference(c)
    return v.astype(dt) * s.astype(dt)


def _case(ps, kv, g, pool, self_t):
    """Seeded inputs: the port's (q, k_pool, v_pool, table, pos), its raw
    self chunk (None at self_t 0), whether it takes round_self, and the
    JAX kernel's output (computed once per case: it does not depend on
    S).  ``pool`` is f32, bf16, int8 (float32 q) or int8_bf16 (bf16 q)."""
    np_ = _table_width(ps)
    n_pages = B * np_ + 1
    t = max(1, self_t)
    h = kv * g
    rng = np.random.RandomState(ps + 10 * kv + 100 * g + self_t)
    kp = rng.randn(N_LAYERS, n_pages, kv, ps, D).astype(np.float32)
    vp = rng.randn(N_LAYERS, n_pages, kv, ps, D).astype(np.float32)
    q = rng.randn(B, t, h, D).astype(np.float32)
    chunk = [rng.randn(B, t, kv, D).astype(np.float32) for _ in range(2)]
    # A scrambled table over pages 1.., page 0 the sink; row 3 is parked:
    # its whole table row is the sink.
    table = (rng.permutation(n_pages - 1)[:B * np_] + 1).reshape(B, np_)
    table[3] = 0
    table = table.astype(np.int32)
    cap = np_ * ps
    pos = np.array([0, cap // 2 + 3, cap - t, 0], np.int32)
    bf = pool in ("bf16", "int8_bf16")
    jdt = jnp.bfloat16 if bf else jnp.float32
    tdt = torch.bfloat16 if bf else torch.float32
    int8 = pool.startswith("int8")
    if int8:
        lane = []
        for x in (kp, vp):
            qt = jq.quantize_tensor(jnp.asarray(x))
            lane.append((np.asarray(qt.values),
                         np.asarray(jnp.swapaxes(qt.scales, -1, -2))))
        jk, jv = (jq.QTensor(*map(jnp.asarray, x)) for x in lane)
        tk, tv = (tq.QTensor(*map(_t, x)) for x in lane)
    else:
        jk, jv = jnp.asarray(kp, jdt), jnp.asarray(vp, jdt)
        tk, tv = _t(kp).to(tdt), _t(vp).to(tdt)
    jq_, tq_ = jnp.asarray(q, jdt), _t(q).to(tdt)
    jself = tself = None
    if self_t:
        jc = [jnp.asarray(c, jdt) for c in chunk]
        jself = tuple(_jax_rq(c, jdt) for c in jc) if int8 else tuple(jc)
        tself = tuple(_t(c).to(tdt) for c in chunk)
    key = (ps, kv, g, pool, self_t)
    if key not in _JAX_OUT:
        _JAX_OUT[key] = np.asarray(ja.flash_decode_paged(
            jq_, jk, jv, jnp.asarray(table), jnp.asarray(pos), layer=1,
            self_kv=jself, use_pallas=True,
            interpret=True).astype(jnp.float32))
    args = (tq_, tk, tv, _t(table), _t(pos))
    return args, tself, int8 and bool(self_t), _JAX_OUT[key]


# (page, KV, q_per_kv, pool, self_t): every page size of the JAX grid,
# GQA and MHA, each pool type with and without a self chunk, the
# serving combination (int8 pool, bf16 q, t = 1) and the fused chunks
# (t = 4, 8: 8 query rows at q_per_kv 2 — two row tiles of the kernel's 4).
CASES = [(16, 1, 4, "f32", 0), (16, 2, 2, "f32", 8), (16, 2, 2, "int8", 1),
         (32, 4, 1, "f32", 4), (32, 4, 2, "int8", 4), (32, 2, 2, "int8", 0),
         (64, 2, 2, "bf16", 1), (64, 2, 2, "int8_bf16", 1),
         (64, 4, 1, "f32", 0), (128, 2, 2, "f32", 8), (128, 2, 2, "bf16", 0)]


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("ps,kv,g,pool,self_t", CASES)
def test_paged_split_reference_matches_jax(ps, kv, g, pool, self_t, splits):
    (q, kp, vp, table, pos), self_kv, round_self, want = _case(
        ps, kv, g, pool, self_t)
    got = ta._paged_split_reference(q, kp, vp, table, pos, None, splits,
                                    layer=1, self_kv=self_kv,
                                    round_self=round_self)
    assert got.shape == q.shape and got.dtype == q.dtype
    atol = BF16_ATOL if q.dtype == torch.bfloat16 else F32_ATOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("ps,kv,g,pool,self_t", CASES)
def test_paged_split_reference_matches_plain_version(ps, kv, g, pool,
                                                     self_t):
    """The split partition and the port's gather-the-pages plain version
    (what the wrapper runs on the CPU) agree at the serving shape's S."""
    (q, kp, vp, table, pos), self_kv, round_self, _ = _case(
        ps, kv, g, pool, self_t)
    want = ta.flash_decode_paged(q, kp, vp, table, pos, layer=1,
                                 self_kv=self_kv, round_self=round_self)
    got = ta._paged_split_reference(q, kp, vp, table, pos, None, 5, layer=1,
                                    self_kv=self_kv, round_self=round_self)
    atol = BF16_ATOL if q.dtype == torch.bfloat16 else F32_ATOL
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("shape,want", [
    ((8, 8, 1, 16 * 64), 5),     # serving: rows 8, KV 8, 16 pages of 64
    ((4, 8, 1, 256 * 64), 9),    # long context laid out in 256 pages
    ((8, 8, 2, 16 * 64), 3),     # GQA t = 8 at q_per_kv 1: 2 row tiles
    ((2, 2, 1, 4 * 16), 1),      # a 64-position table: one block
    ((1, 8, 1, 3 * 128), 6),     # capped by the table's 6 blocks
    ((64, 8, 1, 16 * 64), 1),    # enough CTAs already: no split, no merge
])
def test_paged_decode_splits_from_static_shapes(shape, want):
    """The paged kernel's split count: the linear kernel's rule over the
    positions a table row holds (NP x page), never pos."""
    b, kv, tiles, slots = shape
    assert ta._decode_splits(b, kv, tiles, slots, SMS) == want


@pytest.mark.parametrize("pool", ["int8", "int8_bf16", "f32"])
def test_round_self_is_the_prerounded_chunk(pool):
    """On the CPU ``round_self=True`` gives the same bits as handing over
    the chunk already rounded (``int8_round_trip``), through the wrapper
    and through the split reference."""
    (q, kp, vp, table, pos), self_kv, _, _ = _case(32, 4, 2, pool, 4)
    pre = tuple(tq.int8_round_trip(c, q.dtype) for c in self_kv)
    for fn, extra in ((ta.flash_decode_paged, ()),
                      (ta._paged_split_reference, (None, 3))):
        rounded = fn(q, kp, vp, table, pos, *extra, layer=1,
                     self_kv=self_kv, round_self=True)
        given = fn(q, kp, vp, table, pos, *extra, layer=1, self_kv=pre)
        assert torch.equal(rounded, given)
        raw = fn(q, kp, vp, table, pos, *extra, layer=1, self_kv=self_kv)
        assert not torch.equal(rounded, raw)     # the rounding mattered
    with pytest.raises(ValueError, match="round_self"):
        ta.flash_decode_paged(q, kp, vp, table, pos, layer=1,
                              round_self=True)


def _slot_matrix(seed):
    """[6, 3, 16] slots: random, one all-zero, one whose +absmax and
    -absmax both occur, ties at half steps, tiny and huge magnitudes."""
    rng = np.random.RandomState(seed)
    x = rng.randn(6, 3, 16).astype(np.float32)
    x[0, 1] = 0.0
    x[1, 2, :2] = (3.5, -3.5)
    x[2, 0, 0] = 127.0                          # scale 1: x / scale = x
    x[2, 0, 1:] = np.arange(-8, 7) + 0.5        # ties, rounded to even
    x[3] *= 1e-30
    x[4] *= 1e30
    return x


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_round_trip_is_jax_rq(dtype, seed):
    """The slot the port's rule computes equals JAX's ``rq`` bit for bit:
    scale = absmax / 127 (1 for an all-zero slot), values = clip(rint(x /
    scale), ±127), then values x scale, each in the chunk's dtype."""
    x = _slot_matrix(seed)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = np.asarray(_jax_rq(jnp.asarray(x, jdt), jdt).astype(jnp.float32))
    got = tq.int8_round_trip(_t(x).to(tdt), tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not np.any(got.float().numpy()[0, 1])        # the all-zero slot


def test_paged_cuda_wrapper_validates_before_launch(monkeypatch):
    """The CUDA path refuses what the kernel does not take before any
    build or launch: a head_dim outside the kernel's, round_self without
    a chunk, a self chunk of the wrong shape."""
    def no_build(*args, **kwargs):
        raise AssertionError("a kernel build was reached")

    monkeypatch.setattr(ta.build, "kernel", no_build)
    pool = torch.zeros(1, 4, 2, 16, 48)
    q = torch.zeros(2, 1, 4, 48)
    table = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        ta._flash_decode_paged_cuda(q, pool, pool, None, None, table, 0, 1.0,
                                    0, None)
    pool, q = torch.zeros(1, 4, 2, 16, 16), torch.zeros(2, 1, 4, 16)
    with pytest.raises(ValueError, match="round_self"):
        ta._flash_decode_paged_cuda(q, pool, pool, None, None, table, 0, 1.0,
                                    0, None, True)
    bad = (torch.zeros(2, 1, 4, 16),) * 2
    with pytest.raises(ValueError, match="self_kv"):
        ta._flash_decode_paged_cuda(q, pool, pool, None, None, table, 0, 1.0,
                                    0, bad)
