"""The port's many-tensor quantize and int8 KV-cache commit against the
JAX package on the CPU, bit for bit.

``commit_int8``'s plain version is held to JAX's ``_cache_write`` over
an int8 linear cache and to ``_paged_cache_write_all`` over an int8
pool, every int8 value and float32 scale equal (every page but the sink,
where parked rows land).  ``quantize_int8_many`` is held to
``quantize_int8_reference`` per tensor, on both sides, and to JAX's
``quantize_params`` leaves.

The kernel cannot run here, so its arithmetic and what surrounds it
are checked instead: the division-free quotient it rounds (modelled
here one exactly rounded float32 operation at a time) against IEEE
division;
the row plan (``row_plan``, ``vector_ok``) for every flagship leaf and
cache slot shape, and the launch tables the CUDA wrappers build.
:func:`_emulate` reads a table as ``quant_int8.cu`` does — each
segment's rows found through its pointers and strides, the positions
and page table read through theirs, the CTA ranges and the vector
path's alignment asserted — and quantizes every row it addresses, on
CPU tensors; the result must equal JAX's.
"""

import ctypes
import re
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401
from torch_parity import to_torch as _t

import jax
from tfmesos_tpu.models import transformer as jt
from tfmesos_tpu.ops import quant as jq
from tfmesos_tpu_torch import convert
from tfmesos_tpu_torch.models import transformer as tt
from tfmesos_tpu_torch.ops import quant as tq

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
CSRC = Path(tq.__file__).resolve().parent.parent / "csrc" / "quant_int8.cu"

# Every flagship weight leaf as quantize_params flattens it (rows = the
# leading dims), float32 masters: embed, wq|wk|wv|wo, w_gate|w_up,
# w_down, head.
FLAGSHIP_LEAVES = [(8192, 512), (4096, 512), (4096, 1408), (11264, 512),
                   (512, 8192)]
# Cache slot rows (B x t x KV rows of head_dim 64) the flagship commits:
# int8 generate t=1 and its prefill t=128 (batch 8), serving t=1 and
# t=4 (rows 8) and a serving prefill of 64 (batch 1).
CACHE_SLOTS = [(64, 64), (8192, 64), (256, 64), (512, 64)]


# -- the kernel's table, read on the CPU ----------------------------------------


def _span(t: torch.Tensor):
    return t.data_ptr(), t.data_ptr() + t.untyped_storage().nbytes()


def _inside(addr: int, nbytes: int, spans) -> bool:
    return any(lo <= addr and addr + nbytes <= hi for lo, hi in spans)


def _read(addr: int, n: int, ctype, spans) -> np.ndarray:
    assert _inside(addr, n * ctypes.sizeof(ctype), spans), hex(addr)
    return np.ctypeslib.as_array((ctype * n).from_address(addr)).copy()


def _write(addr: int, data: bytes, spans) -> None:
    assert _inside(addr, len(data), spans), hex(addr)
    ctypes.memmove(addr, data, len(data))


def _emulate(head, segs, reads, writes) -> None:
    """Run one launch table as quant_int8.cu does, on CPU memory: row r
    of each segment read through its pointer and strides, quantized with
    its rounding and seed (keyed by r), and written where the kernel
    writes it.  ``reads``/``writes`` are the tensors the table may
    touch; every access must fall inside one of them."""
    rd = [_span(t) for t in reads]
    wr = [_span(t) for t in writes]
    mode, nseg, pos, pos_stride, table, np_, t, kv, slots = head
    assert nseg == len(segs) <= tq.MAX_SEGMENTS
    cta = 0
    for seg in segs:
        (src, sb, st, sh, values, scales, rows, cols, kind, threads,
         cta_begin, ctas, stochastic, seed) = seg
        # The CTA ranges tile the grid; the plan is the one row_plan
        # gives for the path taken.
        assert cta_begin == cta and 1 <= ctas <= tq._MAX_CTAS
        cta += ctas
        bf16, vector = kind >= 2, kind % 2 == 0
        itemsize = 2 if bf16 else 4
        plan = tq.row_plan(rows, cols, itemsize, vector)
        assert (threads, ctas) == (plan.threads, plan.ctas)
        vec = plan.vec
        srcs, dsts = [], []
        for r in range(rows):
            if mode == tq._QUANTIZE:
                s_off, cell = r * sb, r
            else:
                h, bt = r % kv, r // kv
                tt_, b = bt % t, bt // t
                s_off = b * sb + tt_ * st + h * sh
                p = int(_read(pos + 8 * b * pos_stride, 1, ctypes.c_int64,
                              rd)[0])
                if mode == tq._LINEAR:
                    sel, slot = b, min(max(p, 0), slots - t) + tt_
                else:
                    lpos = p + tt_
                    blk = min(lpos // slots, np_ - 1)
                    sel = int(_read(table + 4 * (b * np_ + blk), 1,
                                    ctypes.c_int32, rd)[0])
                    slot = lpos % slots
                cell = (sel * kv + h) * slots + slot
            addr = src + s_off * itemsize
            if vector:
                # The vector body's 16-byte loads and vec-byte stores.
                assert addr % 16 == 0 and cols % vec == 0
                assert (values + cell * cols) % vec == 0
            if bf16:
                bits = _read(addr, cols, ctypes.c_uint16, rd)
                row = (bits.astype(np.uint32) << 16).view(np.float32)
            else:
                row = _read(addr, cols, ctypes.c_float, rd)
            srcs.append(row)
            dsts.append(cell)
        x = torch.from_numpy(np.stack(srcs))
        vals, scale = tq.quantize_int8_reference(x, stochastic=bool(
            stochastic), seed=seed)
        for r, cell in enumerate(dsts):
            _write(values + cell * cols, vals[r].numpy().tobytes(), wr)
            _write(scales + 4 * cell, scale[r].numpy().tobytes(), wr)


def _emulated_commit(kc, vc, ks, vs, pos, layer=0, table=None) -> int:
    """commit_int8's CUDA path up to the launch (its tables), each table
    run by :func:`_emulate`; returns the launch count."""
    posv = torch.as_tensor(pos).long().reshape(-1).expand(ks[0].shape[0])
    if table is not None:
        table = table.to(torch.int32).contiguous()
    head, sources = tq._commit_tables(kc, vc, ks, vs, posv, layer, table)
    launches = tq._tables(head, sources)
    reads = [s[0] for s in sources] + [posv] + (
        [table] if table is not None else [])
    writes = [kc.values, kc.scales, vc.values, vc.scales]
    for h, segs in launches:
        _emulate(h, segs, reads, writes)
    return len(launches)


def _emulated_many(xs, stochastic=False, seed=0):
    """quantize_int8_many's CUDA path up to the launch, each table run
    by :func:`_emulate`; returns (pairs, launches)."""
    out, sources = [], []
    for x in xs:
        rows, cols = x.shape
        values = torch.full((rows, cols), 99, dtype=torch.int8)
        scales = torch.full((rows, 1), -1.0)
        out.append((values, scales))
        sources.append((x, (x.stride(0),), rows, values.data_ptr(),
                        scales.data_ptr(), stochastic, seed))
    launches = tq._tables([tq._QUANTIZE] + [0] * (tq._HEAD_WORDS - 1),
                          sources)
    for h, segs in launches:
        _emulate(h, segs, list(xs), [t for pair in out for t in pair])
    return out, len(launches)


# -- inputs ----------------------------------------------------------------


def _int8_cache(rng, shape):
    """An int8 cache [L, X, KV, S, D] (lane-major scales) already holding
    data, so slots a write must not touch are checked too."""
    vals = rng.randint(-127, 128, size=shape).astype(np.int8)
    scales = rng.uniform(0.01, 1.0, size=shape[:3] + (1, shape[3])).astype(
        np.float32)
    return vals, scales


def _tq(vals, scales):
    return tq.QTensor(_t(vals), _t(scales))


def _jq(vals, scales):
    return jq.QTensor(jnp.asarray(vals), jnp.asarray(scales))


def _chunk(rng, shape, dtype):
    x = (rng.randn(*shape) * 2).astype(np.float32)
    x[0, 0, 0] = 0.0                                  # an all-zero slot
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), _t(x).to(tdt)


def _assert_cache_equal(got: tq.QTensor, want, pages=slice(None)):
    np.testing.assert_array_equal(got.values.numpy()[:, pages],
                                  np.asarray(want.values)[:, pages])
    np.testing.assert_array_equal(got.scales.numpy()[:, pages],
                                  np.asarray(want.scales)[:, pages])


def _clone(q: tq.QTensor) -> tq.QTensor:
    return tq.QTensor(q.values.clone(), q.scales.clone())


# -- the commit ----------------------------------------------------------------

# (tokens t, positions per row): ragged single tokens; ragged 4-token
# chunks with one start clamped to M - t; the prefill t = M at 0 (a
# python int, as decode_step's prefill passes it).
LINEAR_CASES = {"t1 ragged": (1, [0, 7, 11]),
                "t4 ragged, clamped": (4, [2, 8, 30]),
                "prefill t=M": (12, 0)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(LINEAR_CASES))
def test_commit_linear_matches_jax_cache_write(case, dtype):
    t, pos = LINEAR_CASES[case]
    rng = np.random.RandomState(len(case) * 7 + t)
    L, B, KV, M, D, li = 3, 3, 2, 12, 16, 1
    kc, vc = (_int8_cache(rng, (L, B, KV, M, D)) for _ in range(2))
    (jk, k), (jv, v) = (_chunk(rng, (B, t, KV, D), dtype) for _ in range(2))
    jpos = pos if isinstance(pos, int) else jnp.asarray(pos, jnp.int32)
    want_k = jt._cache_write(_jq(*kc), jk, li, jpos)
    want_v = jt._cache_write(_jq(*vc), jv, li, jpos)
    tpos = pos if isinstance(pos, int) else torch.tensor(pos)
    got_k, got_v = _tq(*kc), _tq(*vc)
    tq.commit_int8(got_k, got_v, [k], [v], tpos, layer=li)
    _assert_cache_equal(got_k, want_k)
    _assert_cache_equal(got_v, want_v)
    # The CUDA path's table, read as the kernel reads it: one launch
    # for K and V.
    em_k, em_v = _tq(*kc), _tq(*vc)
    assert _emulated_commit(em_k, em_v, [k], [v], pos, layer=li) == 1
    _assert_cache_equal(em_k, want_k)
    _assert_cache_equal(em_v, want_v)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("page", [8, 16])
def test_commit_paged_matches_jax_paged_cache_write_all(page, t, dtype):
    """Four rows over a pool with a sink page 0: three live rows at
    ragged positions (one chunk crossing a page boundary) on scrambled
    pages, and a parked row whose table row is all sink, one block past
    the table width.  Every page but the sink must be bit-equal."""
    rng = np.random.RandomState(page * 10 + t)
    L, B, KV, D, NP = 2, 4, 2, 16, 3
    P = B * NP + 1
    table = np.zeros((B, NP), np.int32)
    table[:3] = (rng.permutation(P - 1) + 1)[:3 * NP].reshape(3, NP)
    pos = np.array([0, page - 2, NP * page - t, NP * page], np.int32)
    kp, vp = (_int8_cache(rng, (L, P, KV, page, D)) for _ in range(2))
    chunks = [[_chunk(rng, (B, t, KV, D), dtype) for _ in range(L)]
              for _ in range(2)]
    jks, jvs = (jnp.stack([c[0] for c in cs]) for cs in chunks)
    ks, vs = ([c[1] for c in cs] for cs in chunks)
    want_k = jt._paged_cache_write_all(_jq(*kp), jks, jnp.asarray(table),
                                       jnp.asarray(pos))
    want_v = jt._paged_cache_write_all(_jq(*vp), jvs, jnp.asarray(table),
                                       jnp.asarray(pos))
    live = slice(1, None)                          # every page but the sink
    got_k, got_v = _tq(*kp), _tq(*vp)
    tq.commit_int8(got_k, got_v, ks, vs, torch.from_numpy(pos),
                   page_table=torch.from_numpy(table))
    _assert_cache_equal(got_k, want_k, live)
    _assert_cache_equal(got_v, want_v, live)
    em_k, em_v = _tq(*kp), _tq(*vp)
    assert _emulated_commit(em_k, em_v, ks, vs, torch.from_numpy(pos),
                            table=torch.from_numpy(table)) == 1
    _assert_cache_equal(em_k, want_k, live)
    _assert_cache_equal(em_v, want_v, live)


def test_commit_reads_strided_chunks_in_place():
    """Chunks as views with other strides (K and V sliced out of one
    fused [B, t, 2, KV, D] buffer, and one chunk's last dim strided):
    the table reads the views where it can and the commit equals the
    one of contiguous copies."""
    rng = np.random.RandomState(5)
    L, B, KV, M, D, t = 2, 2, 2, 10, 16, 3
    fused = _t((rng.randn(B, t, 2, KV, D) * 3).astype(np.float32))
    k, v = fused[:, :, 0], fused[:, :, 1]
    assert not k.is_contiguous()
    pos = torch.tensor([1, 9])
    kc, vc = (_int8_cache(rng, (L, B, KV, M, D)) for _ in range(2))
    want_k, want_v = _tq(*kc), _tq(*vc)
    tq.commit_int8_reference(want_k, want_v, [k.contiguous()],
                             [v.contiguous()], pos, layer=1)
    head, sources = tq._commit_tables(want_k, want_v, [k], [v], pos, 1, None)
    assert sources[0][0].data_ptr() == k.data_ptr()         # no copy
    assert sources[0][1] == k.stride()[:3]
    for kk, vv in ((k, v), (k, v.transpose(2, 3).contiguous().transpose(
            2, 3))):
        em_k, em_v = _tq(*kc), _tq(*vc)
        _emulated_commit(em_k, em_v, [kk], [vv], pos, layer=1)
        _assert_cache_equal(em_k, want_k)
        _assert_cache_equal(em_v, want_v)


def test_model_paged_commit_of_every_layer_is_one_table():
    """decode_step's paged commit of the flagship depth: K and V of 8
    layers are 16 segments, one launch; a deeper model takes one launch
    for every 16 layers."""
    rng = np.random.RandomState(2)
    for n_layers, launches in ((8, 1), (16, 1), (17, 2)):
        kp, vp = (_tq(*_int8_cache(rng, (n_layers, 5, 2, 8, 16)))
                  for _ in range(2))
        ks = [_t(rng.randn(2, 1, 2, 16).astype(np.float32))
              for _ in range(n_layers)]
        table = torch.tensor([[1, 2], [3, 4]])
        want_k, want_v = _clone(kp), _clone(vp)
        tq.commit_int8_reference(want_k, want_v, ks, ks, torch.tensor([3, 9]),
                                 page_table=table)
        assert _emulated_commit(kp, vp, ks, ks, torch.tensor([3, 9]),
                                table=table) == launches
        assert torch.equal(kp.values, want_k.values)
        assert torch.equal(vp.scales, want_v.scales)


# -- quantize_int8_many --------------------------------------------------------


def _mixed_inputs():
    """(JAX array, port tensor) pairs: float32 and bf16, the ragged
    (33, 100), all-zero rows, and a view with a longer row stride."""
    rng = np.random.RandomState(11)
    out = []
    for shape, dtype, zero_rows in (((33, 100), "f32", []),
                                    ((33, 100), "bf16", [0, 32]),
                                    ((64, 256), "f32", [3, 4]),
                                    ((8, 512), "bf16", [7]),
                                    ((5, 8), "f32", [0, 1, 2, 3, 4])):
        x = (rng.randn(*shape) * 4).astype(np.float32)
        x[zero_rows] = 0.0
        jdt, tdt = DTYPES[dtype]
        out.append((jnp.asarray(x).astype(jdt), _t(x).to(tdt)))
    wide = (rng.randn(16, 100) * 2).astype(np.float32)
    out.append((jnp.asarray(wide[:, :64]), _t(wide)[:, :64]))
    return out


@pytest.mark.parametrize("path", ["plain", "table"])
def test_quantize_int8_many_matches_per_tensor_reference_and_jax(path):
    pairs = _mixed_inputs()
    xs = [p[1] for p in pairs]
    if path == "plain":
        got = tq.quantize_int8_many(xs)
    else:
        got, launches = _emulated_many(xs)
        assert launches == 1
    assert len(got) == len(xs)
    for (jx, x), (v, s) in zip(pairs, got):
        rv, rs = tq.quantize_int8_reference(x)
        assert torch.equal(v, rv) and torch.equal(s, rs)
        jv, js = jq.quantize_int8_reference(jx)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(got[-2][1].max()) == 1.0          # all-zero rows: scale 1


@pytest.mark.parametrize("path", ["plain", "table"])
def test_quantize_int8_many_stochastic_keys_each_tensor_by_its_rows(path):
    """Stochastic rounding of many tensors: each tensor's dither keyed by
    its own (seed, row, col), so each equals the one-tensor plain
    version."""
    xs = [p[1] for p in _mixed_inputs()]
    got = (tq.quantize_int8_many(xs, stochastic=True, seed=2 ** 40 + 9)
           if path == "plain" else
           _emulated_many(xs, stochastic=True, seed=2 ** 40 + 9)[0])
    for x, (v, s) in zip(xs, got):
        rv, rs = tq.quantize_int8_reference(x, stochastic=True,
                                            seed=2 ** 40 + 9)
        assert torch.equal(v, rv) and torch.equal(s, rs)


def test_quantize_params_leaves_in_one_table_match_jax():
    """quantize_params' leaves go to one launch table (nine tensors,
    under MAX_SEGMENTS), and the table's result is bit-equal to the JAX
    quantize_params leaves."""
    base = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=64, max_seq_len=128)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **base)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **base)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(4))
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    want = convert.flatten(convert.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jt.quantize_params(jcfg, jp))))
    got = convert.flatten(tt.quantize_params(tcfg, tp))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    leaves = [tp["embed"], *(tp["layers"][k] for k in sorted(tt._QUANT_KEYS)),
              tp["head"]]
    pairs, launches = _emulated_many([w.reshape(-1, w.shape[-1])
                                      for w in leaves])
    assert launches == 1 and len(pairs) == 9
    names = ["embed", *(f"layers/{k}" for k in sorted(tt._QUANT_KEYS)),
             "head"]
    for name, w, (v, s) in zip(names, leaves, pairs):
        assert torch.equal(v.reshape(w.shape), want[f"{name}/values"]), name
        assert torch.equal(s.reshape(want[f"{name}/scales"].shape),
                           want[f"{name}/scales"]), name


# -- the row plan ----------------------------------------------------------------


def _covered(plan: tq.RowPlan, cols: int) -> list:
    """The load indices the kernel's groups take for one row, in the
    order its threads take them: the register window, then the tail."""
    loads = -(-cols // plan.vec)
    got = [i * plan.threads + lane for i in range(plan.held)
           for lane in range(plan.threads) if i * plan.threads + lane < loads]
    for lane in range(plan.threads):
        got += list(range(plan.held * plan.threads + lane, loads,
                          plan.threads))
    return got


@pytest.mark.parametrize("shape,dtype",
                         [(s, "f32") for s in FLAGSHIP_LEAVES]
                         + [(s, "bf16") for s in CACHE_SLOTS]
                         + [(s, "f32") for s in CACHE_SLOTS])
def test_row_plan_covers_flagship_leaves_and_cache_slots(shape, dtype):
    rows, cols = shape
    itemsize = torch.tensor([], dtype=DTYPES[dtype][1]).element_size()
    x = torch.zeros(shape, dtype=DTYPES[dtype][1])
    assert tq.vector_ok(x.data_ptr(), x.stride()[:1], cols, itemsize)
    plan = tq.row_plan(rows, cols, itemsize, True)
    assert plan.vec == 16 // itemsize
    assert plan.threads in tq._GROUPS
    assert plan.rows_per_cta * plan.threads == tq._THREADS
    loads = cols // plan.vec
    # The group covers the row once, in registers alone.
    assert plan.threads * plan.held >= loads
    assert sorted(_covered(plan, cols)) == list(range(loads))
    if shape in FLAGSHIP_LEAVES:
        assert plan.ctas >= 132, plan          # every leaf fills the SMs
    assert plan.ctas * plan.rows_per_cta >= rows


@pytest.mark.parametrize("shape,dtype,vector", [
    ((33, 100), "bf16", False),      # 100 bf16 is not whole 16-byte loads
    ((33, 100), "f32", True),        # 100 float32 is 25 loads of 16 bytes
    ((512, 32000), "f32", True),     # longer than 256 threads' registers
    ((3, 7), "f32", False),
    ((1, 8192), "bf16", True)])
def test_row_plan_vector_path_only_where_width_and_stride_allow(
        shape, dtype, vector):
    rows, cols = shape
    x = torch.zeros(shape, dtype=DTYPES[dtype][1])
    itemsize = x.element_size()
    assert tq.vector_ok(x.data_ptr(), x.stride()[:1], cols,
                        itemsize) is vector
    # A base off the 16-byte grid, or a row stride off it, never takes
    # the vector path.
    assert not tq.vector_ok(x.data_ptr() + itemsize, x.stride()[:1], cols,
                            itemsize)
    assert not tq.vector_ok(x.data_ptr(), (cols + 1,), cols, itemsize)
    plan = tq.row_plan(rows, cols, itemsize, vector)
    assert plan.vec == (16 // itemsize if vector else 1)
    assert sorted(_covered(plan, cols)) == list(range(-(-cols // plan.vec)))


def test_row_plan_bounds_the_grid():
    """Short rows by the hundred million: the segment's CTAs stop at
    _MAX_CTAS (each then loops over row blocks), and the grid of a full
    table stays far below the 2^31 - 1 limit."""
    plan = tq.row_plan(10 ** 8, 8, 4, False)
    assert plan.ctas == tq._MAX_CTAS
    assert plan.ctas * tq.MAX_SEGMENTS < 2 ** 31 - 1
    small = tq.row_plan(2, 64, 2, True)
    assert small.ctas == 1 and small.threads == 8


def test_segment_table_fits_the_kernel_parameter_limit():
    """The table is one kernel parameter: its largest form is under the
    classic 4 KB limit, and the kernel source declares the same layout
    (head and segment words, segment count)."""
    assert tq.TABLE_BYTES <= 4096
    assert tq.MAX_SEGMENTS >= 18    # quantize_params' 9; 16 commit segments
    src = CSRC.read_text()
    assert re.search(rf"constexpr int MAX_SEGS = {tq.MAX_SEGMENTS};", src)
    assert (f"sizeof(Head) == {tq._HEAD_WORDS} * 8 && sizeof(Seg) == "
            f"{tq._SEG_WORDS} * 8") in src
    rng = np.random.RandomState(0)
    many = [_t(rng.randn(4, 8).astype(np.float32)) for _ in range(70)]
    got, launches = _emulated_many(many)
    assert launches == 3                                # 32 + 32 + 6
    for x, (v, s) in zip(many, got):
        rv, rs = tq.quantize_int8_reference(x)
        assert torch.equal(v, rv) and torch.equal(s, rs)


# -- the kernel's division-free quotient ----------------------------------------


def _rn32(v: Fraction) -> Fraction:
    """``v`` rounded to the nearest float32, ties to even (subnormals
    included), as an exact rational: one float32 operation's result."""
    if v == 0:
        return Fraction(0)
    sign, a = (-1 if v < 0 else 1), abs(v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    e = max(e, -126)                     # the subnormals' fixed spacing
    m = a / Fraction(2) ** (e - 23)
    k = m.numerator // m.denominator
    rest = m - k
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and k % 2):
        k += 1
    return sign * k * Fraction(2) ** (e - 23)


def _f32(v) -> Fraction:
    return Fraction(float(np.float32(v)))


def _quotient_model(x: Fraction, scale: Fraction) -> Fraction:
    """quant_int8.cu's ``divisor`` and ``quotient``, each float32
    operation rounded once (an FMA rounds its exact sum once)."""
    up = Fraction(2) ** 64 if scale < Fraction(2) ** -100 else Fraction(1)
    s = _rn32(scale * up)
    inv = _rn32(1 / s)                               # __frcp_rn
    a = _rn32(x * up)
    tiny = abs(a) < Fraction(2) ** -100
    if tiny:
        a = _rn32(a * Fraction(2) ** 64)
    q = _rn32(a * inv)
    for _ in range(2):
        q = _rn32(_rn32(a - q * s) * inv + q)
    return _rn32(q * Fraction(2) ** -64) if tiny else q


def _step(q: Fraction, dither: Fraction = Fraction(0)) -> int:
    """int8_round.cuh's round_step of RN(q + dither): rint, clip."""
    s = _rn32(q + dither)
    k = s.numerator // s.denominator
    rest = s - k
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and k % 2):
        k += 1
    return max(-127, min(127, k))


def _quotient_cases(seed: int, n: int):
    """(x, scale) pairs as a row's absmax sets them: absmax across the
    float32 exponents (subnormal rows to 2^120), elements with exponents
    down into the subnormals, exact ties (absmax 127 2^k, elements
    (j + 1/2) 2^k), and each binade's top."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        e = int(rng.randint(-150, 121))
        absmax = _f32(np.ldexp(rng.uniform(1.0, 2.0), e)) or _f32(2.0 ** -149)
        if i % 4 == 0:                       # a tie row, scale exactly 2^k
            k = int(rng.randint(-140, 100))
            absmax = Fraction(127) * Fraction(2) ** k
            x = (int(rng.randint(-127, 127)) + Fraction(1, 2)) * \
                Fraction(2) ** k
        elif i % 4 == 1:                     # just under the absmax
            x = _rn32(absmax * Fraction(1 - 2 ** -24 * int(rng.randint(0, 4))))
        else:
            x = _f32(np.ldexp(rng.uniform(-2.0, 2.0),
                              int(rng.randint(-30, 1)) + e))
        scale = _rn32(absmax / 127)
        if scale:            # a scale that underflows to 0 divides by 0
            out.append((x, scale))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_division_free_quotient_is_ieee_division(seed):
    """The kernel rounds RN(x / scale) computed without a division: the
    quotient equals IEEE division wherever it is a normal float, and the
    int8 step equals the plain version's for every element, with and
    without a dither — including ties, subnormal elements and rows."""
    rng = np.random.RandomState(100 + seed)
    for x, scale in _quotient_cases(seed, 600):
        exact = _rn32(x / scale)
        got = _quotient_model(x, scale)
        if abs(exact) >= Fraction(2) ** -126:
            assert got == exact, (float(x), float(scale))
        assert _step(got) == _step(exact), (float(x), float(scale))
        d = Fraction(int(rng.randint(0, 1 << 24)), 1 << 24) - Fraction(1, 2)
        assert _step(got, d) == _step(exact, d), (float(x), float(scale))
