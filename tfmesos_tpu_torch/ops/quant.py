"""Int8 quantization: per-row absmax scaling (port of
``tfmesos_tpu/ops/quant.py:21-147``), and the int8 KV-cache commit.

``x ≈ values * scales[row]`` with int8 values clipped to ±127 and one
float32 scale per row (absmax / 127, all-zero rows pinned to 1).  The
``quant_int8.cu`` kernel replaces ``_quant_kernel``.  It takes a table
of up to :data:`MAX_SEGMENTS` segments, each a set of rows with its own
source, destination, dtype and row plan, and quantizes all of them in
one launch.  Two wrappers drive it: :func:`quantize_int8_many` (any
list of [rows, cols] tensors; :func:`quantize_int8` is its one-tensor
case) and :func:`commit_int8` (K and V chunks quantized straight into
an int8 linear cache or paged pool, each row landing at its cache
slot).  A CUDA tensor launches the kernel (or raises); a CPU tensor runs
the plain versions :func:`quantize_int8_reference` and
:func:`commit_int8_reference`.

Rounding is to nearest, ties to even (``torch.round``, ``rintf`` in the
kernel), so the round-to-nearest kernel is bit-identical to
:func:`quantize_int8_reference`, which is bit-identical to the JAX
package's ground truth of the same name.
Stochastic rounding adds a uniform dither in [-0.5, 0.5) before the
round, drawn from a Philox4x32-10 counter-based generator keyed by
(``seed``, row, col): the kernel and the plain version compute the same
bits, so they agree exactly; neither reproduces the TPU's hardware PRNG
or JAX's threefry, so stochastic rounding is held to JAX statistically.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from tfmesos_tpu_torch.kernels import build

#: Kernel launch counts of ``quant_int8.cu``: ``quant_int8`` one per
#: launch of :func:`quantize_int8_many` (and so of :func:`quantize_int8`),
#: ``quant_int8_commit`` one per launch of :func:`commit_int8`.  The
#: plain CPU paths never count.
LAUNCHES = {"quant_int8": 0, "quant_int8_commit": 0}

# Philox4x32-10 constants (Salmon et al., "Parallel random numbers: as
# easy as 1, 2, 3", SC'11) — the same in quant_int8.cu.
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF

# The kernel's launch table (quant_int8.cu: Head, Seg), every field a
# 64-bit word: a head of _HEAD_WORDS, then _SEG_WORDS a segment.
#: Segments one launch takes; a longer list takes several launches.
MAX_SEGMENTS = 32
_HEAD_WORDS = 9
_SEG_WORDS = 14
#: Bytes of the largest table, passed whole as the kernel's parameter
#: (the classic 4 KB kernel-parameter limit).
TABLE_BYTES = 8 * (_HEAD_WORDS + _SEG_WORDS * MAX_SEGMENTS)
_WORDS = ctypes.c_uint64 * (_HEAD_WORDS + _SEG_WORDS * MAX_SEGMENTS)
_LAUNCH_ARGS = [ctypes.c_void_p, ctypes.c_void_p]
_QUANTIZE, _LINEAR, _PAGED = 0, 1, 2          # the table's mode

# Row plan constants (quant_int8.cu: THREADS, and each body's registers).
_THREADS = 256                 # threads a CTA
_GROUPS = (8, 16, 32, 64, 128, 256)   # threads a row may take
_HELD_FLOATS = 32              # elements a thread keeps in registers (vector)
_HELD_SCALAR = 8               # loads a thread keeps on the scalar path
_MAX_CTAS = 1 << 16            # a segment's CTAs; past it CTAs loop
_SMS = 132                     # H100 SXM streaming multiprocessors


def _absmax_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-row absmax / 127 over the last dim (keepdim), zero rows pinned
    to scale 1.0 — the one scale rule of every path."""
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    # A tensor divisor: PyTorch's CUDA division by a python scalar
    # multiplies by its reciprocal, one ulp off the true quotient.
    return torch.where(absmax == 0, torch.ones_like(absmax),
                       absmax / torch.full_like(absmax, 127.0))


def quantize_int8_reference(x: torch.Tensor, stochastic: bool = False,
                            seed: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax quantization of any rank (the ground truth and the
    plain version of ``quant_int8.cu``): values = clip(round(x / scale
    [+ dither]), ±127) with a true division, rows = all leading dims;
    (int8 values, float32 scales with the last dim 1).  ``stochastic``
    adds the kernel's Philox dither, keyed by (``seed``, row, col)."""
    xf = x.float()
    scale = _absmax_scale(xf)
    scaled = xf / scale
    if stochastic:
        cols = xf.shape[-1]
        scaled = scaled + _dither(seed, xf.numel() // max(1, cols), cols,
                                  xf.device).reshape(xf.shape)
    values = torch.clamp(torch.round(scaled), -127, 127)
    return values.to(torch.int8), scale


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor
                    ) -> torch.Tensor:
    return values.float() * scales


def int8_round_trip(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` [..., D] as an int8 slot holds it, back in ``dtype``: each
    D-element row quantized by :func:`quantize_int8` (the kernel on the
    card), then values x scale in ``dtype``.  An int8 value times a scale
    rounded to ``dtype`` is exact in float32, so the slot rounds once.
    The deferred self chunk over an int8 pool is this: it matches a
    committed slot up to where the scale multiplies (the decode kernels
    fold a slot's scale after the dot, in float32)."""
    vals, scale = quantize_int8(x.reshape(-1, x.shape[-1]))
    return (vals.to(dtype) * scale.to(dtype)).reshape(x.shape)


class QTensor(NamedTuple):
    """A tensor stored as int8 ``values`` with float32 ``scales`` (``w ≈
    values * scales``).  Weights carry scales over the last dim's rows
    (the original shape with the last dim 1); KV caches carry them
    lane-major, one per position on the trailing dim (see
    ``models/transformer.init_cache``)."""

    values: torch.Tensor
    scales: torch.Tensor

    def dequantize(self, dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
        return self.values.to(dtype) * self.scales.to(dtype)


def quantize_tensor(w: torch.Tensor, stochastic: bool = False,
                    seed: int = 0) -> QTensor:
    """Quantize an N-D weight to a :class:`QTensor` (per-row absmax over
    the last dim, rows = all leading dims flattened)."""
    return quantize_tensors([w], stochastic=stochastic, seed=seed)[0]


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of ``a * b`` for a constant ``a`` and an
    int64 tensor ``b`` of uint32 values, in int64 arithmetic that never
    overflows (``a`` split into 16-bit halves)."""
    t1 = b * (a & 0xFFFF)                       # < 2^48
    t2 = b * (a >> 16)                          # < 2^48
    mid = t1 + ((t2 & 0xFFFF) << 16)            # low 48 bits of a * b
    return ((t2 >> 16) + (mid >> 32)) & _U32, mid & _U32


def _philox_bits(seed: int, rows: int, cols: int,
                 device) -> torch.Tensor:
    """First output word of Philox4x32-10 at counter (col, row, 0, 0)
    under key (seed low, seed high): [rows, cols] int64 of uint32
    values."""
    c0 = torch.arange(cols, dtype=torch.int64, device=device).expand(
        rows, cols)
    c1 = torch.arange(rows, dtype=torch.int64, device=device)[:, None] \
        .expand(rows, cols)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = seed & _U32, (seed >> 32) & _U32
    for i in range(10):
        if i:
            k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def _dither(seed: int, rows: int, cols: int, device) -> torch.Tensor:
    """Uniform dither in [-0.5, 0.5): the top 24 random bits over 2^24,
    minus one half (exact in float32, as the kernel computes it)."""
    bits = _philox_bits(int(seed), rows, cols, device)
    return (bits >> 8).to(torch.float32) / float(1 << 24) - 0.5


class RowPlan(NamedTuple):
    """How the kernel walks one segment's rows: ``vec`` elements a load
    (16 bytes of float32 or bf16, or 1 on the scalar path), ``threads``
    threads a row (a group of 8-32 lanes, or 64-256 threads over
    several warps), ``rows_per_cta`` rows a 256-thread CTA, and ``ctas``
    CTAs for the segment (each loops over row blocks past
    ``_MAX_CTAS``).  A thread keeps its ``held`` loads of a row in
    registers between the absmax and the store; a row longer than
    ``threads * held`` loads streams its tail twice."""

    vec: int
    threads: int
    rows_per_cta: int
    ctas: int
    held: int


@functools.lru_cache(maxsize=512)
def row_plan(rows: int, cols: int, itemsize: int, vector: bool,
             sms: int = _SMS) -> RowPlan:
    """The row plan of a [rows, cols] segment of ``itemsize``-byte
    elements (pure; chosen on the host per segment).  Threads a row: the
    fewest group that holds the row in registers, then doubled while the
    segment has fewer CTAs than the card has SMs and the row has loads
    for the wider group."""
    vec = 16 // itemsize if vector else 1
    loads = -(-cols // vec)
    held = _HELD_FLOATS // vec if vector else _HELD_SCALAR
    threads = next((g for g in _GROUPS if g * held >= loads), _GROUPS[-1])

    def ctas(th: int) -> int:
        return min(-(-rows // (_THREADS // th)), _MAX_CTAS)

    while ctas(threads) < sms and threads < min(_GROUPS[-1], loads):
        threads *= 2
    return RowPlan(vec, threads, _THREADS // threads, ctas(threads), held)


def vector_ok(ptr: int, strides: Sequence[int], cols: int,
              itemsize: int) -> bool:
    """Whether rows at ``ptr`` with element ``strides`` (each a row's
    step along one source dim) and ``cols`` elements can be read in
    16-byte vectors: the base and every row start 16-byte aligned and
    the width a whole number of vectors."""
    vec = 16 // itemsize
    return (ptr % 16 == 0 and cols % vec == 0
            and all(s % vec == 0 for s in strides))


def _kind(dtype: torch.dtype, vector: bool) -> int:
    """The kernel body of a segment: float32 or bf16, vector or scalar
    (quant_int8.cu: Kind)."""
    return 2 * (dtype == torch.bfloat16) + (0 if vector else 1)


def _segment(src: torch.Tensor, strides: Sequence[int], rows: int,
             values_ptr: int, scales_ptr: int, stochastic: bool, seed: int,
             cta_begin: int) -> List[int]:
    """One segment's words (quant_int8.cu: Seg): ``rows`` rows of
    ``src``'s last dim, row r read at the element offset its
    ``strides`` (one to three: the row step, or a chunk's (b, t, kv
    head) steps) give it, its CTAs from ``cta_begin`` on."""
    cols = src.shape[-1]
    itemsize = src.element_size()
    ptr = src.data_ptr()
    vec = vector_ok(ptr, strides, cols, itemsize) and values_ptr % 16 == 0
    plan = row_plan(rows, cols, itemsize, vec)
    sb, st, sh = (list(strides) + [0, 0])[:3]
    return [ptr, sb, st, sh, values_ptr, scales_ptr, rows, cols,
            _kind(src.dtype, vec), plan.threads, cta_begin, plan.ctas,
            int(stochastic), int(seed)]


def _tables(head: List[int], sources: Sequence[tuple]
            ) -> List[Tuple[List[int], List[List[int]]]]:
    """The launches of ``sources`` (each ``(src, strides, rows,
    values_ptr, scales_ptr, stochastic, seed)``): (head words, segment
    words) for every :data:`MAX_SEGMENTS` of them, CTAs numbered from 0
    in each launch."""
    out = []
    for i in range(0, len(sources), MAX_SEGMENTS):
        segs: List[List[int]] = []
        ctas = 0
        for args in sources[i:i + MAX_SEGMENTS]:
            segs.append(_segment(*args, ctas))
            ctas += segs[-1][11]
        out.append(([head[0], len(segs), *head[2:]], segs))
    return out


def _launch(head: List[int], segs: List[List[int]], counter: str,
            device: torch.device, what: str) -> None:
    """Launch the kernel over one table on the current stream, counting
    one launch."""
    words = _WORDS(*head, *(w for seg in segs for w in seg))
    fn = build.kernel("quant_int8", "tfm_quant_int8_launch", _LAUNCH_ARGS)
    LAUNCHES[counter] += 1
    err = fn(ctypes.addressof(words),
             torch.cuda.current_stream(device).cuda_stream)
    build.check("quant_int8", err, what)


def _check_cuda(tensors: Sequence[torch.Tensor], what: str
                ) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: every tensor must be on {dev}, got "
                             f"one on {t.device}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{what}: the CUDA kernel takes float32 or "
                            f"bfloat16 input, got {t.dtype}")
    return dev


def quantize_int8_many(xs: Sequence[torch.Tensor], stochastic: bool = False,
                       seed: int = 0
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Quantize each ``[rows, cols]`` (float32 or bfloat16) tensor of
    ``xs`` to (int8 values [rows, cols], float32 scales [rows, 1]), all
    with the same rounding and ``seed`` (each keyed by its own (row,
    col)).  On the card: one ``quant_int8.cu`` launch for every
    :data:`MAX_SEGMENTS` tensors, each read in place (any row stride;
    16-byte loads where :func:`vector_ok` allows them).  On the CPU:
    :func:`quantize_int8_reference` per tensor."""
    for x in xs:
        if x.dim() != 2:
            raise ValueError(f"expected 2D input, got shape "
                             f"{tuple(x.shape)}")
    if not xs:
        return []
    if all(x.device.type == "cpu" for x in xs):
        return [quantize_int8_reference(x, stochastic=stochastic, seed=seed)
                for x in xs]
    dev = _check_cuda(xs, "quantize_int8")
    if not 0 <= int(seed) < 2 ** 64:
        raise ValueError(f"quantize_int8: seed must be in [0, 2^64), got "
                         f"{seed}")
    out, sources = [], []
    for x in xs:
        rows, cols = x.shape
        if x.stride(1) != 1:
            x = x.contiguous()          # alive in sources until launched
        values = torch.empty((rows, cols), dtype=torch.int8, device=dev)
        scales = torch.empty((rows, 1), dtype=torch.float32, device=dev)
        out.append((values, scales))
        if rows and cols:
            sources.append((x, (x.stride(0),), rows, values.data_ptr(),
                            scales.data_ptr(), stochastic, seed))
    with torch.cuda.device(dev):
        for head, segs in _tables([_QUANTIZE] + [0] * (_HEAD_WORDS - 1),
                                  sources):
            _launch(head, segs, "quant_int8", dev, "quantize_int8")
    return out


def quantize_int8(x: torch.Tensor, stochastic: bool = False, seed: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``[rows, cols]`` (float32 or bfloat16) to (int8 values,
    float32 per-row scales [rows, 1]): :func:`quantize_int8_many` of one
    tensor — the ``quant_int8.cu`` kernel on a CUDA tensor,
    :func:`quantize_int8_reference` on a CPU tensor."""
    return quantize_int8_many([x], stochastic=stochastic, seed=seed)[0]


def quantize_tensors(ws: Sequence[torch.Tensor], stochastic: bool = False,
                     seed: int = 0) -> List[QTensor]:
    """:func:`quantize_tensor` of every weight of ``ws``, all in one
    :func:`quantize_int8_many` call: one kernel launch on the card for
    up to :data:`MAX_SEGMENTS` weights."""
    shapes = [tuple(w.shape) for w in ws]
    pairs = quantize_int8_many([w.reshape(-1, s[-1])
                                for w, s in zip(ws, shapes)],
                               stochastic=stochastic, seed=seed)
    return [QTensor(v.reshape(s), sc.reshape(s[:-1] + (1,)))
            for (v, sc), s in zip(pairs, shapes)]


# -- the int8 KV-cache commit --------------------------------------------------


def _put_positions(lay: torch.Tensor, x: torch.Tensor, pos) -> None:
    """Write ``x`` [B, t, KV, ...] into one layer ``lay`` [B, KV, M, ...]
    at positions pos..pos+t-1 of each row, IN PLACE; ``pos`` an int or a
    [B] tensor (ragged rows).  The start clamps so the chunk fits, as a
    dynamic slice update clamps."""
    b, t = x.shape[:2]
    m = lay.shape[2]
    if isinstance(pos, int):
        start = min(max(pos, 0), m - t)
        lay[:, :, start:start + t] = x.transpose(1, 2)
        return
    start = torch.as_tensor(pos, device=lay.device).long().reshape(
        -1).expand(b).clamp(0, m - t)
    rows = torch.arange(b, device=lay.device)[:, None]
    cols = start[:, None] + torch.arange(t, device=lay.device)[None]
    # Advanced indices around the head slice front the [b, t] dims.
    lay[rows, :, cols] = x


def _paged_slots(page_table: torch.Tensor, pos, b: int, t: int,
                 page: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(page id, offset) of logical positions pos..pos+t-1 of each of
    the ``b`` rows, flattened [B*t] row-major: the block index clamps to
    the table width, so a parked row's position one block past it lands
    on its last entry (the sink) — the JAX rule."""
    dev = page_table.device
    table = page_table.long()
    posv = torch.as_tensor(pos, device=dev).long().reshape(-1).expand(b)
    lpos = posv[:, None] + torch.arange(t, device=dev)[None]      # [B, t]
    blk = torch.clamp(lpos // page, max=table.shape[1] - 1)
    pages = torch.take_along_dim(table, blk, dim=1).reshape(-1)
    return pages, (lpos % page).reshape(-1)


def commit_int8_reference(k_cache: QTensor, v_cache: QTensor,
                          ks: Sequence[torch.Tensor],
                          vs: Sequence[torch.Tensor], pos, layer: int = 0,
                          page_table: Optional[torch.Tensor] = None) -> None:
    """The plain version of :func:`commit_int8`: each chunk quantized by
    :func:`quantize_int8_reference`, then written with indexed writes
    (``_put_positions`` into a linear cache, the page-table chase into a
    pool), IN PLACE."""
    for cache, chunks in ((k_cache, ks), (v_cache, vs)):
        if page_table is None:
            for i, x in enumerate(chunks):
                vals, scale = quantize_int8_reference(x)
                _put_positions(cache.values[layer + i], vals, pos)
                _put_positions(cache.scales[layer + i, :, :, 0],
                               scale[..., 0], pos)
            continue
        x = torch.stack(list(chunks))                 # [n, B, t, KV, Dh]
        n, b, t, kvh, dh = x.shape
        pages, offs = _paged_slots(page_table, pos, b, t,
                                   cache.values.shape[3])
        # [n, B, t, KV, Dh] -> [B*t, n, KV, Dh]: the advanced indices
        # (pages, offs) around the head slice front the update's row dim.
        vals, scale = quantize_int8_reference(
            x.permute(1, 2, 0, 3, 4).reshape(b * t, n, kvh, dh))
        lay = slice(layer, layer + n)
        cache.values[lay][:, pages, :, offs] = vals
        cache.scales[lay][:, :, :, 0][:, pages, :, offs] = scale[..., 0]


def commit_int8(k_cache: QTensor, v_cache: QTensor,
                ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                pos, layer: int = 0,
                page_table: Optional[torch.Tensor] = None) -> None:
    """Quantize K and V chunks into an int8 KV cache IN PLACE: ``ks[i]``
    and ``vs[i]`` ([B, t, KV, Dh], float32 or bf16, any strides) are
    layer ``layer + i``'s chunks, each (row, token, kv head) slot
    quantized per position (values, and its scale lane-major).

    A LINEAR cache ([L, B, KV, M, Dh], scales [L, B, KV, 1, M]; no
    ``page_table``) takes slot b's token tt at
    ``clamp(pos_b, 0, M - t) + tt``, the dynamic-slice clamp.  A PAGED
    pool ([L, P, KV, page, Dh], scales [L, P, KV, 1, page]) takes it at
    page ``page_table[b, min((pos_b + tt) // page, NP - 1)]``, offset
    ``(pos_b + tt) % page``: a parked row lands on its sink page.

    ``pos``: the rows' first positions, [B] (an int on the CPU).  On the
    card, one ``quant_int8.cu`` launch commits K and V of up to 16
    layers, reading ``pos`` (an integer tensor on the card; int64 is
    read in place, strided or not) and the int32 ``page_table`` on the
    device, so nothing is uploaded.  On the CPU:
    :func:`commit_int8_reference`."""
    if len(ks) != len(vs) or not ks:
        raise ValueError(f"commit_int8: {len(ks)} K and {len(vs)} V chunks")
    if k_cache.values.device.type == "cpu":
        commit_int8_reference(k_cache, v_cache, ks, vs, pos, layer,
                              page_table)
        return
    what = "commit_int8"
    dev = _check_cuda(list(ks) + list(vs), what)
    b, t, kvh, dh = ks[0].shape
    vals = k_cache.values
    n_layers, _, kv_c, slots, dh_c = vals.shape
    for cache in (k_cache, v_cache):
        if (cache.values.dtype != torch.int8
                or cache.scales.dtype != torch.float32
                or tuple(cache.values.shape) != tuple(vals.shape)
                or tuple(cache.scales.shape) != tuple(vals.shape[:3])
                + (1, slots)
                or not cache.values.is_contiguous()
                or not cache.scales.is_contiguous()
                or cache.values.device != dev):
            raise ValueError(f"{what}: caches must be contiguous int8 "
                             f"{tuple(vals.shape)} with float32 lane-major "
                             f"scales on {dev}")
    for x in list(ks) + list(vs):
        if tuple(x.shape) != (b, t, kvh, dh):
            raise ValueError(f"{what}: chunk {tuple(x.shape)} != "
                             f"{(b, t, kvh, dh)}")
    if (kvh, dh) != (kv_c, dh_c) or not 0 <= layer <= n_layers - len(ks):
        raise ValueError(f"{what}: chunks [B, t, {kvh}, {dh}] at layers "
                         f"{layer}..{layer + len(ks) - 1} do not fit the "
                         f"cache {tuple(vals.shape)}")
    if (not isinstance(pos, torch.Tensor) or pos.device != dev
            or pos.dim() != 1 or pos.shape[0] != b
            or pos.dtype.is_floating_point):
        raise ValueError(f"{what}: pos must be a [{b}] integer tensor on "
                         f"{dev}, got {pos!r}")
    if pos.dtype != torch.int64:
        pos = pos.long()
    if page_table is None:
        if t > slots:
            raise ValueError(f"{what}: a {t}-token chunk does not fit "
                             f"{slots} slots")
    elif (page_table.device != dev or page_table.dim() != 2
          or page_table.shape[0] != b):
        raise ValueError(f"{what}: page_table must be [{b}, NP] on {dev}, "
                         f"got {tuple(page_table.shape)}")
    else:
        page_table = page_table.to(torch.int32).contiguous()
    head, sources = _commit_tables(k_cache, v_cache, ks, vs, pos, layer,
                                   page_table)
    with torch.cuda.device(dev):
        for head, segs in _tables(head, sources):
            _launch(head, segs, "quant_int8_commit", dev, what)


def _commit_tables(k_cache: QTensor, v_cache: QTensor,
                   ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                   pos: torch.Tensor, layer: int,
                   page_table: Optional[torch.Tensor]
                   ) -> Tuple[List[int], List[tuple]]:
    """The commit's table head and sources (see :func:`_tables`):
    ``pos`` int64 [B], ``page_table`` int32 [B, NP] contiguous or None;
    K then V of each layer, each chunk read in place where its last dim
    is contiguous (else a copy, held in the returned sources)."""
    b, t, kvh, _ = ks[0].shape
    slots = k_cache.values.shape[3]
    head = [_LINEAR, 0, pos.data_ptr(), pos.stride(0), 0, 0, t, kvh, slots]
    if page_table is not None:
        head[0], head[4], head[5] = (_PAGED, page_table.data_ptr(),
                                     page_table.shape[1])
    v_layer = k_cache.values.stride(0)
    s_layer = k_cache.scales.stride(0) * k_cache.scales.element_size()
    sources = []
    for i in range(len(ks)):
        for cache, x in ((k_cache, ks[i]), (v_cache, vs[i])):
            if x.stride(3) != 1:
                x = x.contiguous()
            sources.append((x, x.stride()[:3], b * t * kvh,
                            cache.values.data_ptr() + (layer + i) * v_layer,
                            cache.scales.data_ptr() + (layer + i) * s_layer,
                            False, 0))
    return head, sources
