#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and generation paths once
on an NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card.  It
imports ``tfmesos_tpu_torch`` from beside this file (never JAX), and:

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. builds every kernel of ``tfmesos_tpu_torch/csrc`` from a clean build
   directory and prints the build seconds;
3. holds each forward kernel against its plain PyTorch version on the
   card at the serving path's shapes (bf16; flash fwd: o atol 2e-2, lse
   atol 1e-3; paged decode: atol 2e-2 — bf16 operands, fp32
   accumulation in a different order), and times kernel, plain version
   and one PyTorch library call as a yardstick (CUDA-event medians),
   beside the bound, with the flash_fwd route (wgmma / mma.sync / fma)
   and query rows per CTA as the C entry reports its launch (for
   flash_fwd and the timed flash_decode cases also the host microseconds
   a call takes to enqueue); the forward also at q_offset 64 with a
   window over 364 keys, [4, 1000] and GQA at the training shape; then,
   for correctness only, GQA in bf16, the float32 kernels at the tiny
   preset's head_dim 8 (atol 1e-4), head_dim 128 and full attention on
   wgmma, and bf16 head_dim 16 and 32 on mma.sync; then the linear-cache
   decode kernel with the split count S its launch reports (bf16
   [4, KV 8, M 16384, 64] at pos 1024, int8 [8, M 384] at pos 300, and
   the long-context one cold: 8 layers in turn, so their live K/V exceed
   L2, beside SDPA cycled the same way; checks of a ragged 16-token GQA
   int8 chunk, float32 at head_dim 8, ragged long context pos [0, 1024,
   9000, 16383] in bf16, int8 and float32, and M = 301: 2e-2 bf16, 1e-4
   float32, both absolute and per output row over the row's own
   magnitude; and per row against ``_decode_split_reference`` at the
   launch's S, 1e-2 bf16, 1e-5 float32),
   the paged kernel's int8 fold at the serving shape (t=1 and t=4 with
   self_kv, atol 2e-2), and the int8 quantize kernel at every flagship
   weight leaf's shape and a cache write's (round-to-nearest and seeded
   stochastic rounding BIT-exact to the plain versions, the dither
   unbiased);
4. does the same for the two backward kernels (dq, dk/dv) at the
   training shape [8, 2048, 8, 64] and at [1, 512, 8, 64], causal bf16,
   against the plain backward from the same bf16 inputs (tolerance
   2e-2 x max(1, max|grad|): a bf16 gradient's rounding is relative, and
   2e-2 is about one bf16 ulp on values of order 1), with
   ``torch.autograd.grad`` through SDPA's backward as the yardstick of
   the pair; then, for correctness only, GQA, a window with q_offset, a
   ragged T with float32 gradients, and the float32 kernels at head_dim
   8 (atol 1e-4);
5. serves 16 seeded requests (prompts of 8..700 tokens, 32 new tokens
   each) through ``ContinuousBatcher`` on the flagship config (rows 8,
   page 64, bucket 64), and checks that every prefill and every decode
   tick launched the kernels once per layer;
6. reruns two served requests teacher-forced through ``forward`` on the
   CPU in float32 with the same float32 master weights, and requires
   the card's token wherever the CPU's top-1/top-2 margin is clear;
7. runs the flagship forward at [4, 1024] on the card;
8. trains the flagship through ``transformer_train``'s own setup and
   loop (B 8, T 2048, AdamW 3e-4, weight decay 0.01, weights seeded 0)
   for 2 + 20 steps: every loss finite, the last below the first, and
   exactly 8 launches of each of flash_fwd, flash_bwd_dq and
   flash_bwd_dkv per step; prints ms per step, tokens/s, the host time
   of ``token_batches`` per batch, and a profile of two steps;
9. runs one ``loss_fn`` + backward at full width on the card (bf16) and
   on the CPU (float32) from the same float32 master weights and batch
   at [1, 1024]: |dloss| <= 2e-2 and every leaf's gradient at cosine
   >= 0.99 to the CPU's;
10. generates with the full int8 configuration (flagship weights seeded
    0 through ``quantize_params`` on the card, an int8 KV cache; batch 8,
    prompt 128, 256 new tokens, greedy): exactly 9 + 2 x 8 x 256
    quant_int8, 8 flash_fwd and 8 x 255 flash_decode launches (and as
    many flash_decode_merge where the shapes split the cache), and the
    tokens teacher-forced against a float32 CPU run with the same int8
    weights over an int8 cache (the phase-6 margin rule); prints decode
    tokens/s without the prefill, ms per step and a profile of 16 steps;
11. generates in bf16 at long context (batch 4 over a 16384-slot cache,
    prompt 1024, 64 new tokens): exactly 8 flash_fwd and 8 x 63
    flash_decode launches (and merges), the tokens teacher-forced against
    the card's own ``forward``; tokens/s, ms per step and a profile of
    16 steps;
12. serves phase 5's 16 requests with int8 weights over an int8 page
    pool: 8 flash_decode_paged launches per tick, 8 flash_fwd per
    prefill, 2 quant_int8 per prefill and 18 per tick, and two requests
    teacher-forced as in phase 10.

Every path phase zeroes all launch counts (``attention.LAUNCHES`` and
``quant.LAUNCHES``) just before it runs and reads them just after.

It prints a ``kernels`` JSON line, the card's name and power limit,
then as its last line ``{"ok": true, "device": {...}}``.  Any failure
raises (non-zero exit, no result line); so does a machine without a
card, or a directory without the package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (dense, full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12          # outside the tensor cores

FLASH_O_ATOL = 2e-2
FLASH_LSE_ATOL = 1e-3
PAGED_ATOL = 2e-2
# Linear-cache decode kernel vs its plain version: bf16 operands and
# float32 accumulation in another order (the kernel rounds p to bf16
# before P.V, the plain version after normalizing); float32 differs in
# summation order and where an int8 scale multiplies.
DECODE_ATOL = 2e-2
DECODE_F32_ATOL = 1e-4
# The same kernel against ``_decode_split_reference`` at its split count:
# that plain version partitions as the kernel does (splits, and each
# warp's 16-key slice of a block), so p rounds to bf16 at the same
# points and what remains is summation order and the output's own
# rounding — 1e-2 of a row's magnitude is ~2.5 bf16 ulps of its largest
# element.
SPLIT_BF16_TOL = 1e-2
SPLIT_F32_TOL = 1e-5
# Teacher-forced check: a generated position counts when the float32
# CPU logits' top-1 beats top-2 by more than this.  bf16 compute on the
# card rounds activations at ~2^-8 relative through 8 layers; the card's
# logits land within ~0.1 of the float32 run's (printed below as
# max |dlogit|), so a 0.25 margin cannot be flipped by rounding alone,
# while a wrong kernel (a logit off by O(1)) still fails.
MARGIN = 0.25
MIN_CHECKED = 10
# Backward kernels vs the plain backward from the same bf16 inputs: a
# gradient of magnitude m rounds to bf16 at ~m * 2^-8 per element, so
# the bound scales with m (2e-2 at m <= 1, the forward's).  float32
# gradients (the FMA kernels) differ only in summation order.
BWD_REL_TOL = 2e-2
BWD_F32_ATOL = 1e-4
# Training: 20 measured steps after 2 warm-up steps; card bf16 vs CPU
# float32 gradients at [1, 1024].
TRAIN_STEPS = 20
TRAIN_DLOSS = 2e-2
TRAIN_MIN_COS = 0.99


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int = 5, n: int = 20) -> float:
    """Median over ``reps`` of the mean device time of ``n`` back-to-back
    calls of ``fn``.  A device-side sleep ahead of each timed run lets
    the host enqueue all ``n`` calls before the device reaches them, so
    the events bracket device work, not host overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / n)
    return statistics.median(out)


def host_us(torch, fn, n: int = 200) -> float:
    """Median over 5 runs of the host microseconds one call of ``fn``
    takes to enqueue its work: a device-side sleep ahead of each run
    keeps the device from ever stalling the host.  The decode paths are
    host-bound, so this is their wrappers' cost."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(5):
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(out)


def row_err(out, ref) -> float:
    """Largest error of any output row (the last dim) over that row's own
    magnitude, the magnitude capped at 1 so the measure is never looser
    than the absolute error.  A decode row over 16k positions averages
    them into values ~100x smaller than a row at position 0, whose bf16
    rounding would otherwise set the whole tensor's maximum."""
    d = out.shape[-1]
    o, r = out.float().reshape(-1, d), ref.float().reshape(-1, d)
    mag = r.abs().amax(-1).clamp(min=1e-12, max=1.0)
    return float(((o - r).abs().amax(-1) / mag).max())


def last_launch(lib: str, symbol: str, n: int):
    """The ``n`` ints a kernel library reports about this thread's last
    launch (its ``tfm_*_last_launch`` entry): what the C side ran, read
    back rather than recomputed from the wrapper's plan."""
    import ctypes

    from tfmesos_tpu_torch.kernels import build

    out = (ctypes.c_int * n)()
    build.kernel(lib, symbol, [ctypes.c_void_p], None)(out)
    return list(out)


FWD_ROUTES = ("fma", "mma.sync", "wgmma")


def fwd_launched(torch, ta, q):
    """(route, query rows per CTA) of the last flash_fwd launch as the C
    entry reports it, required to equal the wrapper's static rule."""
    code, rows = last_launch("flash_fwd", "tfm_flash_fwd_last_launch", 5)[:2]
    b, t, h, d = q.shape
    plan = ta._flash_fwd_route(q.dtype, d, b, t, h, ta._sm_count(q.device))
    got = (FWD_ROUTES[code], rows)
    need(got == plan, f"flash_fwd {tuple(q.shape)} launched {got}, the "
         f"wrapper's rule says {plan}")
    return got


def decode_launched(ta, q, kc):
    """Split count S of the last flash_decode launch as the C entry
    reports it (its grid's z), required to equal ``_decode_plan`` and to
    come with a merge exactly when S > 1."""
    grid = last_launch("flash_decode", "tfm_flash_decode_last_launch", 4)
    qq = q if q.dim() == 4 else q[:, None]
    plan = ta._decode_plan(qq, kc)
    need(grid[2] == plan and (grid[3] > 0) == (plan > 1),
         f"flash_decode {tuple(q.shape)} launched grid {grid[:3]} merge "
         f"{grid[3]}, the wrapper's plan says S {plan}")
    return grid[2]


def bound(bytes_: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def zero_launches():
    """Set every kernel's launch count to 0."""
    from tfmesos_tpu_torch.ops import attention as ta
    from tfmesos_tpu_torch.ops import quant as tq

    for counts in (ta.LAUNCHES, tq.LAUNCHES):
        for key in counts:
            counts[key] = 0


def read_launches():
    """Every kernel's launch count since the last :func:`zero_launches`."""
    from tfmesos_tpu_torch.ops import attention as ta
    from tfmesos_tpu_torch.ops import quant as tq

    return {**ta.LAUNCHES, **tq.LAUNCHES}


def phase_device(torch):
    need(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    say("[1/12] device")
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from tfmesos_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build(clean=True)
    secs = time.perf_counter() - t0
    say(f"[2/12] build: {len(build.sources())} kernels from a clean build "
        f"directory in {secs:.2f} s")
    for log in sorted(build.build_dir().glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {log.stem}: {line.strip()}")
    return secs


def phase_kernels(torch):
    import torch.nn.functional as F

    from tfmesos_tpu_torch.ops import attention as ta

    say("[3/12] kernels vs plain versions (bf16, CUDA-event medians)")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    h, d = 8, 64
    scale = 1.0 / math.sqrt(d)
    flash_rows = []

    def flash_case(b, t, window, draw, kv=h, tk=None, q_offset=0):
        tk = t if tk is None else tk
        q, k, v = draw(b, t, h, d), draw(b, tk, kv, d), draw(b, tk, kv, d)
        o_k, lse_k = ta.flash_forward(q, k, v, causal=True, window=window,
                                      q_offset=q_offset)
        route, rows = fwd_launched(torch, ta, q)
        o_p, lse_p = ta.flash_attention_reference(
            q, k, v, causal=True, scale=scale, window=window,
            q_offset=q_offset)
        torch.cuda.synchronize()
        err_o = float((o_k.float() - o_p.float()).abs().max())
        err_l = float((lse_k - lse_p).abs().max())
        need(err_o <= FLASH_O_ATOL and err_l <= FLASH_LSE_ATOL,
             f"flash_fwd [{b},{t},{h},{d}] kv={kv} tk={tk} window={window} "
             f"q_offset={q_offset}: o err {err_o} lse err {err_l}")
        ms = cuda_ms(torch, lambda: ta.flash_forward(
            q, k, v, causal=True, window=window, q_offset=q_offset))
        enqueue = host_us(torch, lambda: ta.flash_forward(
            q, k, v, causal=True, window=window, q_offset=q_offset))
        plain = cuda_ms(torch, lambda: ta.flash_attention_reference(
            q, k, v, causal=True, scale=scale, window=window,
            q_offset=q_offset))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        gqa = {"enable_gqa": True} if kv != h else {}
        allow = ~ta._causal_mask(t, tk, q_offset, window, dev)
        if window is None and q_offset == 0 and tk == t:
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, **gqa))
        else:
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=allow, **gqa))
        pairs = b * int(allow.sum())
        flops = 4 * pairs * h * d
        bytes_ = (2 * b * t * h * d + 2 * b * tk * kv * d) * 2 + b * h * t * 4
        bms, by = bound(bytes_, flops)
        row = {"shape": [b, t, h, d], "kv": kv, "tk": tk, "window": window,
               "q_offset": q_offset, "route": route, "block_rows": rows,
               "max_abs_err": err_o, "lse_err": err_l, "ms": ms,
               "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
               "bound_by": by, "host_us": enqueue}
        flash_rows.append(row)
        say(f"  flash_fwd {row['shape']} kv={kv} tk={tk} window={window} "
            f"q_offset={q_offset} [{route}, BQ {rows}]: kernel_ms {ms:.4f} "
            f"plain_ms {plain:.4f} library_ms {lib:.4f} bound_ms "
            f"{bms:.5f} ({by}) o_err {err_o:.2e} lse_err {err_l:.2e} "
            f"host_us {enqueue:.1f}")

    for b, t, window in [(1, 64, None), (1, 512, None), (1, 1000, None),
                         (4, 1024, None), (1, 512, 128)]:
        flash_case(b, t, window, randn)

    n_layers, rows, kv, ps, np_, layer = 8, 8, 8, 64, 16, 3
    n_pages = rows * np_ + 1
    kpool = randn(n_layers, n_pages, kv, ps, d)
    vpool = randn(n_layers, n_pages, kv, ps, d)
    perm = torch.randperm(n_pages - 1, generator=gen) + 1    # 0 = sink
    table = perm[:rows * np_].reshape(rows, np_).to(dev, torch.int32)
    paged_rows = []
    for t in (1, 4):
        pos = torch.randint(1, 1001, (rows,), generator=gen)
        pos = pos.clamp(max=np_ * ps - t).to(dev, torch.int32)
        q = randn(rows, t, h, d)
        self_kv = (randn(rows, t, kv, d), randn(rows, t, kv, d))
        out_k = ta.flash_decode_paged(q, kpool, vpool, table, pos,
                                      layer=layer, self_kv=self_kv)
        out_p = ta._paged_decode_reference(q, kpool, vpool, table, pos,
                                           scale, layer=layer,
                                           self_kv=self_kv)
        torch.cuda.synchronize()
        err = float((out_k.float() - out_p.float()).abs().max())
        need(err <= PAGED_ATOL, f"flash_decode_paged t={t}: err {err}")
        ms = cuda_ms(torch, lambda: ta.flash_decode_paged(
            q, kpool, vpool, table, pos, layer=layer, self_kv=self_kv))
        plain = cuda_ms(torch, lambda: ta._paged_decode_reference(
            q, kpool, vpool, table, pos, scale, layer=layer,
            self_kv=self_kv))
        # Yardstick: SDPA over the gathered contiguous view (the chunk
        # written at its positions), ragged mask precomputed.
        tl = table.long()
        m = np_ * ps
        kview = kpool[layer][tl].transpose(1, 2).reshape(rows, kv, m, d)
        vview = vpool[layer][tl].transpose(1, 2).reshape(rows, kv, m, d)
        ridx = torch.arange(rows, device=dev)[:, None]
        cols = pos.long()[:, None] + torch.arange(t, device=dev)[None]
        kview[ridx, :, cols] = self_kv[0]
        vview[ridx, :, cols] = self_kv[1]
        allow = (torch.arange(m, device=dev)[None, None, :]
                 <= cols[:, :, None])[:, None]            # [B, 1, t, M]
        qh = q.transpose(1, 2).contiguous()
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kview, vview, attn_mask=allow))
        live = int(pos.sum())                     # committed positions read
        keys = int((pos.long()[:, None] + torch.arange(
            1, t + 1, device=dev)[None]).sum())   # keys seen per query row
        bytes_ = (2 * live * kv * d * 2 + 2 * rows * t * kv * d * 2
                  + 2 * rows * t * h * d * 2 + rows * np_ * 4 + rows * 4)
        flops = 4 * keys * h * d
        bms, by = bound(bytes_, flops)
        row = {"shape": {"layers": n_layers, "rows": rows, "t": t, "kv": kv,
                         "page": ps, "d": d, "np": np_}, "max_abs_err": err,
               "ms": ms, "plain_ms": plain, "library_ms": lib,
               "bound_ms": bms, "bound_by": by,
               "pos": [int(x) for x in pos.tolist()]}
        paged_rows.append(row)
        say(f"  flash_decode_paged t={t}: kernel_ms {ms:.4f} plain_ms "
            f"{plain:.4f} library_ms {lib:.4f} bound_ms {bms:.5f} ({by}) "
            f"err {err:.2e}")
    check_other_paths(torch, ta, gen)
    # The training shape, from a generator of its own: drawing it from
    # the shared one would move the paged-decode inputs above.
    gen_train = torch.Generator().manual_seed(2)
    flash_case(8, 2048, None, lambda *shape: torch.randn(
        shape, generator=gen_train).to(dev, torch.bfloat16))
    # Cases added with the wgmma kernel, from a generator of their own:
    # q_offset with a window over a longer key sequence, a 1000-token
    # batch of 4 (a ragged T at BQ 128), GQA at the training shape.
    gen_new = torch.Generator().manual_seed(6)

    def draw_new(*shape):
        return torch.randn(shape, generator=gen_new).to(dev, torch.bfloat16)

    flash_case(2, 300, 100, draw_new, tk=364, q_offset=64)
    flash_case(4, 1000, None, draw_new)
    flash_case(8, 2048, None, draw_new, kv=2)
    check_forward_routes(torch, ta, draw_new)
    return flash_rows, paged_rows


def check_other_paths(torch, ta, gen):
    """Correctness only, off the flagship path: GQA in bf16, and the
    float32 kernels at the tiny preset's head_dim 8 (FMA route),
    atol 1e-4 — float32 throughout, summed in another order."""
    dev = torch.device("cuda")
    q, k, v = (torch.randn(s, generator=gen).to(dev, torch.bfloat16)
               for s in ((1, 300, 8, 64), (1, 300, 2, 64), (1, 300, 2, 64)))
    o_k, _ = ta.flash_forward(q, k, v, causal=True)
    o_p, _ = ta.flash_attention_reference(q, k, v, causal=True)
    err = float((o_k.float() - o_p.float()).abs().max())
    need(err <= FLASH_O_ATOL, f"flash_fwd GQA bf16: err {err}")
    q, k, v = (torch.randn(s, generator=gen).to(dev)
               for s in ((2, 100, 4, 8), (2, 100, 2, 8), (2, 100, 2, 8)))
    o_k, lse_k = ta.flash_forward(q, k, v, causal=True)
    o_p, lse_p = ta.flash_attention_reference(q, k, v, causal=True)
    err32 = max(float((o_k - o_p).abs().max()),
                float((lse_k - lse_p).abs().max()))
    need(err32 <= 1e-4, f"flash_fwd float32: err {err32}")
    kpool, vpool = (torch.randn((2, 9, 4, 64, 8), generator=gen).to(dev)
                    for _ in range(2))
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=dev)
    pos = torch.tensor([70, 5], dtype=torch.int32, device=dev)
    qd = torch.randn((2, 1, 4, 8), generator=gen).to(dev)
    self_kv = tuple(torch.randn((2, 1, 4, 8), generator=gen).to(dev)
                    for _ in range(2))
    out_k = ta.flash_decode_paged(qd, kpool, vpool, table, pos, layer=1,
                                  self_kv=self_kv)
    out_p = ta._paged_decode_reference(qd, kpool, vpool, table, pos,
                                       1 / math.sqrt(8), layer=1,
                                       self_kv=self_kv)
    errd = float((out_k - out_p).abs().max())
    need(errd <= 1e-4, f"flash_decode_paged float32: err {errd}")
    say(f"  other paths: flash_fwd GQA bf16 err {err:.2e}, flash_fwd "
        f"float32 head_dim 8 err {err32:.2e}, flash_decode_paged float32 "
        f"head_dim 8 err {errd:.2e}")


def check_forward_routes(torch, ta, draw):
    """Correctness only (o atol 2e-2, lse atol 1e-3): the wgmma forward at
    head_dim 128 (both query block sizes, GQA, a window) and without the
    causal mask over a longer key sequence; then the mma.sync kernel that
    bf16 head_dim 16 and 32 take — causal with GQA, a window with
    q_offset over more keys than queries, and full attention."""
    out = []
    for b, t, tk, h, kv, d, causal, window, q_offset in [
            (4, 1000, 1000, 8, 8, 128, True, None, 0),
            (1, 300, 300, 4, 2, 128, True, 100, 0),
            (2, 200, 333, 4, 4, 64, False, None, 0),
            (2, 300, 300, 8, 2, 16, True, None, 0),
            (1, 200, 264, 4, 4, 32, True, 50, 64),
            (2, 130, 200, 4, 2, 32, False, None, 0),
            (1, 100, 100, 4, 1, 16, True, 30, 0)]:
        q, k, v = draw(b, t, h, d), draw(b, tk, kv, d), draw(b, tk, kv, d)
        o_k, lse_k = ta.flash_forward(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset)
        route = fwd_launched(torch, ta, q)
        o_p, lse_p = ta.flash_attention_reference(
            q, k, v, causal=causal, window=window, q_offset=q_offset)
        torch.cuda.synchronize()
        err_o = float((o_k.float() - o_p.float()).abs().max())
        err_l = float((lse_k - lse_p).abs().max())
        need(err_o <= FLASH_O_ATOL and err_l <= FLASH_LSE_ATOL,
             f"flash_fwd check [{b},{t},{h},{d}] kv={kv} tk={tk} "
             f"causal={causal} window={window} q_offset={q_offset} "
             f"{route}: o err {err_o} lse err {err_l}")
        out.append(f"[{b},{t},{h},{d}] kv {kv} tk {tk} causal {causal} "
                   f"window {window} q_offset {q_offset} {route[0]} BQ "
                   f"{route[1]}: o {err_o:.2e} lse {err_l:.2e}")
    say("  flash_fwd checks: " + "; ".join(out))


def phase_backward(torch):
    from tfmesos_tpu_torch.ops import attention as ta

    say("[4/12] backward kernels vs plain versions (CUDA-event medians)")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)

    def case(b, t, h, kv, d, window=None, q_offset=0,
             dtype=torch.bfloat16, out_dtype=None, time_it=False):
        q, k, v, do = (torch.randn(s, generator=gen).to(dev, dtype)
                       for s in ((b, t, h, d), (b, t, kv, d), (b, t, kv, d),
                                 (b, t, h, d)))
        scale = 1.0 / math.sqrt(d)
        o, lse = ta.flash_forward(q, k, v, causal=True, window=window,
                                  q_offset=q_offset)
        delta = ta._bwd_delta(o, do)
        args = (q, k, v, do, lse, delta, True, scale, window, q_offset,
                out_dtype)
        got = (ta.flash_bwd_dq(*args),) + ta.flash_bwd_dkv(*args)
        ref = ((ta._flash_bwd_dq_reference(*args),)
               + ta._flash_bwd_dkv_reference(*args))
        torch.cuda.synchronize()
        row = {"shape": [b, t, h, kv, d], "window": window,
               "q_offset": q_offset, "dtype": str(dtype).split(".")[-1],
               "out_dtype": str(got[0].dtype).split(".")[-1]}
        for name, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
            err = float((g_.float() - r_.float()).abs().max())
            mag = float(r_.float().abs().max())
            tol = (BWD_F32_ATOL if dtype == torch.float32
                   else BWD_REL_TOL * max(1.0, mag))
            need(bool(torch.isfinite(g_).all()) and err <= tol,
                 f"flash_bwd {name} {row}: err {err} > tol {tol} (max "
                 f"|ref| {mag})")
            row[f"{name}_err"], row[f"{name}_tol"] = err, tol
        if not time_it:
            return row
        allow = ~ta._causal_mask(t, t, q_offset, window, dev)
        pairs = b * h * int(allow.sum())            # visible (q, k) pairs
        qbytes, kbytes = b * t * h * d * 2, b * t * kv * d * 2
        ins = 2 * qbytes + 2 * kbytes + 2 * b * h * t * 4
        row["dq_bound_ms"], row["dq_bound_by"] = bound(ins + qbytes,
                                                       6 * d * pairs)
        row["dkv_bound_ms"], row["dkv_bound_by"] = bound(ins + 2 * kbytes,
                                                         8 * d * pairs)
        big = b * t >= 8192
        reps, n = (3, 5) if big else (5, 20)
        row["dq_ms"] = cuda_ms(torch, lambda: ta.flash_bwd_dq(*args))
        row["dkv_ms"] = cuda_ms(torch, lambda: ta.flash_bwd_dkv(*args))
        row["dq_plain_ms"] = cuda_ms(
            torch, lambda: ta._flash_bwd_dq_reference(*args), reps, n)
        row["dkv_plain_ms"] = cuda_ms(
            torch, lambda: ta._flash_bwd_dkv_reference(*args), reps, n)
        # Yardstick: SDPA's backward alone (dq, dk and dv in one call).
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2).contiguous()
        row["library_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True))
        say(f"  flash_bwd {row['shape']}: dq kernel_ms {row['dq_ms']:.4f} "
            f"plain_ms {row['dq_plain_ms']:.4f} bound_ms "
            f"{row['dq_bound_ms']:.5f} ({row['dq_bound_by']}); dkv "
            f"kernel_ms {row['dkv_ms']:.4f} plain_ms "
            f"{row['dkv_plain_ms']:.4f} bound_ms {row['dkv_bound_ms']:.5f} "
            f"({row['dkv_bound_by']}); SDPA backward library_ms "
            f"{row['library_ms']:.4f}; err dq {row['dq_err']:.2e} dk "
            f"{row['dk_err']:.2e} dv {row['dv_err']:.2e}")
        return row

    timed = [case(8, 2048, 8, 8, 64, time_it=True),
             case(1, 512, 8, 8, 64, time_it=True)]
    checks = [case(1, 300, 8, 2, 64),                          # GQA
              case(1, 512, 8, 8, 64, window=128, q_offset=64),
              case(2, 1000, 8, 8, 64, out_dtype=torch.float32),
              case(2, 100, 4, 2, 8, dtype=torch.float32),
              case(1, 200, 4, 2, 16, window=16, q_offset=32,
                   dtype=torch.float32)]
    for r in checks:
        say(f"  flash_bwd check {r['shape']} window={r['window']} "
            f"q_offset={r['q_offset']} {r['dtype']}->{r['out_dtype']}: err "
            f"dq {r['dq_err']:.2e} dk {r['dk_err']:.2e} dv "
            f"{r['dv_err']:.2e} (tol {r['dq_tol']:.2e}/{r['dk_tol']:.2e}/"
            f"{r['dv_tol']:.2e})")
    return timed, checks


def phase_serve(torch, np):
    from tfmesos_tpu_torch.models.presets import flagship_model
    from tfmesos_tpu_torch.serving import ContinuousBatcher, Request

    say("[5/12] serve: flagship, rows 8, page 64, bucket 64, 16 requests")
    cfg, params = flagship_model(seed=0, max_len=1024)
    batcher = ContinuousBatcher(cfg, params, rows=8, page_size=64,
                                prefill_bucket=64, device="cuda")
    # Warm-up request (cuBLAS handles, kernel library loads) outside the
    # measured run.
    list(batcher.run([Request(np.arange(1, 9), 2)]))
    rng = np.random.RandomState(0)
    lens = rng.randint(8, 701, size=16)
    reqs = [Request(rng.randint(0, cfg.vocab_size, n), 32) for n in lens]
    batcher.prefills = batcher.decode_ticks = batcher.decode_tokens = 0
    batcher.decode_seconds = 0.0
    zero_launches()
    t0 = time.perf_counter()
    comps = list(batcher.run(reqs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    need(len(comps) == 16, f"{len(comps)} of 16 requests completed")
    need(all(len(c.tokens) == 32 for c in comps),
         "a request finished with other than 32 tokens")
    L = cfg.n_layers
    need(batcher.prefills == 16 and batcher.decode_ticks > 0,
         f"prefills {batcher.prefills} ticks {batcher.decode_ticks}")
    need(launches["flash_fwd"] == L * batcher.prefills,
         f"flash_fwd launches {launches['flash_fwd']} != {L} x "
         f"{batcher.prefills} prefills")
    need(launches["flash_decode_paged"] == L * batcher.decode_ticks,
         f"flash_decode_paged launches {launches['flash_decode_paged']} "
         f"!= {L} x {batcher.decode_ticks} decode ticks")
    need(launches["flash_decode"] == launches["flash_decode_merge"]
         == launches["quant_int8"] == 0,
         f"bf16 serving launched the linear decode or quant kernel: "
         f"{launches}")
    ttft = sorted(c.ttft_s * 1e3 for c in comps)
    stats = {"requests": len(comps), "wall_s": wall,
             "prefills": batcher.prefills,
             "decode_ticks": batcher.decode_ticks,
             "decode_tokens": batcher.decode_tokens,
             "decode_tok_per_s": batcher.decode_tokens
             / batcher.decode_seconds,
             "ms_per_tick": batcher.decode_seconds / batcher.decode_ticks
             * 1e3,
             "ttft_ms_mean": statistics.mean(ttft),
             "ttft_ms_p50": statistics.median(ttft),
             "peak_pages": batcher.peak_pages_used,
             "n_pages": batcher.n_pages, "launches": launches}
    say("  " + json.dumps(stats))
    stats["profile"] = profile_serving(torch, np, batcher, cfg)
    return cfg, params, reqs, comps, stats


def profile_serving(torch, np, batcher, cfg):
    """Device busy share of a short serving run (8 requests of 64 prompt
    tokens, 16 new tokens) under torch.profiler, and the top device
    kernels.  The profiler slows the host, so the busy share it reports
    is a lower bound of the unprofiled run's."""
    from tfmesos_tpu_torch.serving import Request

    rng = np.random.RandomState(1)
    reqs = [Request(rng.randint(0, cfg.vocab_size, 64), 16)
            for _ in range(8)]
    out = profile(torch, lambda: list(batcher.run(reqs)))
    say("  profile (8 x 64-token prompts, 16 new tokens): "
        + json.dumps(out))
    return out


# The port's kernel functions (csrc/*.cu), as the profiler names them.
PORT_KERNELS = ("flash_fwd_wgmma_kernel", "flash_fwd_mma_kernel",
                "flash_fwd_fma_kernel", "split_decode_kernel",
                "merge_partials", "paged_decode_kernel", "flash_bwd_dq_",
                "flash_bwd_dkv_", "quant_kernel")


def profile(torch, fn):
    """Run ``fn`` once under torch.profiler: wall ms, device ms, the
    device-busy share (device time over wall time), the top six device
    kernels by time, and the device ms and launches of each of the
    port's kernels that ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    port = {}
    for e in kernels:
        for name in PORT_KERNELS:
            if name in e.key:
                ms, n = port.get(name, (0.0, 0))
                port[name] = (ms + e.self_device_time_total / 1e3,
                              n + e.count)
    return {"wall_ms": wall_us / 1e3, "device_ms": dev_us / 1e3,
            "device_busy_share": dev_us / wall_us,
            "top_kernels": [(e.key[:60], e.self_device_time_total / 1e3,
                             e.count) for e in top],
            "port_kernels": port}


def phase_teacher_forced(torch, cfg, params, comps):
    from tfmesos_tpu_torch.models.transformer import forward

    say(f"[6/12] teacher-forced check vs float32 CPU forward "
        f"(margin {MARGIN})")
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    checked = agree_all = 0
    max_dlogit = 0.0
    card_params = _cuda(params)
    for c in sorted(comps, key=lambda c: c.rid)[:2]:
        prompt = [int(x) for x in c.request.prompt]
        seq = torch.tensor([prompt + c.tokens[:-1]])
        idx = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(c.tokens))
        with torch.no_grad():
            ref = forward(cpu_cfg, params, seq)[0, idx]
            card = forward(cfg, card_params, seq.cuda())[0, idx.cuda()]
        card = card.float().cpu()
        max_dlogit = max(max_dlogit, float((card - ref).abs().max()))
        top = ref.topk(2, dim=-1)
        margin = top.values[:, 0] - top.values[:, 1]
        for i, tok in enumerate(c.tokens):
            agree_all += int(int(top.indices[i, 0]) == tok)
            if float(margin[i]) > MARGIN:
                checked += 1
                need(int(top.indices[i, 0]) == tok,
                     f"rid {c.rid} token {i}: card {tok} vs CPU argmax "
                     f"{int(top.indices[i, 0])} at margin "
                     f"{float(margin[i]):.3f}")
    need(checked >= MIN_CHECKED, f"only {checked} positions above the "
         f"margin (need {MIN_CHECKED})")
    say(f"  checked {checked} positions (margin > {MARGIN}); all agree; "
        f"argmax agreement at every position {agree_all}/"
        f"{2 * len(comps[0].tokens)}; card bf16 vs CPU fp32 teacher-forced "
        f"max |dlogit| {max_dlogit:.4f}")
    return {"checked": checked, "agree_all": agree_all,
            "max_dlogit": max_dlogit}


def _cuda(params):
    return {k: (_cuda(v) if isinstance(v, dict) else v.cuda())
            for k, v in params.items()}


def phase_forward(torch):
    from tfmesos_tpu_torch.models.transformer import entry

    fn, (params, tokens) = entry(device="cuda")
    with torch.no_grad():
        logits = fn(params, tokens)
        torch.cuda.synchronize()
        need(tuple(logits.shape) == (4, 1024, 8192),
             f"forward logits {tuple(logits.shape)}")
        need(bool(torch.isfinite(logits).all()), "non-finite logits")
        ms = cuda_ms(torch, lambda: fn(params, tokens), reps=3, n=5)
    say(f"[7/12] forward [4, 1024] on the card: logits finite, "
        f"{ms:.3f} ms per call")
    return ms


def phase_train(torch):
    from tfmesos_tpu_torch import transformer_train as tr
    from tfmesos_tpu_torch.train.data import token_batches

    args = tr.parse_args([])            # the example's defaults
    say(f"[8/12] train: flagship, B {args.batch_size}, T {args.seq_len}, "
        f"AdamW {args.learning_rate} (weight decay 0.01), weights seeded 0")
    run = tr.setup(args, torch.device("cuda"))
    torch.cuda.reset_peak_memory_stats()
    # Two warm-up steps (cuBLAS handles, the allocator's pools) outside
    # the measured run; their losses still count for the loss check.
    warm = tr.train(run, 2, log=None)
    zero_launches()
    out = tr.train(run, TRAIN_STEPS, log=lambda line: say("  " + line))
    launches = read_launches()
    losses = warm["losses"] + out["losses"]
    need(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    need(losses[-1] < losses[0], f"loss did not fall: {losses}")
    L = run.cfg.n_layers
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        need(launches[key] == L * TRAIN_STEPS,
             f"{key} launches {launches[key]} != {L} x {TRAIN_STEPS} steps")
    for key in ("flash_decode_paged", "flash_decode", "flash_decode_merge",
                "quant_int8"):
        need(launches[key] == 0, f"{key} launched in training")
    # The host cost of the input stream, alone: its Python loop over T.
    stream = token_batches(args.batch_size, run.seq_len, run.cfg.vocab_size,
                           seed=tr.DATA_SEED + 1)
    t0 = time.perf_counter()
    host = [next(stream) for _ in range(3)]
    data_ms = (time.perf_counter() - t0) / 3 * 1e3
    # Steps with the batch already on the card.
    batch = {"tokens": torch.from_numpy(host[0]["tokens"]).cuda()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        run.params, run.opt_state, m = run.step(run.params, run.opt_state,
                                                batch)
    float(m["loss"])
    ready_ms = (time.perf_counter() - t0) / 5 * 1e3
    tokens = args.batch_size * run.seq_len
    stats = {"steps": TRAIN_STEPS, "first_loss": losses[0],
             "last_loss": losses[-1],
             "ms_per_step": out["elapsed_s"] / TRAIN_STEPS * 1e3,
             "tokens_per_s": out["tokens_per_s"],
             "ms_per_step_batch_ready": ready_ms,
             "tokens_per_s_batch_ready": tokens / ready_ms * 1e3,
             "token_batches_ms_per_batch": data_ms,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches}
    say("  " + json.dumps(stats))

    def two_steps():
        for _ in range(2):
            run.params, run.opt_state, _m = run.step(
                run.params, run.opt_state, batch)

    stats["profile"] = profile(torch, two_steps)
    # The profiler slows the host, so its busy share is a lower bound;
    # device time per step over the unprofiled step time estimates the
    # share of a plain step.
    stats["device_busy_share_unprofiled"] = (
        stats["profile"]["device_ms"] / 2 / ready_ms)
    say("  profile (2 steps, batch ready): " + json.dumps(stats["profile"])
        + f"; device ms per step over the unprofiled step: "
        f"{stats['device_busy_share_unprofiled']:.3f}")
    return run.cfg, stats


def phase_train_vs_cpu(torch, cfg):
    from tfmesos_tpu_torch import convert
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.train.data import token_batches

    say("[9/12] loss_fn + backward at [1, 1024]: card bf16 vs CPU float32")
    master = tt.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(next(token_batches(
        1, 1024, cfg.vocab_size, seed=7))["tokens"])

    def loss_and_grads(cfg_, dev):
        flat = {k: v.detach().to(dev).requires_grad_()
                for k, v in convert.flatten(master).items()}
        loss, _ = tt.loss_fn(cfg_, convert.unflatten(flat),
                             {"tokens": tokens.to(dev)})
        grads = torch.autograd.grad(loss, list(flat.values()))
        return float(loss.detach()), {k: g.double().cpu()
                                      for k, g in zip(flat, grads)}

    card_loss, card = loss_and_grads(cfg, "cuda")
    t0 = time.perf_counter()
    cpu_loss, cpu = loss_and_grads(dataclasses.replace(
        cfg, dtype=torch.float32), "cpu")
    cpu_s = time.perf_counter() - t0
    dloss = abs(card_loss - cpu_loss)
    cos = {k: float(torch.nn.functional.cosine_similarity(
        card[k].reshape(-1), cpu[k].reshape(-1), dim=0)) for k in cpu}
    worst = min(cos, key=cos.get)
    need(dloss <= TRAIN_DLOSS, f"|dloss| {dloss} > {TRAIN_DLOSS} (card "
         f"{card_loss}, cpu {cpu_loss})")
    need(cos[worst] >= TRAIN_MIN_COS, f"gradient cosine of {worst} "
         f"{cos[worst]} < {TRAIN_MIN_COS}")
    out = {"card_loss": card_loss, "cpu_loss": cpu_loss, "dloss": dloss,
           "dloss_limit": TRAIN_DLOSS, "min_cos": cos[worst],
           "min_cos_leaf": worst, "min_cos_limit": TRAIN_MIN_COS,
           "cos": cos, "cpu_s": cpu_s}
    say("  " + json.dumps(out))
    return out


def _lane_int8(tq, cache):
    """An int8 QTensor of a [..., M, D] cache, scales lane-major."""
    vals, scales = tq.quantize_int8_reference(cache)
    return tq.QTensor(vals, scales.squeeze(-1).unsqueeze(-2).contiguous())


def phase_decode_kernels(torch):
    """Phase 3, continued: the linear-cache decode kernel, the paged
    kernel's int8 fold and the int8 quantize kernel, each against its
    plain version on the card (inputs from generators of their own, so
    the earlier cases keep their inputs)."""
    import torch.nn.functional as F

    from tfmesos_tpu_torch.kernels import build
    from tfmesos_tpu_torch.ops import attention as ta
    from tfmesos_tpu_torch.ops import quant as tq

    dev = torch.device("cuda")
    rt = build.kernel("flash_decode", "tfm_flash_decode_row_tile", [])()
    need(rt == ta._DECODE_ROW_TILE, f"flash_decode row tile: kernel {rt}, "
         f"wrapper {ta._DECODE_ROW_TILE}")
    gen = torch.Generator().manual_seed(3)

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    decode_rows = []

    def decode_case(b, t, h, kv, m, d, pos, dtype, int8, time_it):
        layer = 1
        q = randn((b, t, h, d), dtype)
        kc, vc = randn((2, b, kv, m, d), dtype), randn((2, b, kv, m, d), dtype)
        if int8:
            kc, vc = _lane_int8(tq, kc), _lane_int8(tq, vc)
        posv = torch.tensor(pos, dtype=torch.int32, device=dev)
        out = ta.flash_decode(q, kc, vc, posv, layer=layer)
        splits = decode_launched(ta, q, kc.values if int8 else kc)
        ref = ta.flash_decode_reference(q, kc, vc, posv, layer=layer)
        split_ref = ta._decode_split_reference(q, kc, vc, posv, None, splits,
                                               layer=layer)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        err_row = row_err(out, ref)
        err_split = row_err(out, split_ref)
        bf = dtype == torch.bfloat16
        tol = DECODE_ATOL if bf else DECODE_F32_ATOL
        split_tol = SPLIT_BF16_TOL if bf else SPLIT_F32_TOL
        shape = {"b": b, "t": t, "h": h, "kv": kv, "m": m, "d": d,
                 "pos": pos, "dtype": str(dtype).split(".")[-1],
                 "int8": int8}
        need(bool(torch.isfinite(out).all()) and err <= tol
             and err_row <= tol and err_split <= split_tol,
             f"flash_decode {shape}: err {err}, per row {err_row} (tol "
             f"{tol}); per row against the S {splits} split reference "
             f"{err_split} (tol {split_tol})")
        row = {"shape": shape, "max_abs_err": err, "row_err": err_row,
               "tol": tol, "split_ref_row_err": err_split,
               "split_tol": split_tol, "splits": splits}
        if time_it:
            row["ms"] = cuda_ms(torch, lambda: ta.flash_decode(
                q, kc, vc, posv, layer=layer))
            row["host_us"] = host_us(torch, lambda: ta.flash_decode(
                q, kc, vc, posv, layer=layer))
            row["plain_ms"] = cuda_ms(torch, lambda: ta.flash_decode_reference(
                q, kc, vc, posv, layer=layer))
            # Yardstick: SDPA over the live prefix of the layer's cache
            # (MHA, t = 1, every row at the same position; an int8 cache
            # dequantized first, outside the timing).
            if int8:
                kl, vl = (ta._dequant_lane_major(tq.QTensor(
                    c.values[layer], c.scales[layer]), dtype)
                    for c in (kc, vc))
            else:
                kl, vl = kc[layer], vc[layer]
            kl, vl = kl[:, :, :pos[0] + 1], vl[:, :, :pos[0] + 1]
            qh = q.transpose(1, 2)
            row["library_ms"] = cuda_ms(
                torch, lambda: F.scaled_dot_product_attention(qh, kl, vl))
            live = sum(p + t for p in pos)       # positions read per head
            item = 1 if int8 else torch.finfo(dtype).bits // 8
            qbytes = b * t * h * d * torch.finfo(dtype).bits // 8
            bytes_ = (2 * live * kv * d * item + (8 * live * kv if int8
                                                   else 0)
                      + 2 * qbytes + 4 * b)
            keys = sum(p + tt + 1 for p in pos for tt in range(t))
            row["bound_ms"], row["bound_by"] = bound(bytes_,
                                                     4 * keys * h * d)
            say(f"  flash_decode {shape} [S {splits}]: kernel_ms "
                f"{row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
                f"library_ms {row['library_ms']:.4f} bound_ms "
                f"{row['bound_ms']:.5f} ({row['bound_by']}) err {err:.2e} "
                f"row_err {err_row:.2e} split_ref_row_err {err_split:.2e} "
                f"host_us {row['host_us']:.1f}")
        else:
            say(f"  flash_decode check {shape} [S {splits}]: err {err:.2e} "
                f"row_err {err_row:.2e} (tol {tol}) split_ref_row_err "
                f"{err_split:.2e} (tol {split_tol})")
        decode_rows.append(row)

    bf16, f32 = torch.bfloat16, torch.float32
    decode_case(4, 1, 8, 8, 16384, 64, [1024] * 4, bf16, False, True)
    decode_case(8, 1, 8, 8, 384, 64, [300] * 8, bf16, True, True)
    decode_case(3, 16, 8, 2, 512, 64, [7, 200, 400], bf16, True, False)
    decode_case(4, 1, 8, 2, 1024, 64, [0, 5, 511, 1000], bf16, False, False)
    decode_case(2, 4, 4, 2, 300, 8, [0, 250], f32, False, False)
    decode_case(2, 40, 4, 1, 300, 8, [3, 250], f32, True, False)
    cold = decode_cold(torch, ta, F)
    # Cases added with the split kernel, from a generator of their own
    # (the draws below keep their inputs): ragged long context, bf16 and
    # int8, and M = 301, whose odd heads' spans are not 16-byte aligned
    # (the producer warp loads them itself).
    main_gen, gen = gen, torch.Generator().manual_seed(7)
    ragged = [0, 1024, 9000, 16383]
    decode_case(4, 1, 8, 8, 16384, 64, ragged, bf16, False, False)
    decode_case(4, 1, 8, 8, 16384, 64, ragged, bf16, True, False)
    decode_case(3, 2, 8, 4, 301, 64, [0, 150, 298], bf16, True, False)
    decode_case(3, 1, 4, 4, 301, 8, [0, 150, 300], bf16, False, False)
    decode_case(2, 3, 8, 2, 700, 128, [0, 600], bf16, True, False)
    # Ragged long context in float32, from a generator of its own: at S 9
    # the pos-16383 row's shares are 29 blocks, so the 4-stage ring wraps
    # seven times under the tight float32 tolerance.
    gen = torch.Generator().manual_seed(8)
    decode_case(4, 1, 8, 8, 16384, 64, ragged, f32, False, False)
    gen = main_gen

    # The paged kernel's int8 fold at the serving shape.
    n_layers, rows, kv, ps, np_, h, d, layer = 8, 8, 8, 64, 16, 8, 64, 3
    n_pages = rows * np_ + 1
    kpool = _lane_int8(tq, randn((n_layers, n_pages, kv, ps, d)))
    vpool = _lane_int8(tq, randn((n_layers, n_pages, kv, ps, d)))
    perm = torch.randperm(n_pages - 1, generator=gen) + 1    # 0 = sink
    table = perm[:rows * np_].reshape(rows, np_).to(dev, torch.int32)
    scale = 1.0 / math.sqrt(d)
    paged_rows = []
    for t in (1, 4):
        pos = torch.randint(1, 1001, (rows,), generator=gen)
        pos = pos.clamp(max=np_ * ps - t).to(dev, torch.int32)
        q = randn((rows, t, h, d))
        # As decode_step hands it over: the chunk quantize-dequantized.
        self_kv = tuple(tq.QTensor(*tq.quantize_int8_reference(
            randn((rows, t, kv, d)))).dequantize(torch.bfloat16)
            for _ in range(2))
        out_k = ta.flash_decode_paged(q, kpool, vpool, table, pos,
                                      layer=layer, self_kv=self_kv)
        out_p = ta._paged_decode_reference(q, kpool, vpool, table, pos,
                                           scale, layer=layer,
                                           self_kv=self_kv)
        torch.cuda.synchronize()
        err = float((out_k.float() - out_p.float()).abs().max())
        need(err <= PAGED_ATOL, f"flash_decode_paged int8 t={t}: err {err}")
        ms = cuda_ms(torch, lambda: ta.flash_decode_paged(
            q, kpool, vpool, table, pos, layer=layer, self_kv=self_kv))
        plain = cuda_ms(torch, lambda: ta._paged_decode_reference(
            q, kpool, vpool, table, pos, scale, layer=layer,
            self_kv=self_kv))
        # Yardstick: SDPA over the gathered, dequantized view with the
        # chunk written at its positions (built outside the timing).
        tl = table.long()
        m = np_ * ps
        kview, vview = (ta._dequant_lane_major(tq.QTensor(
            p_.values[layer], p_.scales[layer]), torch.bfloat16)[tl]
            .transpose(1, 2).reshape(rows, kv, m, d)
            for p_ in (kpool, vpool))
        ridx = torch.arange(rows, device=dev)[:, None]
        cols = pos.long()[:, None] + torch.arange(t, device=dev)[None]
        kview[ridx, :, cols] = self_kv[0]
        vview[ridx, :, cols] = self_kv[1]
        allow = (torch.arange(m, device=dev)[None, None, :]
                 <= cols[:, :, None])[:, None]
        qh = q.transpose(1, 2).contiguous()
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kview, vview, attn_mask=allow))
        live = int(pos.sum())
        keys = int((pos.long()[:, None] + torch.arange(
            1, t + 1, device=dev)[None]).sum())
        bytes_ = (2 * live * kv * d + 8 * live * kv
                  + 2 * rows * t * kv * d * 2 + 2 * rows * t * h * d * 2
                  + rows * np_ * 4 + rows * 4)
        bms, by = bound(bytes_, 4 * keys * h * d)
        row = {"shape": {"layers": n_layers, "rows": rows, "t": t, "kv": kv,
                         "page": ps, "d": d, "np": np_, "int8": True},
               "max_abs_err": err, "ms": ms, "plain_ms": plain,
               "library_ms": lib, "bound_ms": bms, "bound_by": by,
               "pos": [int(x) for x in pos.tolist()]}
        paged_rows.append(row)
        say(f"  flash_decode_paged int8 t={t}: kernel_ms {ms:.4f} plain_ms "
            f"{plain:.4f} library_ms {lib:.4f} bound_ms {bms:.5f} ({by}) "
            f"err {err:.2e}")

    # The quantize kernel: every flagship weight leaf (float32 masters,
    # rows = leading dims flattened) and a cache write's K chunk (bf16,
    # one row per (row, token, kv head)).
    quant_rows = []
    leaves = [("embed", 8192, 512, 1), ("wq|wk|wv|wo", 4096, 512, 4),
              ("w_gate|w_up", 4096, 1408, 2), ("w_down", 11264, 512, 1),
              ("head", 512, 8192, 1)]
    cases = [(n, r, c, k, f32) for n, r, c, k in leaves] + [
        ("cache write, t=1", 64, 64, 0, bf16),
        ("cache write, prefill 128", 8192, 64, 0, bf16)]
    for name, r, c, n_leaves, dtype in cases:
        x = randn((r, c), dtype)
        v, s_ = tq.quantize_int8(x)
        rv, rs = tq.quantize_int8_reference(x)
        sv, ss = tq.quantize_int8(x, stochastic=True, seed=11)
        pv, ps_ = tq.quantize_int8_reference(x, stochastic=True, seed=11)
        torch.cuda.synchronize()
        err = max(float((v.float() - rv.float()).abs().max()),
                  float((s_ - rs).abs().max()),
                  float((sv.float() - pv.float()).abs().max()))
        need(torch.equal(v, rv) and torch.equal(s_, rs),
             f"quant_int8 {name} [{r}, {c}]: round-to-nearest not "
             f"bit-exact (err {err})")
        need(torch.equal(sv, pv) and torch.equal(ss, ps_),
             f"quant_int8 {name} [{r}, {c}]: stochastic not bit-exact to "
             f"its plain version")
        # The dither is unbiased: the mean rounding error in steps is ~0
        # (its standard error is ~0.29 / sqrt(n)).
        bias = float(((sv.float() * ss - x.float()) / ss).mean())
        need(abs(bias) < 0.02 and int(sv.min()) >= -127,
             f"quant_int8 {name}: stochastic bias {bias} steps")
        ms = cuda_ms(torch, lambda: tq.quantize_int8(x))
        plain = cuda_ms(torch, lambda: tq.quantize_int8_reference(x))
        n = r * c
        bytes_ = n * (torch.finfo(dtype).bits // 8) + n + 4 * r
        bms, by = bound(bytes_, 5 * n, F32_FLOPS)
        row = {"shape": [r, c], "leaf": name, "leaves": n_leaves,
               "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
               "stochastic_bias_steps": bias, "ms": ms, "plain_ms": plain,
               "library_ms": None, "bound_ms": bms, "bound_by": by}
        quant_rows.append(row)
        say(f"  quant_int8 {name} [{r}, {c}] {row['dtype']}: kernel_ms "
            f"{ms:.4f} plain_ms {plain:.4f} bound_ms {bms:.5f} ({by}) "
            f"bit-exact (RTN and stochastic), bias {bias:+.4f} steps")
    x = torch.full((8, 128), 0.5, device=dev)
    x[:, 0] = 127.0                           # every row's scale is 1
    means = [float(tq.quantize_int8(x, stochastic=True, seed=sd)[0][:, 1:]
                   .float().mean()) for sd in range(8)]
    need(0.3 < statistics.mean(means) < 0.7 and len(set(means)) > 1,
         f"quant_int8: stochastic half-step means {means}")
    total = {k: sum(r_[k] * r_["leaves"] for r_ in quant_rows)
             for k in ("ms", "plain_ms", "bound_ms")}
    say(f"  quantize_params (9 leaves): kernel_ms {total['ms']:.4f} "
        f"plain_ms {total['plain_ms']:.4f} bound_ms "
        f"{total['bound_ms']:.5f}; half-step stochastic means "
        f"{statistics.mean(means):.3f}")
    return decode_rows, cold, paged_rows, quant_rows, total


def decode_cold(torch, ta, F):
    """flash_decode as generate calls it: bf16 [4, KV 8, M 16384, 64] at
    pos 1024, one launch per layer of an 8-layer stacked cache in turn,
    so the ~67 MB of live K/V (8 layers x 4 rows x 8 heads x 1,025
    positions x 64 x 2 bytes x 2) exceed the 50 MB L2 and every launch
    reads its layer from device memory; SDPA over the live prefix cycled
    the same way.  Warm numbers are phase 3's first decode row."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(9)
    n_layers, b, kv, m, d, pos = 8, 4, 8, 16384, 64, 1024
    q = torch.randn((b, 1, kv, d), generator=gen).to(dev, torch.bfloat16)
    kc, vc = (torch.randn((n_layers, b, kv, m, d), generator=gen).to(
        dev, torch.bfloat16) for _ in range(2))
    posv = torch.full((b,), pos, dtype=torch.int32, device=dev)
    turn = [0]

    def next_layer():
        turn[0] = (turn[0] + 1) % n_layers
        return turn[0]

    out = ta.flash_decode(q, kc, vc, posv, layer=5)
    splits = decode_launched(ta, q, kc)
    ref = ta.flash_decode_reference(q, kc, vc, posv, layer=5)
    split_ref = ta._decode_split_reference(q, kc, vc, posv, None, splits,
                                           layer=5)
    err = float((out.float() - ref.float()).abs().max())
    err_row, err_split = row_err(out, ref), row_err(out, split_ref)
    need(err <= DECODE_ATOL and err_row <= DECODE_ATOL
         and err_split <= SPLIT_BF16_TOL,
         f"flash_decode cold case: err {err}, per row {err_row}, per row "
         f"against the split reference {err_split}")
    ms = cuda_ms(torch, lambda: ta.flash_decode(q, kc, vc, posv,
                                                layer=next_layer()), n=32)
    qh = q.transpose(1, 2)
    live = [(kc[i][:, :, :pos + 1], vc[i][:, :, :pos + 1])
            for i in range(n_layers)]
    lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, *live[next_layer()]), n=32)
    bytes_ = 2 * b * kv * (pos + 1) * d * 2 + 2 * b * kv * d * 2 + 4 * b
    bms, by = bound(bytes_, 4 * b * (pos + 1) * kv * d)
    row = {"shape": {"layers": n_layers, "b": b, "kv": kv, "m": m, "d": d,
                     "pos": pos}, "max_abs_err": err, "row_err": err_row,
           "split_ref_row_err": err_split, "splits": splits, "ms": ms,
           "library_ms": lib, "bound_ms": bms, "bound_by": by}
    say(f"  flash_decode cold L2 (8 layers in turn) [S {splits}]: kernel_ms "
        f"{ms:.4f} library_ms {lib:.4f} bound_ms {bms:.5f} ({by}) err "
        f"{err:.2e} row_err {err_row:.2e} split_ref_row_err "
        f"{err_split:.2e}")
    return row


def _to(params, dev):
    """A params tree on ``dev`` (QTensor leaves keep their dtypes)."""
    from tfmesos_tpu_torch.ops.quant import QTensor

    def leaf(v):
        if isinstance(v, dict):
            return _to(v, dev)
        if isinstance(v, QTensor):
            return QTensor(v.values.to(dev), v.scales.to(dev))
        return v.to(dev)

    return {k: leaf(v) for k, v in params.items()}


def teacher_forced_int8(torch, cfg, qparams, prompt, gen):
    """float32 CPU logits for each generated token from the SAME int8
    weights over an int8 linear cache, teacher-forced with the card's
    tokens: the prompt prefilled, then every generated token but the
    last decoded as one chunk (a chunk writes each position's K/V before
    attending, as token-by-token decoding does).  Fails where the card's
    token differs from the CPU argmax at a top-1/top-2 margin above
    MARGIN; returns (positions above the margin, argmax agreement at
    every position, positions)."""
    from tfmesos_tpu_torch.models import transformer as tt

    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_params = _to(qparams, "cpu")
    prompt, gen = prompt.cpu().long(), gen.cpu().long()
    b, p = prompt.shape
    n = gen.shape[1]
    with torch.no_grad():
        cache = tt.init_cache(cpu_cfg, b, p + n, quantized=True)
        first, cache = tt.decode_step(cpu_cfg, cpu_params, cache, prompt, 0)
        ref = first[:, -1:]
        if n > 1:
            rest, _ = tt.decode_step(cpu_cfg, cpu_params, cache,
                                     gen[:, :-1], p)
            ref = torch.cat([ref, rest], dim=1)
    top = ref.float().topk(2, dim=-1)
    margin = top.values[..., 0] - top.values[..., 1]
    clear = margin > MARGIN
    agree = top.indices[..., 0] == gen
    bad = clear & ~agree
    need(not bool(bad.any()), f"teacher-forced: card token differs from "
         f"the CPU argmax at {int(bad.sum())} positions above the margin")
    return int(clear.sum()), int(agree.sum()), agree.numel()


def _generate_rate(torch, run, prefill, new_tokens, batch, reps=2):
    """(seconds of a whole run, of its prefill alone, decode tokens/s
    without the prefill, ms per decode step), each the best of ``reps``
    host-clock timings that end in a synchronize."""
    def best(fn):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return min(out)

    whole, pre = best(run), best(prefill)
    decode = whole - pre
    return whole, pre, batch * (new_tokens - 1) / decode, \
        decode / (new_tokens - 1) * 1e3


def decode_splits(cfg, batch, slots):
    """Split count of a generate step's flash_decode launch (t = 1) over a
    cache of ``slots`` positions on this card."""
    from tfmesos_tpu_torch.ops import attention as ta

    tiles = -(-(cfg.n_heads // cfg.kv_heads) // ta._DECODE_ROW_TILE)
    return ta._decode_splits(batch, cfg.kv_heads, tiles, slots,
                             ta._sm_count("cuda"))


def phase_generate_int8(torch):
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.models.presets import flagship_model

    batch, plen, new = 8, 128, 256
    say(f"[10/12] generate: flagship, int8 weights + int8 KV cache, batch "
        f"{batch}, prompt {plen}, {new} new tokens, greedy")
    cfg, params = flagship_model(seed=0, max_len=plen + new, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (batch, plen),
                           generator=torch.Generator().manual_seed(4)).cuda()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    qparams = tt.quantize_params(cfg, params)
    with torch.no_grad():
        out = tt.generate(cfg, qparams, prompt, new, quantized_cache=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    L = cfg.n_layers
    # The merge kernel runs after every decode launch whose shapes split
    # the cache (static: batch, kv heads, row tiles, cache slots).
    merges = L * (new - 1) if decode_splits(cfg, batch, plen + new) > 1 \
        else 0
    want = {"quant_int8": 9 + 2 * L * new, "flash_fwd": L,
            "flash_decode": L * (new - 1), "flash_decode_merge": merges,
            "flash_decode_paged": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    need(launches == want, f"int8 generate launches {launches} != {want}")
    need(tuple(out.shape) == (batch, plen + new)
         and bool(((out >= 0) & (out < cfg.vocab_size)).all())
         and torch.equal(out[:, :plen], prompt),
         f"int8 generate output {tuple(out.shape)}")

    def run(n=new):
        with torch.no_grad():
            return tt.generate(cfg, qparams, prompt, n, quantized_cache=True)

    rerun_identical = bool(torch.equal(run(), out))
    whole, pre, tok_s, step_ms = _generate_rate(
        torch, run, lambda: run(1), new, batch)
    t0 = time.perf_counter()
    checked, agree, n_pos = teacher_forced_int8(torch, cfg, qparams, prompt,
                                                out[:, plen:])
    cpu_s = time.perf_counter() - t0
    need(checked >= MIN_CHECKED, f"only {checked} positions above the "
         f"margin (need {MIN_CHECKED})")
    stats = {"batch": batch, "prompt": plen, "new_tokens": new,
             "first_run_s": first_s, "run_s": whole, "prefill_s": pre,
             "decode_tok_per_s": tok_s, "ms_per_step": step_ms,
             "launches": launches, "rerun_identical": rerun_identical,
             "teacher_forced_checked": checked, "argmax_agree": agree,
             "positions": n_pos, "cpu_check_s": cpu_s}
    say("  " + json.dumps(stats))
    stats["profile"] = profile(torch, lambda: run(16))
    say("  profile (16 new tokens): " + json.dumps(stats["profile"]))
    return stats


def phase_generate_long(torch):
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.models.presets import flagship_model

    batch, plen, new, max_len = 4, 1024, 64, 16384
    say(f"[11/12] generate: flagship bf16, batch {batch} over a {max_len}-"
        f"slot cache, prompt {plen}, {new} new tokens, greedy")
    cfg, params = flagship_model(seed=0, max_len=max_len, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (batch, plen),
                           generator=torch.Generator().manual_seed(5)).cuda()
    cache = tt.init_cache(cfg, batch, max_len, device="cuda")
    torch.cuda.synchronize()
    zero_launches()
    with torch.no_grad():
        out = tt.generate(cfg, params, prompt, new, cache=cache)
    torch.cuda.synchronize()
    launches = read_launches()
    L = cfg.n_layers
    merges = L * (new - 1) if decode_splits(cfg, batch, max_len) > 1 else 0
    want = {"quant_int8": 0, "flash_fwd": L, "flash_decode": L * (new - 1),
            "flash_decode_merge": merges, "flash_decode_paged": 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    need(launches == want, f"long-context generate launches {launches} != "
         f"{want}")

    def run(n=new):
        with torch.no_grad():
            return tt.generate(cfg, params, prompt, n, cache=cache)

    whole, pre, tok_s, step_ms = _generate_rate(
        torch, run, lambda: run(1), new, batch)
    # Teacher-forced on the card: the forward kernel over the whole
    # sequence must agree with the decode path's tokens wherever its
    # top-1/top-2 margin is clear.
    with torch.no_grad():
        logits = tt.forward(cfg, params, out[:, :-1].long())[:, plen - 1:]
    top = logits.float().topk(2, dim=-1)
    clear = (top.values[..., 0] - top.values[..., 1]) > MARGIN
    gen = out[:, plen:].long()
    bad = clear & (top.indices[..., 0] != gen)
    need(bool(torch.isfinite(logits).all()) and not bool(bad.any()),
         f"long-context generate: {int(bad.sum())} tokens differ from the "
         f"forward's clear argmax")
    checked = int(clear.sum())
    need(checked >= MIN_CHECKED, f"only {checked} positions above the "
         f"margin (need {MIN_CHECKED})")
    stats = {"batch": batch, "prompt": plen, "new_tokens": new,
             "cache_slots": max_len, "run_s": whole, "prefill_s": pre,
             "decode_tok_per_s": tok_s, "ms_per_step": step_ms,
             "launches": launches, "forward_checked": checked}
    say("  " + json.dumps(stats))
    stats["profile"] = profile(torch, lambda: run(16))
    say("  profile (16 new tokens): " + json.dumps(stats["profile"]))
    return stats


def phase_serve_int8(torch, np, reqs):
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.models.presets import flagship_model
    from tfmesos_tpu_torch.serving import ContinuousBatcher, Request

    say("[12/12] serve int8: phase 5's 16 requests, int8 weights and an "
        "int8 page pool")
    cfg, params = flagship_model(seed=0, max_len=1024, device="cuda")
    qparams = tt.quantize_params(cfg, params)
    batcher = ContinuousBatcher(cfg, qparams, rows=8, page_size=64,
                                prefill_bucket=64, quantized_cache=True,
                                device="cuda")
    list(batcher.run([Request(np.arange(1, 9), 2)]))          # warm-up
    batcher.prefills = batcher.decode_ticks = batcher.decode_tokens = 0
    batcher.decode_seconds = 0.0
    zero_launches()
    t0 = time.perf_counter()
    comps = list(batcher.run(reqs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    L, n_pre, ticks = cfg.n_layers, batcher.prefills, batcher.decode_ticks
    need(len(comps) == 16 and all(len(c.tokens) == 32 for c in comps),
         "int8 serving: a request did not complete its 32 tokens")
    want = {"flash_fwd": L * n_pre, "flash_decode_paged": L * ticks,
            "quant_int8": 2 * n_pre + (2 * L + 2) * ticks,
            "flash_decode": 0, "flash_decode_merge": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
    need(n_pre == 16 and ticks > 0 and launches == want,
         f"int8 serving launches {launches} != {want} ({n_pre} prefills, "
         f"{ticks} ticks)")
    checked = agree = n_pos = 0
    for c in sorted(comps, key=lambda c: c.rid)[:2]:
        prompt = torch.tensor([[int(x) for x in c.request.prompt]])
        ch, ag, n = teacher_forced_int8(torch, cfg, qparams, prompt,
                                        torch.tensor([c.tokens]))
        checked, agree, n_pos = checked + ch, agree + ag, n_pos + n
    need(checked >= MIN_CHECKED, f"only {checked} positions above the "
         f"margin (need {MIN_CHECKED})")
    ttft = sorted(c.ttft_s * 1e3 for c in comps)
    stats = {"requests": len(comps), "wall_s": wall, "prefills": n_pre,
             "decode_ticks": ticks, "decode_tokens": batcher.decode_tokens,
             "decode_tok_per_s": batcher.decode_tokens
             / batcher.decode_seconds,
             "ms_per_tick": batcher.decode_seconds / ticks * 1e3,
             "ttft_ms_mean": statistics.mean(ttft),
             "ttft_ms_p50": statistics.median(ttft),
             "peak_pages": batcher.peak_pages_used, "launches": launches,
             "teacher_forced_checked": checked, "argmax_agree": agree,
             "positions": n_pos}
    say("  " + json.dumps(stats))
    return stats


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import tfmesos_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script "
              f"({e})", file=sys.stderr)
        return 1
    pkg_root = Path(tfmesos_tpu_torch.__file__).resolve().parent.parent
    need(pkg_root == ROOT, f"tfmesos_tpu_torch imported from {pkg_root}, "
         f"not from this checkout ({ROOT})")

    smi = phase_device(torch)
    phase_build()
    flash_rows, paged_rows = phase_kernels(torch)
    decode_rows, decode_cold_row, paged8_rows, quant_rows, quant_total = \
        phase_decode_kernels(torch)
    bwd_rows, bwd_checks = phase_backward(torch)
    cfg, params, reqs, comps, stats = phase_serve(torch, np)
    phase_teacher_forced(torch, cfg, params, comps)
    phase_forward(torch)
    train_cfg, train = phase_train(torch)
    phase_train_vs_cpu(torch, train_cfg)
    gen8 = phase_generate_int8(torch)
    gen_long = phase_generate_long(torch)
    serve8 = phase_serve_int8(torch, np, reqs)

    paths = {"serve": stats["launches"], "train": train["launches"],
             "generate_int8": gen8["launches"],
             "generate_long": gen_long["launches"],
             "serve_int8": serve8["launches"]}

    def launches_of(name):
        by_path = {p: counts[name] for p, counts in paths.items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    def entry_of(name, source, replaces, rows, rep, **extra):
        r = rows[rep]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, **launches_of(name),
                "max_abs_err": max(x["max_abs_err"] for x in rows),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape": r["shape"],
                "shapes": rows, **extra}

    def bwd_entry(name, key, replaces, errs):
        r = bwd_rows[0]                      # the training shape
        return {"name": name, "route": "cuda",
                "source": "tfmesos_tpu_torch/csrc/flash_bwd.cu",
                "replaces": replaces, **launches_of(name),
                "max_abs_err": max(r[f"{e}_err"] for e in errs),
                "ms": r[f"{key}_ms"], "plain_ms": r[f"{key}_plain_ms"],
                "bound_ms": r[f"{key}_bound_ms"],
                "bound_by": r[f"{key}_bound_by"],
                "library_ms": r["library_ms"],
                "library_covers": "SDPA backward: dq, dk and dv together",
                "shape": r["shape"], "shapes": bwd_rows,
                "checks": bwd_checks}

    kernels = [
        entry_of("flash_fwd", "tfmesos_tpu_torch/csrc/flash_fwd.cu",
                 "tfmesos_tpu/ops/attention.py:127", flash_rows, 1,
                 routes={f"{r['shape']} kv {r['kv']} tk {r['tk']}":
                         [r["route"], r["block_rows"]] for r in flash_rows}),
        entry_of("flash_decode_paged",
                 "tfmesos_tpu_torch/csrc/flash_decode_paged.cu",
                 "tfmesos_tpu/ops/attention.py:871",
                 paged_rows + paged8_rows, 0),
        entry_of("flash_decode", "tfmesos_tpu_torch/csrc/flash_decode.cu",
                 "tfmesos_tpu/ops/attention.py:596", decode_rows, 0,
                 splits=decode_rows[0]["splits"],
                 merge_launches=launches_of("flash_decode_merge"),
                 cold_l2=decode_cold_row),
        bwd_entry("flash_bwd_dq", "dq", "tfmesos_tpu/ops/attention.py:246",
                  ("dq",)),
        bwd_entry("flash_bwd_dkv", "dkv", "tfmesos_tpu/ops/attention.py:302",
                  ("dk", "dv")),
        entry_of("quant_int8", "tfmesos_tpu_torch/csrc/quant_int8.cu",
                 "tfmesos_tpu/ops/quant.py:40", quant_rows, 0,
                 quantize_params_9_leaves=quant_total),
    ]
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
