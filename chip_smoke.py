#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on an
NVIDIA card.

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
   beside the bound; then, for correctness only, GQA in bf16 and the
   float32 kernels at the tiny preset's head_dim 8 (atol 1e-4);
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
   >= 0.99 to the CPU's.

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

FLASH_O_ATOL = 2e-2
FLASH_LSE_ATOL = 1e-3
PAGED_ATOL = 2e-2
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


def bound(bytes_: float, flops: float):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device(torch):
    need(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    say("[1/9] device")
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
    say(f"[2/9] build: {len(build.sources())} kernels from a clean build "
        f"directory in {secs:.2f} s")
    for log in sorted(build.build_dir().glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {log.stem}: {line.strip()}")
    return secs


def phase_kernels(torch):
    import torch.nn.functional as F

    from tfmesos_tpu_torch.ops import attention as ta

    say("[3/9] kernels vs plain versions (bf16, CUDA-event medians)")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    h, d = 8, 64
    scale = 1.0 / math.sqrt(d)
    flash_rows = []

    def flash_case(b, t, window, draw):
        q, k, v = draw(b, t, h, d), draw(b, t, h, d), draw(b, t, h, d)
        o_k, lse_k = ta.flash_forward(q, k, v, causal=True, window=window)
        o_p, lse_p = ta.flash_attention_reference(q, k, v, causal=True,
                                                  scale=scale, window=window)
        torch.cuda.synchronize()
        err_o = float((o_k.float() - o_p.float()).abs().max())
        err_l = float((lse_k - lse_p).abs().max())
        need(err_o <= FLASH_O_ATOL and err_l <= FLASH_LSE_ATOL,
             f"flash_fwd [{b},{t},{h},{d}] window={window}: o err {err_o} "
             f"lse err {err_l}")
        ms = cuda_ms(torch, lambda: ta.flash_forward(q, k, v, causal=True,
                                                     window=window))
        plain = cuda_ms(torch, lambda: ta.flash_attention_reference(
            q, k, v, causal=True, scale=scale, window=window))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if window is None:
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
            pairs = b * t * (t + 1) // 2
        else:
            allow = ~ta._causal_mask(t, t, 0, window, dev)
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=allow))
            pairs = b * int(allow.sum())
        flops = 4 * pairs * h * d
        bytes_ = 4 * b * t * h * d * 2 + b * h * t * 4
        bms, by = bound(bytes_, flops)
        row = {"shape": [b, t, h, d], "window": window, "max_abs_err": err_o,
               "lse_err": err_l, "ms": ms, "plain_ms": plain,
               "library_ms": lib, "bound_ms": bms, "bound_by": by}
        flash_rows.append(row)
        say(f"  flash_fwd {row['shape']} window={window}: kernel_ms "
            f"{ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} bound_ms "
            f"{bms:.5f} ({by}) o_err {err_o:.2e} lse_err {err_l:.2e}")

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


def phase_backward(torch):
    from tfmesos_tpu_torch.ops import attention as ta

    say("[4/9] backward kernels vs plain versions (CUDA-event medians)")
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
    from tfmesos_tpu_torch.ops import attention as ta
    from tfmesos_tpu_torch.serving import ContinuousBatcher, Request

    say("[5/9] serve: flagship, rows 8, page 64, bucket 64, 16 requests")
    cfg, params = flagship_model(seed=0, max_len=1024)
    batcher = ContinuousBatcher(cfg, params, rows=8, page_size=64,
                                prefill_bucket=64, device="cuda")
    # Warm-up request (cuBLAS handles, kernel library loads) outside the
    # measured run.
    list(batcher.run([Request(np.arange(1, 9), 2)]))
    rng = np.random.RandomState(0)
    lens = rng.randint(8, 701, size=16)
    reqs = [Request(rng.randint(0, cfg.vocab_size, n), 32) for n in lens]
    for key in ta.LAUNCHES:
        ta.LAUNCHES[key] = 0
    batcher.prefills = batcher.decode_ticks = batcher.decode_tokens = 0
    batcher.decode_seconds = 0.0
    t0 = time.perf_counter()
    comps = list(batcher.run(reqs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ta.LAUNCHES)
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


def profile(torch, fn):
    """Run ``fn`` once under torch.profiler: wall ms, device ms, the
    device-busy share (device time over wall time) and the top six
    device kernels by time."""
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
    return {"wall_ms": wall_us / 1e3, "device_ms": dev_us / 1e3,
            "device_busy_share": dev_us / wall_us,
            "top_kernels": [(e.key[:60], e.self_device_time_total / 1e3,
                             e.count) for e in top]}


def phase_teacher_forced(torch, cfg, params, comps):
    from tfmesos_tpu_torch.models.transformer import forward

    say(f"[6/9] teacher-forced check vs float32 CPU forward "
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
    say(f"[7/9] forward [4, 1024] on the card: logits finite, "
        f"{ms:.3f} ms per call")
    return ms


def phase_train(torch):
    from tfmesos_tpu_torch import transformer_train as tr
    from tfmesos_tpu_torch.ops import attention as ta
    from tfmesos_tpu_torch.train.data import token_batches

    args = tr.parse_args([])            # the example's defaults
    say(f"[8/9] train: flagship, B {args.batch_size}, T {args.seq_len}, "
        f"AdamW {args.learning_rate} (weight decay 0.01), weights seeded 0")
    run = tr.setup(args, torch.device("cuda"))
    torch.cuda.reset_peak_memory_stats()
    # Two warm-up steps (cuBLAS handles, the allocator's pools) outside
    # the measured run; their losses still count for the loss check.
    warm = tr.train(run, 2, log=None)
    for key in ta.LAUNCHES:
        ta.LAUNCHES[key] = 0
    out = tr.train(run, TRAIN_STEPS, log=lambda line: say("  " + line))
    launches = dict(ta.LAUNCHES)
    losses = warm["losses"] + out["losses"]
    need(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    need(losses[-1] < losses[0], f"loss did not fall: {losses}")
    L = run.cfg.n_layers
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        need(launches[key] == L * TRAIN_STEPS,
             f"{key} launches {launches[key]} != {L} x {TRAIN_STEPS} steps")
    need(launches["flash_decode_paged"] == 0, "decode kernel in training")
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

    say("[9/9] loss_fn + backward at [1, 1024]: card bf16 vs CPU float32")
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
    bwd_rows, bwd_checks = phase_backward(torch)
    cfg, params, _, comps, stats = phase_serve(torch, np)
    phase_teacher_forced(torch, cfg, params, comps)
    phase_forward(torch)
    train_cfg, train = phase_train(torch)
    phase_train_vs_cpu(torch, train_cfg)

    serve_l, train_l = stats["launches"], train["launches"]

    def entry_of(name, source, replaces, rows, rep):
        r = rows[rep]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": serve_l[name] + train_l[name],
                "launches_by_path": {"serve": serve_l[name],
                                     "train": train_l[name]},
                "max_abs_err": max(x["max_abs_err"] for x in rows),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape": r["shape"],
                "shapes": rows}

    def bwd_entry(name, key, replaces, errs):
        r = bwd_rows[0]                      # the training shape
        return {"name": name, "route": "cuda",
                "source": "tfmesos_tpu_torch/csrc/flash_bwd.cu",
                "replaces": replaces,
                "launches": serve_l[name] + train_l[name],
                "launches_by_path": {"serve": serve_l[name],
                                     "train": train_l[name]},
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
                 "tfmesos_tpu/ops/attention.py:127", flash_rows, 1),
        entry_of("flash_decode_paged",
                 "tfmesos_tpu_torch/csrc/flash_decode_paged.cu",
                 "tfmesos_tpu/ops/attention.py:871", paged_rows, 0),
        bwd_entry("flash_bwd_dq", "dq", "tfmesos_tpu/ops/attention.py:246",
                  ("dq",)),
        bwd_entry("flash_bwd_dkv", "dkv", "tfmesos_tpu/ops/attention.py:302",
                  ("dk", "dv")),
    ]
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
