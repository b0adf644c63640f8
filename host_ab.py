#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch port on one CUDA card: the host
cost of the attention kernels' wrappers, the wall time of a generate
step or a serving tick, which the host's dispatch bounds, and the wall
time of a training step.

    python3 host_ab.py A_DIR B_DIR [--rounds 20] [--groups host_us,serve_ms]

Each directory is the root of a checkout holding ``tfmesos_tpu_torch``.
Both checkouts' kernels are built first (the two builds in parallel).
Then both packages are imported into this one process, one after the
other under the package's own name (each keeps its own modules, kernel
libraries and classes), and every measurement alternates between them,
round by round (A B, then B A), so that the shared host CPU's drift lands
on both trees alike.  Nothing of JAX is imported.

* ``host_us``: per round, the mean host microseconds one call takes to
  enqueue its work over 200 calls (a device-side sleep ahead of them
  keeps the device from stalling the host): flash_forward at
  [8, 2048, 8, 64] and [1, 512, 8, 64] (bf16, causal), flash_decode bf16
  [4, KV 8, M 16384, 64] at pos 1024 and int8 [8, KV 8, M 384, 64] at
  pos 300, and over 50 calls (each launches several kernels)
  flash_decode_paged at the serving shape (below) and flash_backward
  (delta and both backward kernels) at [8, 2048, 8, 64] causal; and the
  int8 KV-cache write of one decode step as each tree's model calls it:
  one layer's K and V chunks [8, 1, 8, 64] bf16 into the linear cache
  [8, 8, 8, 384, 64] at position 300 (a tree with ``quant.commit_int8``:
  one commit of both, reading the start from the device tensor
  ``decode_step`` builds; else its ``_cache_write`` for K, then V, at a
  python int), and every layer's chunks into the serving pool (below;
  ``_paged_cache_write_all`` once, or once a buffer on stacked chunks);
* ``device_ms``: per round, the mean device ms (CUDA events) of one call
  over 20 back-to-back calls: each backward kernel's wrapper,
  ``flash_bwd_dq`` and ``flash_bwd_dkv``, at [8, 2048, 8, 64] causal
  bf16, flash_decode_paged at the serving shape and the two int8
  cache writes above;
* flash_decode_paged's serving shape is chip_smoke's phase 3: a pool of
  8 layers, rows 8, KV 8, 16 pages of 64 (a scrambled table), head_dim
  64, pos 1..1000, the deferred chunk of t = 1 (bf16 and int8 pools)
  and t = 4 (int8), called as each tree's decode step calls it: where
  the tree's ``flash_decode_paged`` takes ``round_self``, an int8 pool
  gets the raw chunk with it; else the chunk rounded first by the tree's
  own ``models.transformer._quant_dequant``;
* ``generate_ms``: per round, ms a decode step of the flagship's greedy
  generate, prefill excluded (a run of N new tokens less a one-token
  run, over N - 1 steps): int8 weights and cache at batch 8, prompt 128,
  N 64; bf16 over a 16384-slot cache at batch 4, prompt 1024, N 32; and
  the int8 run sampled at temperature 0.8 (key ``PRNGKey(2)``);
* ``serve_ms``: per round, ms a decode tick of the flagship's
  ``ContinuousBatcher`` (rows 8, page 64, prefill bucket 64) on
  chip_smoke's phase-5 traffic (16 seeded requests, prompts of 8..700
  tokens, 32 new tokens each; ``--serve-requests`` cuts it), the
  batcher's own decode seconds over its decode ticks, bf16 and in the
  full int8 configuration (int8 weights and page pool), and bf16
  sampled at temperature 0.8;
* both call each tree's own entry points as a user does
  (``ContinuousBatcher.run``, ``generate``), so a tree that replays CUDA
  graphs is measured graphed and one that runs eagerly, eagerly; a
  sampled variant runs only on a tree whose entry point takes
  ``top_k`` (sampling), and is reported for that tree alone;
* ``train_ms``: per round, ms a step of the flagship's training step
  (``transformer_train``'s setup: B 8, T 2048, AdamW) over 5 steps with
  the batch already on the card, ending in the loss read back.

``--groups`` picks which of host_us, device_ms, generate_ms, serve_ms and
train_ms run (all by default).

For each metric it prints each tree's median and minimum over the rounds
and the median of the per-round differences B - A, then the card's name
and power limit, and last a JSON line with every round's numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

PKG = "tfmesos_tpu_torch"


def load(root: Path) -> SimpleNamespace:
    """Import the port from checkout ``root`` (dropping any other copy
    from ``sys.modules`` first; modules already imported keep working,
    their functions hold their own globals)."""
    for name in [m for m in sys.modules
                 if m == PKG or m.startswith(PKG + ".")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        pkg = importlib.import_module(PKG)
        mods = {n: importlib.import_module(f"{PKG}.{n}") for n in (
            "ops.attention", "ops.quant", "models.transformer",
            "models.presets", "serving", "transformer_train", "train.data",
            "train.optim", "train.trainer", "device")}
    finally:
        sys.path.remove(str(root))
    got = Path(pkg.__file__).resolve().parent.parent
    if got != root:
        raise SystemExit(f"imported {PKG} from {got}, not {root}")
    return SimpleNamespace(ta=mods["ops.attention"], tq=mods["ops.quant"],
                           tt=mods["models.transformer"],
                           presets=mods["models.presets"],
                           serving=mods["serving"],
                           tr=mods["transformer_train"], modules=_own())


def _own() -> dict:
    return {m: mod for m, mod in sys.modules.items()
            if m == PKG or m.startswith(PKG + ".")}


@contextlib.contextmanager
def active(p: SimpleNamespace):
    """``sys.modules`` holding tree ``p``'s package while the block runs,
    so that imports inside its functions (``transformer_train.setup``
    imports lazily) resolve to the same tree."""
    saved = _own()
    for m in saved:
        del sys.modules[m]
    sys.modules.update(p.modules)
    try:
        yield
    finally:
        for m in _own():
            del sys.modules[m]
        sys.modules.update(saved)


def alternate(rounds: int, measure, fns):
    """``measure(fns[label])`` for A and B (those of the two that ``fns``
    holds) in every round, the order flipping each round; returns
    {label: [values]}."""
    out = {label: [] for label in ("A", "B") if label in fns}
    for r in range(rounds):
        for label in (("A", "B") if r % 2 == 0 else ("B", "A")):
            if label in fns:
                out[label].append(measure(fns[label]))
    return out


def samples(p: SimpleNamespace) -> bool:
    """Whether tree ``p``'s entry points take sampling arguments."""
    return "top_k" in inspect.signature(p.tt.generate).parameters


def enqueue_us(torch, fn, n: int = 200) -> float:
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def device_ms(torch, fn, n: int = 20) -> float:
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)      # the host enqueues all n calls first
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def step_ms(torch, run, new: int) -> float:
    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return (timed(new) - timed(1)) / (new - 1) * 1e3


def wrappers(torch, p: SimpleNamespace) -> dict:
    """The timed wrapper calls of one tree, on inputs from seed 0."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    def lane_int8(cache):
        vals, scales = p.tq.quantize_int8_reference(cache)
        return p.tq.QTensor(vals,
                            scales.squeeze(-1).unsqueeze(-2).contiguous())

    calls = {}
    for b, t in ((8, 2048), (1, 512)):
        q, k, v = randn(b, t, 8, 64), randn(b, t, 8, 64), randn(b, t, 8, 64)
        calls[f"flash_forward [{b},{t},8,64]"] = (
            lambda q=q, k=k, v=v: p.ta.flash_forward(q, k, v, causal=True))
    for name, b, m, pos, int8 in (
            ("bf16 [4,KV8,M16384,64]", 4, 16384, 1024, False),
            ("int8 [8,KV8,M384,64]", 8, 384, 300, True)):
        q = randn(b, 1, 8, 64)
        kc, vc = randn(2, b, 8, m, 64), randn(2, b, 8, m, 64)
        if int8:
            kc, vc = lane_int8(kc), lane_int8(vc)
        posv = torch.full((b,), pos, dtype=torch.int32, device=dev)
        calls[f"flash_decode {name}"] = (
            lambda q=q, kc=kc, vc=vc, posv=posv: p.ta.flash_decode(
                q, kc, vc, posv, layer=1))
    calls.update(paged_calls(torch, p))
    calls.update(commit_calls(torch, p))
    q, k, v, do = (randn(8, 2048, 8, 64) for _ in range(4))
    o, lse = p.ta.flash_forward(q, k, v, causal=True)
    calls["flash_backward [8,2048,8,64]"] = (
        lambda: p.ta.flash_backward(q, k, v, o, lse, do, causal=True))
    return calls


def paged_calls(torch, p: SimpleNamespace) -> dict:
    """flash_decode_paged of one tree at the serving shape (inputs from
    seed 1), as the tree's decode step calls it."""
    import inspect

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    def lane_int8(cache):
        vals, scales = p.tq.quantize_int8_reference(cache)
        return p.tq.QTensor(vals,
                            scales.squeeze(-1).unsqueeze(-2).contiguous())

    raw = "round_self" in inspect.signature(
        p.ta.flash_decode_paged).parameters
    calls = {}
    for name, t, int8 in (("bf16 t=1", 1, False), ("int8 t=1", 1, True),
                          ("int8 t=4", 4, True)):
        kp, vp = randn(8, 129, 8, 64, 64), randn(8, 129, 8, 64, 64)
        if int8:
            kp, vp = lane_int8(kp), lane_int8(vp)
        table = (torch.randperm(128, generator=gen) + 1).reshape(8, 16).to(
            dev, torch.int32)
        pos = torch.randint(1, 1001, (8,), generator=gen).clamp(
            max=1024 - t).to(dev, torch.int32)
        q = randn(8, t, 8, 64)
        chunk = (randn(8, t, 8, 64), randn(8, t, 8, 64))
        if int8 and raw:
            def call(q=q, kp=kp, vp=vp, table=table, pos=pos, chunk=chunk):
                return p.ta.flash_decode_paged(q, kp, vp, table, pos,
                                               layer=3, self_kv=chunk,
                                               round_self=True)
        elif int8:
            def call(q=q, kp=kp, vp=vp, table=table, pos=pos, chunk=chunk):
                return p.ta.flash_decode_paged(
                    q, kp, vp, table, pos, layer=3, self_kv=tuple(
                        p.tt._quant_dequant(c, torch.bfloat16)
                        for c in chunk))
        else:
            def call(q=q, kp=kp, vp=vp, table=table, pos=pos, chunk=chunk):
                return p.ta.flash_decode_paged(q, kp, vp, table, pos,
                                               layer=3, self_kv=chunk)
        calls[f"flash_decode_paged {name}"] = call
    return calls


def commit_calls(torch, p: SimpleNamespace) -> dict:
    """One decode step's int8 KV-cache writes of one tree (inputs from
    seed 2), as the tree's model makes them: a linear cache's layer 3
    (int8 generate's [8, 8, 8, 384, 64] at position 300), and the
    serving pool's commit of every layer (8 layers, rows 8, KV 8, 129
    pages of 64, a scrambled table, ragged positions)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    def lane_int8(cache):
        vals, scales = p.tq.quantize_int8_reference(cache)
        return p.tq.QTensor(vals,
                            scales.squeeze(-1).unsqueeze(-2).contiguous())

    kc, vc = lane_int8(randn(8, 8, 8, 384, 64)), lane_int8(
        randn(8, 8, 8, 384, 64))
    k, v = randn(8, 1, 8, 64), randn(8, 1, 8, 64)
    # decode_step's positions at a python-int pos, and its row starts.
    start = (300 + torch.arange(1, device=dev)).expand(8, 1)[:, 0]
    kp, vp = lane_int8(randn(8, 129, 8, 64, 64)), lane_int8(
        randn(8, 129, 8, 64, 64))
    ks = [randn(8, 1, 8, 64) for _ in range(8)]
    vs = [randn(8, 1, 8, 64) for _ in range(8)]
    table = (torch.randperm(128, generator=gen) + 1).reshape(8, 16).to(
        dev, torch.int32)
    pos = torch.randint(0, 1024, (8,), generator=gen).to(dev)
    if hasattr(p.tq, "commit_int8"):
        def linear():
            p.tt._cache_write({"k": kc, "v": vc}, k, v, 3, 300, start)

        def paged():
            p.tt._paged_cache_write_all({"k": kp, "v": vp, "pages": table},
                                        ks, vs, pos)
    else:
        def linear():
            p.tt._cache_write(kc, k, 3, 300)
            p.tt._cache_write(vc, v, 3, 300)

        def paged():
            p.tt._paged_cache_write_all(kp, torch.stack(ks), table, pos)
            p.tt._paged_cache_write_all(vp, torch.stack(vs), table, pos)
    return {"int8 cache write, linear, a layer [8,1,8,64]": linear,
            "int8 cache write, paged, 8 layers [8,1,8,64]": paged}


def device_calls(torch, p: SimpleNamespace) -> dict:
    """The device-timed calls of one tree: the two backward kernels'
    wrappers at [8, 2048, 8, 64] causal bf16 (inputs from seed 0),
    flash_decode_paged at the serving shape and the int8 cache
    writes."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((8, 2048, 8, 64), generator=gen).to(
        "cuda", torch.bfloat16) for _ in range(4))
    o, lse = p.ta.flash_forward(q, k, v, causal=True)
    args = (q, k, v, do, lse, p.ta._bwd_delta(o, do), True, 0.125)
    return {"flash_bwd_dq [8,2048,8,64]": lambda: p.ta.flash_bwd_dq(*args),
            "flash_bwd_dkv [8,2048,8,64]": lambda: p.ta.flash_bwd_dkv(*args),
            **paged_calls(torch, p), **commit_calls(torch, p)}


def servers(torch, np, p: SimpleNamespace, n_requests: int) -> dict:
    """One tree's batchers (flagship weights from seed 0; bf16, and int8
    weights over an int8 pool) and ``run()``, which serves chip_smoke's
    phase-5 requests (the first ``n_requests``) and returns ms a decode
    tick."""
    cfg, params = p.presets.flagship_model(seed=0, max_len=1024,
                                           device="cuda")
    rng = np.random.RandomState(0)
    lens = rng.randint(8, 701, size=16)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in lens][:n_requests]
    Request = p.serving.Request
    out = {}
    runs = [("bf16", params, False, {}),
            ("int8", p.tt.quantize_params(cfg, params), True, {})]
    if samples(p):
        runs.append(("bf16 sampled T 0.8", params, False,
                     {"temperature": 0.8}))
    for name, weights, int8, sampling in runs:
        batcher = p.serving.ContinuousBatcher(
            cfg, weights, rows=8, page_size=64, prefill_bucket=64,
            quantized_cache=int8, device="cuda", **sampling)

        def run(batcher=batcher):
            batcher.decode_ticks = 0
            batcher.decode_seconds = 0.0
            list(batcher.run([Request(x, 32) for x in prompts]))
            return batcher.decode_seconds / batcher.decode_ticks * 1e3

        out[f"serve {name}, ms a tick ({len(prompts)} requests)"] = run
    return out


def generators(torch, p: SimpleNamespace) -> dict:
    """The two generate runs of one tree: ``run(n)`` generates n new
    tokens (weights from seed 0, prompts from seeds 4 and 5)."""
    cfg8, params = p.presets.flagship_model(seed=0, max_len=128 + 64,
                                            device="cuda")
    qparams = p.tt.quantize_params(cfg8, params)
    prompt8 = torch.randint(0, cfg8.vocab_size, (8, 128),
                            generator=torch.Generator().manual_seed(4)).cuda()
    cfg, params = p.presets.flagship_model(seed=0, max_len=16384,
                                           device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (4, 1024),
                           generator=torch.Generator().manual_seed(5)).cuda()
    cache = p.tt.init_cache(cfg, 4, 16384, device="cuda")
    out = {
        "int8 generate, batch 8": (64, lambda n: p.tt.generate(
            cfg8, qparams, prompt8, n, quantized_cache=True)),
        "bf16 long-context generate, batch 4": (32, lambda n: p.tt.generate(
            cfg, params, prompt, n, cache=cache))}
    if samples(p):
        key = p.modules[f"{PKG}.ops.prng"].PRNGKey(2, "cuda")
        out["int8 generate sampled T 0.8, batch 8"] = (
            64, lambda n: p.tt.generate(cfg8, qparams, prompt8, n, rng=key,
                                        temperature=0.8,
                                        quantized_cache=True))
    return out


def trainer(torch, p: SimpleNamespace):
    """One tree's training step on a fixed batch already on the card
    (``transformer_train``'s setup: weights seeded 0, the first batch of
    its stream)."""
    with active(p):
        run = p.tr.setup(p.tr.parse_args([]), torch.device("cuda"))
    batch = {"tokens": torch.from_numpy(next(run.batches)["tokens"]).cuda()}

    def step():
        run.params, run.opt_state, m = run.step(run.params, run.opt_state,
                                                batch)
        return m

    return step


def train_ms(torch, step, n: int = 5) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        m = step()
    float(m["loss"])
    return (time.perf_counter() - t0) / n * 1e3


def build(root: Path) -> subprocess.Popen:
    code = (f"import sys; sys.path.insert(0, {str(root)!r}); "
            f"from {PKG}.kernels import build; build.build()")
    return subprocess.Popen([sys.executable, "-c", code])


def summary(group: str, key: str, vals: dict) -> str:
    fmt = {"host_us": "{:.1f}", "device_ms": "{:.4f}"}.get(group, "{:.2f}")
    parts = [f"{label} median {fmt.format(statistics.median(v))} min "
             f"{fmt.format(min(v))}" for label, v in vals.items()]
    if len(vals) == 2:
        diffs = [b - a for a, b in zip(vals["A"], vals["B"])]
        parts.append(f"B - A per round, median "
                     f"{fmt.format(statistics.median(diffs))}")
    else:
        parts.append("the other tree does not sample")
    return f"{group} {key}: " + " | ".join(parts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--rounds", type=int, default=20,
                    help="rounds of each wrapper measurement (generate "
                         "runs and serving take a quarter as many, "
                         "training steps half, at least 4)")
    groups = ("host_us", "device_ms", "generate_ms", "serve_ms", "train_ms")
    ap.add_argument("--groups", default=",".join(groups),
                    help="comma-separated measurements to run")
    ap.add_argument("--serve-requests", type=int, default=16,
                    help="requests of phase 5's traffic each serve_ms "
                         "round serves")
    args = ap.parse_args()
    todo = set(args.groups.split(","))
    if not todo <= set(groups):
        ap.error(f"--groups takes {groups}")
    trees = {"A": args.a.resolve(), "B": args.b.resolve()}
    for tree in trees.values():
        if not (tree / PKG).is_dir():
            ap.error(f"{tree} holds no {PKG}")
    import torch

    if not torch.cuda.is_available():
        print("host_ab: no CUDA device available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    if any(p.wait() != 0 for p in [build(t) for t in trees.values()]):
        print("host_ab: a kernel build failed", file=sys.stderr)
        return 1
    print(f"built both trees in {time.perf_counter() - t0:.1f} s",
          flush=True)
    pkgs = {label: load(tree) for label, tree in trees.items()}
    results = {g: {} for g in groups if g in todo}

    def warmed(fns, n=3):
        for fn in fns.values():
            for _ in range(n):
                fn()
        return fns

    if "host_us" in todo:
        calls = {label: wrappers(torch, p) for label, p in pkgs.items()}
        for key in calls["A"]:
            fns = warmed({label: calls[label][key] for label in calls})
            # A backward call launches five kernels, and a paged call that
            # rounds the chunk in the caller about ten: 50 calls stay
            # inside the card's launch queue, so the host never waits on
            # it.
            n = 50 if key.startswith(("flash_backward", "flash_decode_paged",
                                      "int8 cache write, paged")) else 200
            results["host_us"][key] = alternate(
                args.rounds, lambda fn: enqueue_us(torch, fn, n), fns)
            print(summary("host_us", key, results["host_us"][key]),
                  flush=True)
        del calls
    if "device_ms" in todo:
        calls = {label: device_calls(torch, p) for label, p in pkgs.items()}
        for key in calls["A"]:
            fns = warmed({label: calls[label][key] for label in calls})
            results["device_ms"][key] = alternate(
                args.rounds, lambda fn: device_ms(torch, fn), fns)
            print(summary("device_ms", key, results["device_ms"][key]),
                  flush=True)
        del calls
    with torch.no_grad():
        if "generate_ms" in todo:
            gens = {label: generators(torch, p) for label, p in pkgs.items()}
            for key in dict.fromkeys([*gens["A"], *gens["B"]]):
                fns = {label: gens[label][key][1] for label in gens
                       if key in gens[label]}
                new = next(gens[label][key][0] for label in fns)
                for fn in fns.values():
                    fn(new)                                    # warm-up
                results["generate_ms"][key] = alternate(
                    max(2, args.rounds // 4),
                    lambda fn: step_ms(torch, fn, new), fns)
                print(summary("generate_ms", key,
                              results["generate_ms"][key]), flush=True)
            del gens
        if "serve_ms" in todo:
            import numpy as np

            serves = {label: servers(torch, np, p, args.serve_requests)
                      for label, p in pkgs.items()}
            for key in dict.fromkeys([*serves["A"], *serves["B"]]):
                fns = warmed({label: serves[label][key] for label in serves
                              if key in serves[label]}, 1)
                results["serve_ms"][key] = alternate(
                    max(2, args.rounds // 4), lambda fn: fn(), fns)
                print(summary("serve_ms", key, results["serve_ms"][key]),
                      flush=True)
            del serves
    if "train_ms" in todo:
        steps = {label: trainer(torch, p) for label, p in pkgs.items()}
        for fn in steps.values():
            train_ms(torch, fn, 2)                             # warm-up
        key = "train step, batch ready (B 8, T 2048)"
        results["train_ms"][key] = alternate(
            max(4, args.rounds // 2), lambda fn: train_ms(torch, fn), steps)
        print(summary("train_ms", key, results["train_ms"][key]),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({"A": str(trees["A"]), "B": str(trees["B"]),
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
