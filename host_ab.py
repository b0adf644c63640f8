#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch port on one CUDA card: the host
cost of the attention kernels' wrappers and the wall time of a generate
step, which the host's dispatch bounds.

    python3 host_ab.py A_DIR B_DIR [--rounds 20]

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
  pos 300;
* ``generate_ms``: per round, ms a decode step of the flagship's greedy
  generate, prefill excluded (a run of N new tokens less a one-token
  run, over N - 1 steps): int8 weights and cache at batch 8, prompt 128,
  N 64; bf16 over a 16384-slot cache at batch 4, prompt 1024, N 32.

For each metric it prints each tree's median and minimum over the rounds
and the median of the per-round differences B - A, then the card's name
and power limit, and last a JSON line with every round's numbers.
"""

from __future__ import annotations

import argparse
import importlib
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
            "models.presets")}
    finally:
        sys.path.remove(str(root))
    got = Path(pkg.__file__).resolve().parent.parent
    if got != root:
        raise SystemExit(f"imported {PKG} from {got}, not {root}")
    return SimpleNamespace(ta=mods["ops.attention"], tq=mods["ops.quant"],
                           tt=mods["models.transformer"],
                           presets=mods["models.presets"])


def alternate(rounds: int, measure, fns):
    """``measure(fns[label])`` for A and B in every round, the order
    flipping each round; returns {label: [values]}."""
    out = {"A": [], "B": []}
    for r in range(rounds):
        for label in (("A", "B") if r % 2 == 0 else ("B", "A")):
            out[label].append(measure(fns[label]))
    return out


def enqueue_us(torch, fn, n: int = 200) -> float:
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


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
    return calls


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
    return {
        "int8 generate, batch 8": (64, lambda n: p.tt.generate(
            cfg8, qparams, prompt8, n, quantized_cache=True)),
        "bf16 long-context generate, batch 4": (32, lambda n: p.tt.generate(
            cfg, params, prompt, n, cache=cache))}


def build(root: Path) -> subprocess.Popen:
    code = (f"import sys; sys.path.insert(0, {str(root)!r}); "
            f"from {PKG}.kernels import build; build.build()")
    return subprocess.Popen([sys.executable, "-c", code])


def summary(group: str, key: str, vals: dict) -> str:
    diffs = [b - a for a, b in zip(vals["A"], vals["B"])]
    fmt = "{:.1f}" if group == "host_us" else "{:.2f}"
    return (f"{group} {key}: A median {fmt.format(statistics.median(vals['A']))}"
            f" min {fmt.format(min(vals['A']))} | B median "
            f"{fmt.format(statistics.median(vals['B']))} min "
            f"{fmt.format(min(vals['B']))} | B - A per round, median "
            f"{fmt.format(statistics.median(diffs))}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--rounds", type=int, default=20,
                    help="rounds of each wrapper measurement (generate "
                         "runs take a quarter as many)")
    args = ap.parse_args()
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
    results = {"host_us": {}, "generate_ms": {}}
    calls = {label: wrappers(torch, p) for label, p in pkgs.items()}
    for key in calls["A"]:
        fns = {label: calls[label][key] for label in calls}
        for fn in fns.values():
            for _ in range(3):
                fn()
        results["host_us"][key] = alternate(
            args.rounds, lambda fn: enqueue_us(torch, fn), fns)
        print(summary("host_us", key, results["host_us"][key]), flush=True)
    del calls
    with torch.no_grad():
        gens = {label: generators(torch, p) for label, p in pkgs.items()}
        for key in gens["A"]:
            new = gens["A"][key][0]
            fns = {label: gens[label][key][1] for label in gens}
            for fn in fns.values():
                fn(new)                                        # warm-up
            results["generate_ms"][key] = alternate(
                max(2, args.rounds // 4),
                lambda fn: step_ms(torch, fn, new), fns)
            print(summary("generate_ms", key, results["generate_ms"][key]),
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
