"""Continuous-batching serving of the seeded synthetic workload (port
of ``examples/serve.py --continuous``).

    python -m tfmesos_tpu_torch.serve [--tiny] [--device cpu] \\
        [--batch 8] [--n-prompts 24] [--new-tokens 32] [--seed 0] \\
        [--temperature 0.0] [--warmup] [--int8] [--int8-kv]

Prompts of 4..32 random tokens (seeded) go through
:class:`~tfmesos_tpu_torch.serving.ContinuousBatcher` with ``--batch``
concurrent rows; each completion is written as one JSON line
``{"rid", "prompt_len", "tokens"}`` on stdout and a summary goes to
stderr.  Weights are random from ``--seed`` (the flagship
config by default, ``--tiny`` for the CI model).  ``--int8`` serves
weight-only int8 params (``quantize_params``), ``--int8-kv`` keeps the
page pool int8.  ``--temperature`` above 0 samples (the batcher's
per-row threefry keys); ``--warmup`` runs ``ContinuousBatcher.warmup``
before the stream starts (on the card: every decode width's CUDA graph
captured ahead of the first request).  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tfmesos_tpu_torch.serve")
    p.add_argument("--tiny", action="store_true",
                   help="the CI model instead of the flagship")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; cpu runs the plain "
                        "PyTorch path)")
    p.add_argument("--batch", type=int, default=8,
                   help="concurrent decode rows")
    p.add_argument("--n-prompts", type=int, default=24, dest="n_prompts")
    p.add_argument("--new-tokens", type=int, default=32, dest="new_tokens")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--warmup", action="store_true",
                   help="capture every decode width's graph and prefill "
                        "every prompt width before the stream starts "
                        "(ContinuousBatcher.warmup)")
    p.add_argument("--int8", action="store_true",
                   help="serve weight-only int8 params (quantize_params)")
    p.add_argument("--int8-kv", action="store_true", dest="int8_kv",
                   help="store the page pool as int8 (per-position absmax)")
    args = p.parse_args(argv)

    import numpy as np

    from tfmesos_tpu_torch.device import resolve_device
    from tfmesos_tpu_torch.models.presets import flagship_model, tiny_model
    from tfmesos_tpu_torch.models.transformer import quantize_params
    from tfmesos_tpu_torch.serving import ContinuousBatcher, Request

    device = resolve_device(args.device)
    cfg, params = (tiny_model(args.seed, device=device) if args.tiny
                   else flagship_model(args.seed, device=device))
    if args.int8:
        params = quantize_params(cfg, params)
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(4, 33))
               for _ in range(args.n_prompts)]
    batcher = ContinuousBatcher(cfg, params, rows=args.batch, page_size=64,
                                prefill_bucket=64,
                                temperature=args.temperature,
                                quantized_cache=args.int8_kv, device=device)
    reqs = [Request(prompt=t, max_new_tokens=args.new_tokens)
            for t in prompts]
    for r in reqs:
        try:
            batcher.validate(r)
        except ValueError as e:
            print(f"serve: {e}", file=sys.stderr)
            return 1
    if args.warmup:
        info = batcher.warmup()
        print(f"warmed {len(info['compiled'])} entry points in "
              f"{info['seconds']:.1f}s", file=sys.stderr)
    served = 0
    t0 = time.perf_counter()
    for c in batcher.run(reqs):
        print(json.dumps({"rid": c.rid,
                          "prompt_len": int(c.request.prompt.size),
                          "tokens": c.tokens}), flush=True)
        served += 1
    dt = time.perf_counter() - t0
    print(f"served {served} prompts continuously in {dt:.2f}s on "
          f"{device} (peak pages {batcher.peak_pages_used}/"
          f"{batcher.n_pages}, {batcher.decode_ticks} decode ticks)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
