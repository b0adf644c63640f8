"""Continuous-batching serving of the seeded synthetic workload (port
of ``examples/serve.py --continuous``).

    python -m tfmesos_tpu_torch.serve [--tiny] [--device cpu] \\
        [--batch 8] [--n-prompts 24] [--new-tokens 32] [--seed 0] \\
        [--temperature 0.0] [--warmup] [--int8] [--int8-kv] \\
        [--prefill-chunk N] [--prefix-cache-pages N] [--multi-step K] \\
        [--overlap] [--pipeline-depth {0,1}] [--fused-prefill] \\
        [--tokens-per-tick N] [--speculative] [--int8-draft-kv] \\
        [--prefix-len N]

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
captured ahead of the first request).  ``--prefill-chunk N`` writes
prompts N tokens a tick (chunked prefill); ``--prefix-cache-pages N``
keeps up to N prompt pages resident for later requests sharing a
prefix.  Both are off by default.  The schedule modes (the JAX serving
CLI's flags): ``--multi-step K`` decodes K tokens a dispatch with one
host sync; ``--overlap`` dispatches the next block before syncing the
last; ``--pipeline-depth 1`` keeps the decode carry on the device as
well; ``--fused-prefill`` (with ``--prefill-chunk``) runs the decode
block and up to ``--tokens-per-tick`` tokens of chunk slots in one
dispatch.  Streams are the synchronous batcher's in every mode, but for
the fused tick at more than one chunk slot on the card, where a stream
may first differ at a near-tie (``ContinuousBatcher``'s docstring).
``--speculative`` serves with a half-size draft model (the JAX example's:
half the width, half the layers, the same heads, weights from ``seed +
4``) proposing 4 tokens a round, verified by the target in one chunk;
``--int8-draft-kv`` keeps the draft's page pool int8.  ``--prefix-len
N`` prepends a static shared prefix of N seeded tokens (a system prompt
every row maps read-only).  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

SPEC_N_DRAFT = 4    # draft tokens a speculative round (--speculative)


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
    p.add_argument("--prefill-chunk", type=int, default=None,
                   dest="prefill_chunk",
                   help="chunked prefill: write prompts this many tokens "
                        "a tick (a positive multiple of 8), interleaved "
                        "with the decode ticks")
    p.add_argument("--prefix-cache-pages", type=int, default=0,
                   dest="prefix_cache_pages",
                   help="cross-request prefix cache: keep up to this many "
                        "prompt pages resident (0 = off)")
    p.add_argument("--multi-step", type=int, default=1, dest="multi_step",
                   help="decode K tokens per dispatch (one host sync "
                        "per K tokens)")
    p.add_argument("--overlap", action="store_true",
                   help="dispatch decode block N+1 before syncing "
                        "block N")
    p.add_argument("--pipeline-depth", type=int, default=0, choices=(0, 1),
                   dest="pipeline_depth",
                   help="1 = the decode carry (tokens, positions, steps) "
                        "stays on the device, block N synced one block "
                        "behind")
    p.add_argument("--fused-prefill", action="store_true",
                   dest="fused_prefill",
                   help="with --prefill-chunk: one dispatch a tick for the "
                        "decode block and the prefill chunk slots")
    p.add_argument("--tokens-per-tick", type=int, default=None,
                   dest="tokens_per_tick",
                   help="the fused tick's token budget (default: rows x "
                        "multi-step + one chunk)")
    p.add_argument("--speculative", action="store_true",
                   help=f"speculative decoding: a half-size draft proposes "
                        f"{SPEC_N_DRAFT} tokens a round, the target "
                        f"verifies them in one chunk (greedy streams equal "
                        f"target-only serving on the CPU; on the card a "
                        f"stream may first differ at a near-tie, within "
                        f"a 0.25 logit margin)")
    p.add_argument("--int8-draft-kv", action="store_true",
                   dest="int8_draft_kv",
                   help="store the draft's page pool int8 (with "
                        "--speculative)")
    p.add_argument("--prefix-len", type=int, default=0, dest="prefix_len",
                   help="a static shared prefix of this many seeded tokens "
                        "(0 = none)")
    args = p.parse_args(argv)
    if args.fused_prefill and args.prefill_chunk is None:
        p.error("--fused-prefill requires --prefill-chunk")
    if args.int8_draft_kv and not args.speculative:
        p.error("--int8-draft-kv requires --speculative")

    import numpy as np

    from tfmesos_tpu_torch.device import resolve_device
    from tfmesos_tpu_torch.models.presets import flagship_model, tiny_model
    import dataclasses

    import torch

    from tfmesos_tpu_torch.models.transformer import (init_params,
                                                      quantize_params)
    from tfmesos_tpu_torch.serving import ContinuousBatcher, Request

    device = resolve_device(args.device)
    cfg, params = (tiny_model(args.seed, device=device) if args.tiny
                   else flagship_model(args.seed, device=device))
    if args.int8:
        params = quantize_params(cfg, params)
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(4, 33))
               for _ in range(args.n_prompts)]
    prefix = (np.random.RandomState(args.seed + 5).randint(
        0, cfg.vocab_size, size=args.prefix_len) if args.prefix_len
        else None)
    draft_cfg = draft_params = None
    if args.speculative:
        draft_cfg = dataclasses.replace(
            cfg, d_model=cfg.d_model // 2,
            n_layers=max(1, cfg.n_layers // 2), d_ff=cfg.d_ff // 2,
            max_seq_len=cfg.max_seq_len + SPEC_N_DRAFT + 1)
        draft_params = init_params(
            draft_cfg, torch.Generator().manual_seed(args.seed + 4), device)
    batcher = ContinuousBatcher(cfg, params, rows=args.batch, page_size=64,
                                prefill_bucket=64,
                                temperature=args.temperature,
                                quantized_cache=args.int8_kv,
                                prefill_chunk=args.prefill_chunk,
                                prefix_cache_pages=args.prefix_cache_pages,
                                multi_step=args.multi_step,
                                overlap=args.overlap,
                                pipeline_depth=args.pipeline_depth,
                                fused_prefill=args.fused_prefill,
                                tokens_per_tick=args.tokens_per_tick,
                                prefix=prefix, draft_cfg=draft_cfg,
                                draft_params=draft_params,
                                n_draft=SPEC_N_DRAFT,
                                draft_quantized_cache=args.int8_draft_kv,
                                device=device)
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
    fused = (f", {batcher.fused_ticks} fused ticks of "
             f"{batcher.fused_chunk_tokens} chunk and "
             f"{batcher.fused_decode_tokens} decode tokens"
             if args.fused_prefill else "")
    rate = batcher.acceptance_rate
    spec = ("" if rate is None else
            f", {batcher.spec_rounds} speculative rounds, draft "
            f"acceptance {rate:.0%}")
    print(f"served {served} prompts continuously in {dt:.2f}s on "
          f"{device} (peak pages {batcher.peak_pages_used}/"
          f"{batcher.n_pages}, {batcher.decode_ticks} decode ticks{fused}"
          f"{spec})", file=sys.stderr)
    if batcher.prefix_cache_active:
        print(f"prefix cache: {json.dumps(batcher.prefix_cache_stats())}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
