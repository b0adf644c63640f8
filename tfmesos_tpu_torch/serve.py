"""Continuous-batching serving of the seeded synthetic workload (port
of ``examples/serve.py --continuous``).

    python -m tfmesos_tpu_torch.serve [--tiny] [--device cpu] \\
        [--batch 8] [--n-prompts 24] [--new-tokens 32] [--seed 0] \\
        [--temperature 0.0] [--warmup] [--int8] [--int8-kv] \\
        [--prefill-chunk N] [--prefix-cache-pages N] [--multi-step K] \\
        [--overlap] [--pipeline-depth {0,1}] [--fused-prefill] \\
        [--tokens-per-tick N] [--speculative] [--int8-draft-kv] \\
        [--prefix-len N] [--prompt-len LO,HI] [--max-len N] \\
        [--continuous] [--mesh dp=2,tp=2] [--stats]
    python -m tfmesos_tpu_torch.cli run -w 2 -s 0 -- \\
        python -m tfmesos_tpu_torch.serve --continuous --mesh tp=2

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
every row maps read-only).  ``--prompt-len LO,HI`` draws the prompt
lengths first, uniform in [LO, HI], then each prompt's tokens (the
traffic of ``chip_smoke.py``'s phase 5 at ``--n-prompts 16
--prompt-len 8,700``); ``--max-len`` caps the model's positions.
``--continuous`` names the JAX example's mode (the port's only one).
Runs on the card unless ``--device cpu``.

``--mesh`` (e.g. ``tp=2`` or ``dp=2,tp=2``) serves over a data x tp
mesh of ranks (``ContinuousBatcher(mesh=)``): run it under ``tfrun``
(``cli run -w N``) or Mode A, one process a rank.  Every rank serves
the same requests; rank 0 prints the completions and the summary, and
every rank all-gathers a digest of its streams and exits 1 unless they
equal rank 0's (the JAX ``fleet/gang.py`` ``token_digest`` check).
``--stats`` prints one ``stats {...}`` JSON line on every rank: the
kernel launches of the serving run (counted from 0 at its start), the
prefills this rank ran, the decode ticks, ms a tick, why graphs are
bypassed, and each data shard's free pages at the end.
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
    p.add_argument("--prompt-len", type=str, default=None,
                   dest="prompt_len",
                   help="LO,HI: prompt lengths uniform in [LO, HI], drawn "
                        "before the prompts (default: 4..32 per prompt)")
    p.add_argument("--max-len", type=int, default=None, dest="max_len",
                   help="the model's max_seq_len (default: the preset's)")
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching (the JAX example's flag; the "
                        "port's only mode)")
    p.add_argument("--stats", action="store_true",
                   help="print one 'stats {json}' line on every rank "
                        "(launches, prefills, ticks, free pages)")
    p.add_argument("--mesh", type=str, default=None,
                   help="serve over a data x tp mesh of ranks, e.g. tp=2 "
                        "or dp=2,tp=2 (run under tfrun or Mode A; --batch "
                        "rows must divide over the data axes)")
    args = p.parse_args(argv)
    if args.fused_prefill and args.prefill_chunk is None:
        p.error("--fused-prefill requires --prefill-chunk")
    if args.int8_draft_kv and not args.speculative:
        p.error("--int8-draft-kv requires --speculative")

    from tfmesos_tpu_torch.device import resolve_device

    if args.mesh is not None:
        from tfmesos_tpu_torch import runtime
        from tfmesos_tpu_torch.cli import parse_mesh

        try:
            axes = parse_mesh(args.mesh)
        except ValueError as e:
            p.error(f"--mesh: {e}")
        ctx = runtime.initialize(device=args.device)
        try:
            return _serve(args, ctx, ctx.mesh(axes), ctx.device)
        finally:
            runtime.shutdown()
    return _serve(args, None, None, resolve_device(args.device))


def _serve(args, ctx, mesh, device) -> int:
    """Serve the workload on ``device`` (over ``mesh``'s ranks when one
    is given, ``ctx`` this rank's context)."""
    import dataclasses

    import numpy as np
    import torch

    from tfmesos_tpu_torch.models.presets import flagship_model, tiny_model
    from tfmesos_tpu_torch.models.transformer import (init_params,
                                                      quantize_params)
    from tfmesos_tpu_torch.serving import ContinuousBatcher, Request

    kw = {} if args.max_len is None else {"max_len": args.max_len}
    cfg, params = (tiny_model(args.seed, device=device) if args.tiny
                   else flagship_model(args.seed, device=device, **kw))
    if args.tiny and args.max_len is not None:
        cfg = dataclasses.replace(cfg, max_seq_len=args.max_len)
    if args.int8:
        params = quantize_params(cfg, params)
    rng = np.random.RandomState(args.seed)
    if args.prompt_len is not None:
        lo, hi = (int(x) for x in args.prompt_len.split(","))
        lens = rng.randint(lo, hi + 1, size=args.n_prompts)
        prompts = [rng.randint(0, cfg.vocab_size, n) for n in lens]
    else:
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
                                mesh=mesh, device=device)
    reqs = [Request(prompt=t, max_new_tokens=args.new_tokens)
            for t in prompts]
    for r in reqs:
        try:
            batcher.validate(r)
        except ValueError as e:
            print(f"serve: {e}", file=sys.stderr)
            return 1
    chief = ctx is None or ctx.is_chief
    if args.warmup:
        info = batcher.warmup()
        if chief:
            print(f"warmed {len(info['compiled'])} entry points in "
                  f"{info['seconds']:.1f}s", file=sys.stderr)
    if batcher.graphs_bypass_reason is not None and chief:
        print(f"graphs bypassed: {batcher.graphs_bypass_reason} (every "
              f"call eager)", file=sys.stderr)
    from tfmesos_tpu_torch import graphs

    served = 0
    streams = {}
    graphs.zero_launches()
    t0 = time.perf_counter()
    for c in batcher.run(reqs):
        streams[c.rid] = c.tokens
        if chief:
            print(json.dumps({"rid": c.rid,
                              "prompt_len": int(c.request.prompt.size),
                              "tokens": c.tokens}), flush=True)
        served += 1
    dt = time.perf_counter() - t0
    if args.stats:
        side = batcher.t_side
        print("stats " + json.dumps({
            "rank": 0 if ctx is None else ctx.rank,
            "launches": graphs.launch_counts(),
            "prefills_here": batcher.prefills_here,
            "prefills": batcher.prefills,
            "decode_ticks": batcher.decode_ticks,
            "ms_per_tick": batcher.decode_seconds
            / max(1, batcher.decode_ticks) * 1e3,
            "graphs_bypass_reason": batcher.graphs_bypass_reason,
            "n_pages_per_shard": side.n_pages // side.n_shards,
            "free_by_shard": [side.shard_alloc(i).free_count()
                              for i in range(side.n_shards)]}),
            flush=True)
    if mesh is not None and mesh.size() > 1:
        bad = streams_differ(mesh, streams, device)
        if bad:
            print(f"serve: rank {ctx.rank}: streams differ from rank(s) "
                  f"{bad}", file=sys.stderr)
            return 1
        if not chief:
            return 0
    fused = (f", {batcher.fused_ticks} fused ticks of "
             f"{batcher.fused_chunk_tokens} chunk and "
             f"{batcher.fused_decode_tokens} decode tokens"
             if args.fused_prefill else "")
    rate = batcher.acceptance_rate
    spec = ("" if rate is None else
            f", {batcher.spec_rounds} speculative rounds, draft "
            f"acceptance {rate:.0%}")
    on_mesh = ("" if mesh is None else
               f", mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    print(f"served {served} prompts continuously in {dt:.2f}s on "
          f"{device} (peak pages {batcher.peak_pages_used}/"
          f"{batcher.n_pages}, {batcher.decode_ticks} decode ticks, "
          f"{batcher.decode_seconds / max(1, batcher.decode_ticks) * 1e3:.3f}"
          f" ms a tick{fused}{spec}{on_mesh})", file=sys.stderr)
    if batcher.prefix_cache_active:
        print(f"prefix cache: {json.dumps(batcher.prefix_cache_stats())}",
              file=sys.stderr)
    return 0


def token_digest(streams) -> bytes:
    """A digest of the streams in rid order (the JAX ``fleet/gang.py``
    ``token_digest``'s role: ranks that must agree compare digests)."""
    import hashlib

    h = hashlib.sha256()
    for rid in sorted(streams):
        h.update(json.dumps([rid, list(map(int, streams[rid]))]).encode())
    return h.digest()


def streams_differ(mesh, streams, device):
    """The ranks whose stream digest is not this rank's, by an
    all-gather of every rank's digest over the whole mesh."""
    import torch

    from tfmesos_tpu_torch.parallel.collectives import all_gather

    mine = torch.tensor(list(token_digest(streams)), dtype=torch.uint8,
                        device=device)
    every = all_gather(mine[None], mesh, mesh.mesh_dim_names, dim=0)
    return [r for r in range(every.shape[0])
            if not torch.equal(every[r], mine)]


if __name__ == "__main__":
    sys.exit(main())
