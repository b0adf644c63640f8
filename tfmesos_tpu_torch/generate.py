"""Autoregressive generation on the flagship transformer with a linear
KV cache (port of ``examples/generate.py``).

    python -m tfmesos_tpu_torch.generate [--tiny] [--device cpu] \\
        [--batch 2] [--prompt-len 32] [--new-tokens 64] [--seed 0] \\
        [--temperature 0.8] [--top-k K] [--top-p P] \\
        [--int8] [--int8-kv] [--ragged] [--speculative]

Prefills a seeded random prompt batch once, then one decode step per
token (:func:`~tfmesos_tpu_torch.models.transformer.generate`; on the
card the step replays a CUDA graph).  Tokens are drawn at
``--temperature`` (0 is greedy) from the ``--top-k`` / ``--top-p``
filtered distribution with the threefry key ``PRNGKey(seed + 2)``, as
the JAX example draws them.
``--int8`` serves weight-only int8 params (``quantize_params``),
``--int8-kv`` stores the KV cache as int8 (per-position absmax); both
together are the full int8 serving configuration.  ``--ragged`` serves
a mixed-length batch (random per-row prompt lengths).  ``--speculative``
decodes through :func:`~tfmesos_tpu_torch.models.transformer.
speculative_generate` with the JAX example's half-size draft (half the
width, half the layers, the same heads, weights from ``seed + 4``)
proposing 4 tokens a round.  Weights are
random from ``--seed`` (untrained: the point is the mechanics and the
tokens/s).  The run is made twice — the first builds the kernels and
warms up — and the second is timed.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tfmesos_tpu_torch.generate")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--prompt-len", type=int, default=32, dest="prompt_len")
    p.add_argument("--new-tokens", type=int, default=64, dest="new_tokens")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--temperature", type=float, default=0.8,
                   help="sampling temperature (0: greedy)")
    p.add_argument("--top-k", type=int, default=None, dest="top_k")
    p.add_argument("--top-p", type=float, default=None, dest="top_p")
    p.add_argument("--tiny", action="store_true",
                   help="a 2-layer float32 model instead of the flagship")
    p.add_argument("--int8", action="store_true",
                   help="serve weight-only int8 params (quantize_params)")
    p.add_argument("--int8-kv", action="store_true", dest="int8_kv",
                   help="store the KV cache as int8 (per-position absmax)")
    p.add_argument("--ragged", action="store_true",
                   help="serve a mixed-length batch: random per-row prompt "
                        "lengths, decoded together")
    p.add_argument("--speculative", action="store_true",
                   help="speculative decoding with a half-size draft model "
                        "(temperature 0: the target's greedy continuation, "
                        "exactly on the CPU; on the card it may first "
                        "differ at a near-tie, within a 0.25 logit "
                        "margin; above 0: rejection-sampled)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; cpu runs the plain "
                        "PyTorch path)")
    args = p.parse_args(argv)

    import torch

    from tfmesos_tpu_torch.device import resolve_device
    import dataclasses

    from tfmesos_tpu_torch.models.transformer import (TransformerConfig,
                                                      generate, init_params,
                                                      quantize_params,
                                                      speculative_generate)
    from tfmesos_tpu_torch.ops.prng import PRNGKey

    device = resolve_device(args.device)
    max_len = args.prompt_len + args.new_tokens
    if args.tiny:
        cfg = TransformerConfig(vocab_size=256, d_model=64, n_layers=2,
                                n_heads=4, d_ff=128, max_seq_len=max_len,
                                dtype=torch.float32)
    else:
        cfg = TransformerConfig(vocab_size=8192, d_model=512, n_layers=8,
                                n_heads=8, d_ff=1408, max_seq_len=max_len,
                                dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         device)
    if args.int8:
        params = quantize_params(cfg, params)
    prompt = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator().manual_seed(args.seed + 1)).to(device)
    prompt_lens = None
    if args.ragged:
        prompt_lens = torch.randint(
            max(1, args.prompt_len // 4), args.prompt_len + 1, (args.batch,),
            generator=torch.Generator().manual_seed(args.seed + 3))
        print("ragged prompt lens:", prompt_lens.tolist())
        prompt_lens = prompt_lens.to(device)

    draft_cfg = draft_params = None
    if args.speculative:
        draft_cfg = dataclasses.replace(
            cfg, d_model=cfg.d_model // 2,
            n_layers=max(1, cfg.n_layers // 2), d_ff=cfg.d_ff // 2)
        draft_params = init_params(
            draft_cfg, torch.Generator().manual_seed(args.seed + 4), device)

    def run():
        with torch.no_grad():
            if args.speculative:
                return speculative_generate(
                    cfg, params, draft_cfg, draft_params, prompt,
                    args.new_tokens, n_draft=4, prompt_lens=prompt_lens,
                    temperature=args.temperature, top_k=args.top_k,
                    top_p=args.top_p, quantized_cache=args.int8_kv,
                    rng=PRNGKey(args.seed + 2, device))
            return generate(cfg, params, prompt, args.new_tokens,
                            rng=PRNGKey(args.seed + 2, device),
                            temperature=args.temperature, top_k=args.top_k,
                            top_p=args.top_p, quantized_cache=args.int8_kv,
                            prompt_lens=prompt_lens)

    run()                                       # build + warm up
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = run().cpu()                           # a real fetch ends the run
    dt = time.perf_counter() - t0
    n = args.batch * args.new_tokens
    print(f"generated {args.batch}x{args.new_tokens} tokens in {dt:.3f}s "
          f"({n / dt:.0f} tok/s incl. prefill) on {device}")
    start = (int(prompt_lens[0]) if prompt_lens is not None
             else args.prompt_len)
    print("sample:", out[0, start:start + 16].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
