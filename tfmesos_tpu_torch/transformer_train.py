"""Train the flagship transformer on one device (port of
``examples/transformer_train.py``'s single-device dense path).

    python -m tfmesos_tpu_torch.transformer_train [--tiny] [--device cpu] \\
        [--steps 50] [--batch_size 8] [--seq_len 2048] \\
        [--learning_rate 3e-4] [--warmup 0] [--lr-schedule constant] \\
        [--grad-clip 0] [--kv-heads N]

The flagship config (vocab 8192, d512, 8 layers, 8 heads, d_ff 1408,
bf16 compute over float32 master weights), weights seeded 0, trains on
the seeded bigram token stream (seed 100) with AdamW (weight decay
0.01), through the fused head + cross entropy and the hand-written
attention kernels on the card.  ``--tiny`` is the CI model (vocab 256,
d64, 2 layers, 4 heads, float32, at most 64 tokens).  Prints
``step N: loss=… ppl=…`` every 10 steps, then the elapsed time and
tokens/sec.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional

DATA_SEED = 100          # the example's stream seed on one device (rank 0)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m tfmesos_tpu_torch.transformer_train")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seq_len", type=int, default=2048)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=0,
                   help="linear LR warmup steps")
    p.add_argument("--lr-schedule", choices=["constant", "cosine"],
                   default="constant", dest="lr_schedule",
                   help="decay after warmup: constant or cosine to 10%% "
                        "of peak over --steps")
    p.add_argument("--grad-clip", type=float, default=0.0, dest="grad_clip",
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--kv-heads", type=int, default=None, dest="kv_heads",
                   help="grouped-query attention: share each K/V head "
                        "across n_heads/kv_heads query heads")
    p.add_argument("--tiny", action="store_true",
                   help="the CI model instead of the flagship")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; cpu runs the plain "
                        "PyTorch path)")
    return p.parse_args(argv)


@dataclass
class Run:
    """Everything one training run needs, built by :func:`setup`."""

    cfg: Any
    params: Dict
    opt_state: Any
    step: Callable
    batches: Iterator           # numpy {"tokens": [B, T+1]} stream
    device: Any
    batch_size: int
    seq_len: int


def setup(args: argparse.Namespace, device) -> Run:
    """Config, seeded weights on ``device``, the optimizer and its
    state, the train step and the token stream — as the example builds
    them."""
    import torch

    from tfmesos_tpu_torch.models import transformer
    from tfmesos_tpu_torch.train import data, optim
    from tfmesos_tpu_torch.train.trainer import make_train_step

    if args.tiny:
        cfg = transformer.TransformerConfig(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
            max_seq_len=args.seq_len, dtype=torch.float32,
            n_kv_heads=args.kv_heads)
        seq_len = min(args.seq_len, 64)
    else:
        cfg = transformer.TransformerConfig(
            vocab_size=8192, d_model=512, n_layers=8, n_heads=8, d_ff=1408,
            max_seq_len=args.seq_len, dtype=torch.bfloat16,
            n_kv_heads=args.kv_heads)
        seq_len = args.seq_len
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device)
    if args.lr_schedule == "cosine" or args.warmup:
        # warmup=0 starts at peak; the cosine window is at least 1 step.
        lr = optim.warmup_cosine_decay_schedule(
            init_value=0.0 if args.warmup else args.learning_rate,
            peak_value=args.learning_rate, warmup_steps=args.warmup,
            decay_steps=max(args.steps, args.warmup + 1),
            end_value=(args.learning_rate * 0.1
                       if args.lr_schedule == "cosine"
                       else args.learning_rate))
    else:
        lr = args.learning_rate
    opt = optim.adamw(lr, weight_decay=0.01, max_norm=args.grad_clip)
    step = make_train_step(
        lambda p_, b_: transformer.loss_fn(cfg, p_, b_), opt)
    batches = data.token_batches(args.batch_size, seq_len, cfg.vocab_size,
                                 seed=DATA_SEED)
    return Run(cfg, params, opt.init(params), step, batches, device,
               args.batch_size, seq_len)


def train(run: Run, steps: int,
          log: Optional[Callable[[str], None]] = print) -> Dict[str, Any]:
    """Run ``steps`` train steps with the batches prefetched onto the
    device; ``log`` gets a ``step N`` line every 10 steps (each one a
    host sync, as in the example).  Returns the elapsed seconds (from
    the first step to the last loss on the host), tokens/sec and every
    step's loss as a float."""
    import torch

    from tfmesos_tpu_torch.train.data import prefetch

    gen = prefetch(run.batches, run.device)
    losses: List[Any] = []
    t0 = time.perf_counter()
    for i in range(steps):
        run.params, run.opt_state, metrics = run.step(
            run.params, run.opt_state, next(gen))
        losses.append(metrics["loss"])
        if log is not None and (i + 1) % 10 == 0:
            log(f"step {i + 1}: loss={float(metrics['loss']):.4f} "
                f"ppl={float(metrics['perplexity']):.2f}")
    losses = torch.stack(losses).tolist() if losses else []  # drains it
    dt = time.perf_counter() - t0
    return {"elapsed_s": dt, "losses": losses,
            "tokens_per_s": steps * run.batch_size * run.seq_len / dt}


def main(argv=None) -> int:
    args = parse_args(argv)
    from tfmesos_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    run = setup(args, device)
    print(f"transformer: device={device} seq={run.seq_len} "
          f"batch={run.batch_size}", flush=True)
    out = train(run, args.steps, log=lambda s: print(s, flush=True))
    print(f"Training elapsed time: {out['elapsed_s']:f} s", flush=True)
    print(f"tokens/sec: {out['tokens_per_s']:.0f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
