"""Train the flagship transformer, on one device or data parallel over
the ranks of a cluster (port of ``examples/transformer_train.py``'s
dense path and its runtime half).

    python -m tfmesos_tpu_torch.transformer_train [--tiny] [--device cpu] \\
        [--steps 50] [--batch_size 8] [--seq_len 2048] \\
        [--learning_rate 3e-4] [--warmup 0] [--lr-schedule constant] \\
        [--grad-clip 0] [--kv-heads N] [--data FILE [--data-dtype uint16]] \\
        [--ckpt-dir DIR [--ckpt-every 50]] [--mesh dp=-1]
    python -m tfmesos_tpu_torch.cli run -w 2 -s 0 --mesh dp=-1 -- \\
        python -m tfmesos_tpu_torch.transformer_train --steps 100
    python -m tfmesos_tpu_torch.cli run -w 4 -s 0 -- \\
        python -m tfmesos_tpu_torch.transformer_train --mesh dp=2,tp=2

The flagship config (vocab 8192, d512, 8 layers, 8 heads, d_ff 1408,
bf16 compute over float32 master weights), weights seeded 0, trains on
the seeded bigram token stream (seed 100) with AdamW (weight decay
0.01), through the fused head + cross entropy and the hand-written
attention kernels on the card.  ``--tiny`` is the CI model (vocab 256,
d64, 2 layers, 4 heads, float32, at most 64 tokens).  ``--data`` reads
a flat token file (``TokenFileDataset``) instead, refusing ids beyond
the vocab.  ``--ckpt-dir`` saves params, optimizer state and step every
``--ckpt-every`` steps (asynchronously, and at the last step), and a
run started again with the same directory resumes from its latest step,
the data stream included.

It joins the cluster's process group first (``runtime.initialize``:
the env contract of a ``tfrun`` task; one rank when started by hand).
``--batch_size`` is the global batch: each data shard of the mesh
(``--mesh``, default the cluster's, else all ``dp``) trains on
``batch_size // data shards`` rows of its own stream (seed 100 + its
data index; a token file's strided windows), the tp ranks of a shard
on the same rows, and the gradients are averaged over the data axes.
With ``tp`` or ``fsdp`` in the mesh each rank holds only its blocks of
the params and of the AdamW state (``partition_specs``: Megatron tp,
fsdp gathered a layer at a time), the loss is vocab parallel under tp,
and a checkpoint gathers the blocks for rank 0 to write (every rank
restores its blocks).  Only rank 0 saves checkpoints.  Rank
0 prints ``step N: loss=… ppl=…`` every 10 steps, then the elapsed time
and the global tokens/sec; every rank then prints its steps' losses
(``rank R/W step losses: [...]``: equal across ranks, the mean over
the mesh).  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional

DATA_SEED = 100          # the example's stream seed of rank 0 (rank r: +r)


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
    p.add_argument("--data", type=str, default=None,
                   help="path to a flat token file (TokenFileDataset "
                        "format); default: the synthetic bigram stream")
    p.add_argument("--data-dtype", type=str, default="uint16",
                   dest="data_dtype", choices=["uint16", "uint32"])
    p.add_argument("--tiny", action="store_true",
                   help="the CI model instead of the flagship")
    p.add_argument("--ckpt-dir", type=str, default=None, dest="ckpt_dir",
                   help="checkpoint directory; restarting with the same "
                        "dir resumes from the latest step (params, "
                        "optimizer state AND the data stream position)")
    p.add_argument("--ckpt-every", type=int, default=50, dest="ckpt_every")
    p.add_argument("--mesh", type=str, default=None,
                   help="mesh axes, e.g. dp=-1, fsdp=2, tp=2 or "
                        "dp=2,tp=2 (default: the cluster's, else all dp)")
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
    batches: Optional[Iterator]  # numpy {"tokens": [B, T+1]} stream
    device: Any
    batch_size: int              # this rank's share of the global batch
    seq_len: int
    world_size: int = 1          # data shards (ranks of distinct rows)
    specs: Optional[Dict] = None  # partition specs of cut params


def local_batch(args: argparse.Namespace, world_size: int) -> int:
    """This rank's rows of the global ``--batch_size``."""
    return max(1, args.batch_size // max(1, world_size))


def data_shard(mesh, rank: int, world_size: int):
    """(this rank's data index, the data shards) of ``mesh``: the rank
    and world without one."""
    if mesh is None or mesh.size() == 1:
        return rank, world_size
    axes = ("dp", "fsdp")
    return mesh.coord(axes), mesh.axis_size(axes)


def setup(args: argparse.Namespace, device, start_step: Optional[int] = 0,
          rank: int = 0, world_size: int = 1, mesh=None) -> Run:
    """Config, seeded weights on ``device`` (this rank's blocks where
    the mesh has tp or fsdp), the optimizer and its state, the train
    step over ``mesh`` and this data shard's token stream from
    ``start_step`` (none when it is None: :func:`data_stream` makes it
    later) — as the example builds them."""
    import torch

    from tfmesos_tpu_torch.models import transformer
    from tfmesos_tpu_torch.parallel.sharding import place_tree
    from tfmesos_tpu_torch.train import optim
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
    on_mesh = mesh if mesh is not None and mesh.size() > 1 else None
    specs = None
    if on_mesh is not None and (mesh.axis_size("tp") > 1
                                or mesh.axis_size("fsdp") > 1):
        specs = transformer.partition_specs(cfg, mesh)
        params = place_tree(mesh, params, specs)
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
        lambda p_, b_: transformer.loss_fn(cfg, p_, b_, mesh=on_mesh), opt,
        mesh=mesh, param_specs=specs)
    index, shards = data_shard(mesh, rank, world_size)
    batches = (None if start_step is None
               else data_stream(args, cfg, seq_len, start_step, index,
                                shards))
    return Run(cfg, params, opt.init(params), step, batches, device,
               local_batch(args, shards), seq_len, shards, specs)


def data_stream(args: argparse.Namespace, cfg, seq_len: int,
                start_step: int = 0, rank: int = 0,
                world_size: int = 1) -> Iterator:
    """Rank ``rank``'s stream from ``start_step``, its share of the
    global batch a step: the token file of ``--data`` (after one full
    scan refusing ids >= the vocab, which the embedding gather cannot
    take), else the seeded bigram stream, seeded ``DATA_SEED + rank``."""
    from tfmesos_tpu_torch.train import data

    bs = local_batch(args, world_size)
    if not args.data:
        return data.token_batches(bs, seq_len, cfg.vocab_size,
                                  seed=DATA_SEED + rank,
                                  start_step=start_step)
    ds = data.TokenFileDataset(args.data, dtype=args.data_dtype)
    top = int(ds.tokens.max())
    if top >= cfg.vocab_size:
        raise SystemExit(f"{args.data}: token id {top} >= model vocab "
                         f"{cfg.vocab_size}; re-tokenize or adjust the "
                         f"config")
    return ds.batches(bs, seq_len, rank=rank, world_size=max(1, world_size),
                      seed=DATA_SEED + rank, start_step=start_step)


def train(run: Run, steps: int,
          log: Optional[Callable[[str], None]] = print, start_step: int = 0,
          ckpt=None, ckpt_every: int = 0) -> Dict[str, Any]:
    """Run steps ``start_step + 1 .. steps`` with the batches prefetched
    onto the device; ``log`` gets a ``step N`` line every 10 global
    steps (each one a host sync, as in the example).  With ``ckpt`` (a
    ``CheckpointManager``), ``(params, opt_state)`` is saved without
    waiting every ``ckpt_every`` global steps.  Returns the elapsed
    seconds (from the first step to the last loss on the host), the
    global batch's tokens/sec and every step's loss as a float."""
    import torch

    from tfmesos_tpu_torch.train.data import prefetch

    gen = prefetch(run.batches, run.device)
    losses: List[Any] = []
    t0 = time.perf_counter()
    for i in range(start_step, steps):
        run.params, run.opt_state, metrics = run.step(
            run.params, run.opt_state, next(gen))
        losses.append(metrics["loss"])
        if log is not None and (i + 1) % 10 == 0:
            log(f"step {i + 1}: loss={float(metrics['loss']):.4f} "
                f"ppl={float(metrics['perplexity']):.2f}")
        if ckpt is not None and (i + 1) % ckpt_every == 0:
            ckpt.save(i + 1, (run.params, run.opt_state), wait=False)
    losses = torch.stack(losses).tolist() if losses else []  # drains it
    dt = time.perf_counter() - t0
    n = max(0, steps - start_step)
    return {"elapsed_s": dt, "losses": losses,
            "tokens_per_s": (n * run.batch_size * run.world_size
                             * run.seq_len / dt)}


# The state a Mode-A process carries from one chunk to the next.
_CHUNK: Dict[str, Any] = {}


def train_chunk(ctx, argv: List[str], ckpt_dir: str, start: int,
                steps: int) -> Dict[str, Any]:
    """The trainer under Mode A: dispatched to every rank
    (``cluster.run_all``), it trains steps ``start + 1 .. start + steps``
    of the run ``argv`` describes (this module's flags; ``--device`` is
    the one ``runtime.initialize`` bound), data parallel over the
    cluster's mesh, and rank 0 then saves the state at ``start + steps``
    to ``ckpt_dir`` (synchronously: the checkpoint exists once every
    rank replied).  A process that ended its last chunk at ``start``
    goes on from the state it holds; any other (a re-formed gang's)
    restores ``ckpt_dir``'s step ``start``, or starts fresh at 0.
    Returns this rank's losses, its pid, seconds and the kernel
    launches of the chunk."""
    import os

    from tfmesos_tpu_torch.cli import parse_mesh
    from tfmesos_tpu_torch.ops import attention, quant
    from tfmesos_tpu_torch.train.checkpoint import CheckpointManager

    args = parse_args(argv)
    key = (tuple(argv), os.path.abspath(ckpt_dir))
    run = _CHUNK.get("run")
    mesh = ctx.mesh(parse_mesh(args.mesh))
    if _CHUNK.get("key") != key or _CHUNK.get("step") != start:
        _CHUNK.clear()
        run = setup(args, ctx.device, start_step=None, rank=ctx.rank,
                    world_size=ctx.world_size, mesh=mesh)
        if start:
            CheckpointManager(ckpt_dir, mesh=mesh,
                              param_specs=run.specs).restore(
                (run.params, run.opt_state), step=start)
    index, shards = data_shard(mesh, ctx.rank, ctx.world_size)
    run.batches = data_stream(args, run.cfg, run.seq_len, start, index,
                              shards)
    before = {**attention.LAUNCHES, **quant.LAUNCHES}
    out = train(run, start + steps, log=None, start_step=start)
    after = {**attention.LAUNCHES, **quant.LAUNCHES}
    if ctx.is_chief or run.specs is not None:
        ckpt = CheckpointManager(ckpt_dir, mesh=mesh, param_specs=run.specs)
        ckpt.save(start + steps, (run.params, run.opt_state))
        ckpt.close()
    _CHUNK.update(key=key, step=start + steps, run=run)
    return {"rank": ctx.rank, "pid": os.getpid(), "step": start + steps,
            "losses": out["losses"], "elapsed_s": out["elapsed_s"],
            "launches": {k: after[k] - before.get(k, 0) for k in after}}


def main(argv=None) -> int:
    args = parse_args(argv)
    from tfmesos_tpu_torch import runtime
    from tfmesos_tpu_torch.cli import parse_mesh

    try:
        axes = parse_mesh(args.mesh)
    except ValueError as e:
        raise SystemExit(f"--mesh: {e}")
    ctx = runtime.initialize(device=args.device)
    try:
        mesh = ctx.mesh(axes)
    except ValueError as e:
        raise SystemExit(f"--mesh: {e}")
    device, chief = ctx.device, ctx.is_chief
    run = setup(args, device, start_step=None, rank=ctx.rank,
                world_size=ctx.world_size, mesh=mesh)
    if chief:
        print(f"transformer: device={device} seq={run.seq_len} "
              f"batch={run.batch_size * run.world_size} "
              f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}",
              flush=True)
    start_step, ckpt = 0, None
    if args.ckpt_dir:
        if args.ckpt_every < 1:
            raise SystemExit(f"--ckpt-every must be >= 1, got "
                             f"{args.ckpt_every}")
        from tfmesos_tpu_torch.train.checkpoint import CheckpointManager

        ckpt = CheckpointManager(args.ckpt_dir, mesh=mesh,
                                 param_specs=run.specs)
        latest = ckpt.latest_step()
        if latest is not None:
            ckpt.restore((run.params, run.opt_state))   # in place
            start_step = latest
            if chief:
                print(f"resumed from step {start_step}", flush=True)
            if start_step >= args.steps:
                ckpt.close()
                if chief:
                    print(f"already trained to step {start_step} >= "
                          f"--steps {args.steps}; nothing to do",
                          flush=True)
                return 0
        if not chief and run.specs is None:
            # Every rank restores, rank 0 saves (on cut params every
            # rank takes part in the gather).
            ckpt.close()
            ckpt = None
    index, shards = data_shard(mesh, ctx.rank, ctx.world_size)
    run.batches = data_stream(args, run.cfg, run.seq_len, start_step,
                              index, shards)
    out = train(run, args.steps,
                log=(lambda s: print(s, flush=True)) if chief else None,
                start_step=start_step, ckpt=ckpt, ckpt_every=args.ckpt_every)
    if ckpt is not None:
        if start_step < args.steps and args.steps % args.ckpt_every:
            ckpt.save(args.steps, (run.params, run.opt_state), wait=False)
        ckpt.close()
    if chief:
        print(f"Training elapsed time: {out['elapsed_s']:f} s", flush=True)
        print(f"tokens/sec: {out['tokens_per_s']:.0f} (per card: "
              f"{out['tokens_per_s'] / ctx.world_size:.0f})", flush=True)
    print(f"rank {ctx.rank}/{ctx.world_size} step losses: "
          f"{json.dumps(out['losses'])}", flush=True)
    runtime.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
