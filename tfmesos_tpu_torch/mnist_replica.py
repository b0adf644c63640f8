"""Between-graph distributed MNIST trainer (port of
``examples/mnist_replica.py``).

    python -m tfmesos_tpu_torch.cli run -w 2 -s 1 --worker-logs '*' -- \\
        python -m tfmesos_tpu_torch.mnist_replica --train_steps 200 \\
        --batch_size 100 [--device cpu]

Every task, ps and worker alike, joins one process group
(``runtime.initialize``) and trains the one-hidden-layer MLP with
synchronous SGD: each rank draws ``batch_size // world_size`` rows of
``SyntheticMNIST`` (seed 100 + rank; nothing is downloaded) and the
gradients are averaged over the data mesh (``fsdp`` when the spec has
ps tasks, else ``dp``) before each update, so every rank holds the same
weights.  The output keeps the reference's contract: ``job name =``,
``task index =``, ``Training begins @``, a line per logged step,
``Training elapsed time:``, ``steps/sec:``, then the validation cross
entropy and accuracy on a 1000-row eval batch that every rank draws
alike.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tfmesos_tpu_torch.mnist_replica")
    p.add_argument("--train_steps", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--learning_rate", type=float, default=0.01)
    p.add_argument("--hidden_units", type=int, default=100)
    p.add_argument("--sync_replicas", action="store_true", default=True,
                   help="kept for CLI parity; synchronous all-reduce is "
                        "the only semantics")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; cpu runs the plain "
                        "PyTorch path)")
    args = p.parse_args(argv)

    import torch

    from tfmesos_tpu_torch import runtime
    from tfmesos_tpu_torch.models import mlp
    from tfmesos_tpu_torch.train import data as datalib
    from tfmesos_tpu_torch.train import optim
    from tfmesos_tpu_torch.train.trainer import (TrainLoop, TrainState,
                                                 make_train_step)

    ctx = runtime.initialize(device=args.device)
    mesh = ctx.mesh()
    print(f"job name = {ctx.job_name}", flush=True)
    print(f"task index = {ctx.task_index}", flush=True)
    print(f"mesh = {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
          f"{ctx.world_size} rank(s) on {ctx.device}", flush=True)

    cfg = mlp.MLPConfig(hidden=args.hidden_units)
    params = mlp.init_params(cfg, torch.Generator().manual_seed(0),
                             ctx.device)
    opt = optim.sgd(args.learning_rate)
    step = make_train_step(lambda p_, b_: mlp.loss_fn(cfg, p_, b_), opt,
                           mesh=mesh)
    ds = datalib.SyntheticMNIST()
    local_bs = max(1, args.batch_size // max(1, ctx.world_size))
    batches = datalib.prefetch(ds.batches(local_bs, seed=100 + ctx.rank),
                               ctx.device)

    loop = TrainLoop(step, TrainState(params, opt.init(params)),
                     log_every=50, name="mnist_replica")
    time_begin = time.time()
    print(f"Training begins @ {time_begin:f}", flush=True)

    def on_metrics(i, m):
        print(f"{time.time():f}: Worker {ctx.task_index}: training step "
              f"{i} done (global step: {i})", flush=True)

    result = loop.run(batches, args.train_steps, on_metrics=on_metrics)
    print(f"Training ends @ {time.time():f}", flush=True)
    print(f"Training elapsed time: {result['elapsed_s']:f} s", flush=True)
    print(f"steps/sec: {result['steps_per_sec']:.2f} "
          f"(per card: {result['steps_per_sec_per_chip']:.2f})", flush=True)

    ev = {k: torch.from_numpy(v).to(ctx.device)
          for k, v in ds.eval_batch(1000).items()}
    with torch.no_grad():
        loss, aux = mlp.loss_fn(cfg, loop.state.params, ev)
    print(f"After {args.train_steps} training step(s), validation cross "
          f"entropy = {float(loss):g}", flush=True)
    print(f"validation accuracy = {float(aux['accuracy']):.4f}", flush=True)
    runtime.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
