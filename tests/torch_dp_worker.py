"""One rank of a data-parallel train-step run of the port, for
``tests/test_torch_dp.py``:

    python tests/torch_dp_worker.py CASE RANK WORLD PORT DIR

It joins a gloo process group at ``127.0.0.1:PORT`` through
``runtime.initialize`` (device ``cpu``), loads the weights
``DIR/params.npz`` and the global batches ``DIR/batches.npz`` (one
``b<step>_<key>`` array a step and batch key), trains on its own equal
share of each global batch (rows ``rank * n / world ..``) with
``make_train_step(mesh=ctx.mesh(...))``, and writes its params and
per-step losses to ``DIR/rank<RANK>.npz``.  CASE ``transformer`` is
the tiny transformer with AdamW over a ``dp`` mesh, ``mlp`` the MNIST
MLP with SGD over ``fsdp``.
"""

import sys

import numpy as np


def main(case, rank, world, port, out_dir):
    import torch

    from tfmesos_tpu_torch import convert, runtime
    from tfmesos_tpu_torch.train import optim
    from tfmesos_tpu_torch.train.trainer import make_train_step

    ctx = runtime.initialize(
        runtime.TaskContext(rank=rank, world_size=world,
                            coordinator=f"127.0.0.1:{port}"), device="cpu")
    params = convert.load_npz(f"{out_dir}/params.npz")
    if case == "transformer":
        from tfmesos_tpu_torch.models import transformer

        cfg = transformer.TransformerConfig(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
            max_seq_len=64, n_kv_heads=2, dtype=torch.float32)
        opt = optim.adamw(1e-3, weight_decay=0.01)
        mesh = ctx.mesh({"dp": -1})
        step = make_train_step(
            lambda p, b: transformer.loss_fn(cfg, p, b), opt, mesh=mesh)
    else:
        from tfmesos_tpu_torch.models import mlp

        cfg = mlp.MLPConfig(hidden=32)
        opt = optim.sgd(0.1)
        mesh = ctx.mesh({"fsdp": -1})
        step = make_train_step(lambda p, b: mlp.loss_fn(cfg, p, b), opt,
                               mesh=mesh)
    state = opt.init(params)
    losses = []
    with np.load(f"{out_dir}/batches.npz") as z:
        steps = sorted({int(k.split("_")[0][1:]) for k in z.files})
        for i in steps:
            batch = {}
            for k in z.files:
                if k.startswith(f"b{i}_"):
                    full = z[k]
                    n = full.shape[0] // world
                    batch[k.split("_", 1)[1]] = torch.from_numpy(
                        full[rank * n:(rank + 1) * n].copy())
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))
    flat = {k: v.detach().numpy() for k, v in convert.flatten(params).items()}
    np.savez(f"{out_dir}/rank{rank}.npz", losses=np.asarray(losses),
             mesh=np.asarray([mesh.size()]), **flat)
    runtime.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
