"""The multi-rank dry run (port of ``__graft_entry__.dryrun_multichip``,
its dp x tp part; sp and ep come with ROADMAP A.10).

    python -m tfmesos_tpu_torch.dryrun [N]

:func:`dryrun_multichip` spawns ``n`` gloo ranks on the CPU, lays them
out as dp x tp (tp 2 when it divides ``n``, dp the rest), and takes
one sharded training step of the tiny transformer on every rank: the
params cut per ``partition_specs``, the global batch cut over dp, the
vocab-parallel loss, the gradients averaged over dp, their global norm
summed over the shards, an SGD update.  Rank 0 then holds the loss,
the norm, every gathered gradient and every updated parameter to one
process's plain autodiff and step on the whole batch, within 1e-5
(float32; the shards sum in another order).  It raises if a rank
fails or a number disagrees.
"""

from __future__ import annotations

import socket
import sys
from typing import Any, Dict

TOL = 1e-5


def factor_mesh(n: int) -> Dict[str, int]:
    """dp x tp over ``n`` ranks: tp 2 when it divides ``n``, else 1."""
    tp = 2 if n % 2 == 0 else 1
    return {"dp": n // tp, "tp": tp}


def _tiny():
    import torch

    from tfmesos_tpu_torch.models import transformer

    return transformer.TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
        max_seq_len=64, n_kv_heads=2, dtype=torch.float32, z_loss=1e-4)


def _inputs(cfg, n: int):
    import numpy as np
    import torch

    from tfmesos_tpu_torch.models import transformer

    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2 * n, 33)).astype(np.int64)
    return params, {"tokens": torch.from_numpy(tokens)}


def _step(cfg, params, batch, mesh=None, specs=None):
    """(loss, grads, their global norm, params after one SGD step) on
    this rank."""
    import torch

    from tfmesos_tpu_torch.convert import flatten, unflatten
    from tfmesos_tpu_torch.models import transformer
    from tfmesos_tpu_torch.train import optim
    from tfmesos_tpu_torch.train.trainer import (_flat_specs,
                                                 make_train_step,
                                                 sharded_grad_mean,
                                                 sharded_sumsq)

    flat = flatten(params)
    for v in flat.values():
        v.requires_grad_(True)
    loss, _ = transformer.loss_fn(cfg, params, batch, mesh=mesh)
    grads = list(torch.autograd.grad(loss, list(flat.values())))
    if mesh is not None:
        fspecs = _flat_specs(specs, list(flat))
        grads = sharded_grad_mean(grads, fspecs, mesh)
        sumsq = sharded_sumsq(fspecs, mesh)(grads)
    else:
        sumsq = sum(torch.sum(g ** 2) for g in grads)
    grads = unflatten(dict(zip(flat, grads)))
    opt = optim.sgd(0.1)
    step = make_train_step(
        lambda p, b: transformer.loss_fn(cfg, p, b, mesh=mesh), opt,
        mesh=mesh, param_specs=specs)
    params, _, _ = step(params, opt.init(params), batch)
    return float(loss.detach()), grads, float(sumsq) ** 0.5, params


def _rank(rank: int, n: int, port: int, axes: Dict[str, int], q) -> None:
    import torch
    import torch.distributed as dist

    from tfmesos_tpu_torch.convert import flatten
    from tfmesos_tpu_torch.models import transformer
    from tfmesos_tpu_torch.parallel import sharding
    from tfmesos_tpu_torch.parallel.mesh import build_mesh

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=n)
        mesh = build_mesh(axes, device_type="cpu")
        cfg = _tiny()
        full, batch = _inputs(cfg, n)
        specs = transformer.partition_specs(cfg, mesh)
        loss, grads, norm, params = _step(
            cfg, sharding.place_tree(mesh, full, specs),
            sharding.make_global_batch(mesh, batch), mesh, specs)
        grads = sharding.gather_tree(mesh, grads, specs)
        params = sharding.gather_tree(mesh, params, specs)
        out: Dict[str, Any] = {"rank": rank, "loss": loss}
        if rank == 0:
            rloss, rgrads, rnorm, rparams = _step(cfg, *_inputs(cfg, n))

            def err(a, b):
                return max(float((x - y).abs().max()) for x, y in zip(
                    flatten(a).values(), flatten(b).values()))

            out.update(ref_loss=rloss, grad_err=err(grads, rgrads),
                       param_err=err(params, rparams),
                       norm_err=abs(norm - rnorm))
        q.put(out)
        dist.destroy_process_group()
    except Exception as e:      # reported to the parent, which raises
        q.put({"rank": rank, "error": f"{type(e).__name__}: {e}"})


def dryrun_multichip(n: int, timeout: float = 600.0) -> Dict[str, Any]:
    """One sharded training step over ``n`` gloo ranks on the CPU,
    held to one process (see the module docstring).  Returns rank 0's
    numbers and the mesh; raises ``RuntimeError`` on a failure or a
    disagreement."""
    import multiprocessing as mp

    axes = factor_mesh(n)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, n, port, axes, q))
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        outs = sorted((q.get(timeout=timeout) for _ in procs),
                      key=lambda o: o["rank"])
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    bad = [o for o in outs if "error" in o]
    if bad:
        raise RuntimeError(f"dryrun_multichip({n}): {bad}")
    head = outs[0]
    losses = {o["loss"] for o in outs}
    if (len(losses) != 1 or abs(head["loss"] - head["ref_loss"]) > TOL
            or head["grad_err"] > TOL or head["param_err"] > TOL
            or head["norm_err"] > TOL):
        raise RuntimeError(f"dryrun_multichip({n}) on {axes} disagrees "
                           f"with one process: {outs}")
    return {"mesh": axes, **head}


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4))
