"""The multi-rank dry run (port of ``__graft_entry__.dryrun_multichip``).

    python -m tfmesos_tpu_torch.dryrun [N]

:func:`dryrun_multichip` spawns ``n`` gloo ranks on the CPU, lays them
out as dp x tp (tp 2 when it divides ``n``, dp the rest) or as one of
the other :func:`factorizations` — dp x sp (the sequence over the
ring), dp x ep (a dense-MoE tiny model, its experts over ep) and, as
JAX's where ``n`` allows them, pp2 x tp2 x dp, pp2 x ep2 x dp (dense
MoE: the router's gradient must be non-zero) and pp2 x tp2 x ep2 (with
a shared expert), their layers a gpipe pipeline — and takes one
sharded training step of the tiny transformer on every rank: the
params cut per ``partition_specs``, the global batch cut over dp, the
vocab-parallel loss, the gradients averaged over dp, their global norm
summed over the shards, an SGD update.  Rank 0 then holds the loss,
the norm, every gathered gradient and every updated parameter to one
process's plain autodiff and step on the whole batch, within 1e-5
(float32; the shards sum in another order) — over pp, one process's
loss averaged over the same microbatches (the pipeline's router aux is
a microbatch estimator, as in JAX).  It raises if a rank fails or a
number disagrees.
"""

from __future__ import annotations

import socket
import sys
from typing import Any, Dict, Optional

TOL = 1e-5


def factor_mesh(n: int, axis: str = "tp") -> Dict[str, int]:
    """dp x ``axis`` (tp, sp or ep) over ``n`` ranks: ``axis`` 2 when it
    divides ``n``, else 1."""
    k = 2 if n % 2 == 0 else 1
    return {"dp": n // k, axis: k}


def factorizations(n: int):
    """The meshes the dry run covers over ``n`` ranks: dp x tp, dp x sp
    and dp x ep, and JAX's pp factorizations where ``n`` allows them
    (``__graft_entry__.dryrun_multichip`` ``:239-300``)."""
    out = [factor_mesh(n, a) for a in ("tp", "sp", "ep")]
    if n >= 8 and n % 4 == 0:
        out += [{"pp": 2, "tp": 2, "dp": n // 4},
                {"pp": 2, "ep": 2, "dp": n // 4}]
    if n >= 8 and n % 8 == 0:
        out.append({"pp": 2, "tp": 2, "ep": 2, "dp": n // 8})
    return out


def _microbatches(axes: Dict[str, int]) -> int:
    """The pieces one process averages its loss over: a pipeline's
    microbatches (pp a data shard) times the data shards."""
    pp = axes.get("pp", 1)
    return pp * axes.get("dp", 1) * axes.get("fsdp", 1) if pp > 1 else 1


def _tiny(axes: Dict[str, int]):
    import torch

    from tfmesos_tpu_torch.models import transformer

    moe = dict(n_experts=4, top_k=2) if axes.get("ep", 1) > 1 else {}
    if moe and axes.get("pp", 1) > 1 and axes.get("tp", 1) > 1:
        moe["n_shared_experts"] = 1
    return transformer.TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
        max_seq_len=64, n_kv_heads=2, dtype=torch.float32, z_loss=1e-4,
        **moe)


def _inputs(cfg, n: int):
    import numpy as np
    import torch

    from tfmesos_tpu_torch.models import transformer

    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2 * n, 33)).astype(np.int64)
    return params, {"tokens": torch.from_numpy(tokens)}


def _step(cfg, params, batch, mesh=None, specs=None, pieces: int = 1):
    """(loss, grads, their global norm, params after one SGD step) on
    this rank; one process averages its loss over ``pieces`` equal row
    blocks of the batch."""
    import torch

    from tfmesos_tpu_torch.convert import flatten, unflatten
    from tfmesos_tpu_torch.models import transformer
    from tfmesos_tpu_torch.train import optim
    from tfmesos_tpu_torch.train.trainer import (_flat_specs,
                                                 make_train_step,
                                                 sharded_grad_mean,
                                                 sharded_sumsq)

    def loss_fn(p, b):
        if pieces == 1:
            return transformer.loss_fn(cfg, p, b, mesh=mesh)
        parts = [transformer.loss_fn(cfg, p, {"tokens": t})
                 for t in b["tokens"].chunk(pieces)]
        return sum(l_ for l_, _ in parts) / pieces, {}

    flat = flatten(params)
    for v in flat.values():
        v.requires_grad_(True)
    loss, _ = loss_fn(params, batch)
    grads = list(torch.autograd.grad(loss, list(flat.values())))
    if mesh is not None:
        fspecs = _flat_specs(specs, list(flat))
        grads = sharded_grad_mean(grads, fspecs, mesh)
        sumsq = sharded_sumsq(fspecs, mesh)(grads)
    else:
        sumsq = sum(torch.sum(g ** 2) for g in grads)
    grads = unflatten(dict(zip(flat, grads)))
    opt = optim.sgd(0.1)
    step = make_train_step(loss_fn, opt, mesh=mesh, param_specs=specs)
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
        cfg = _tiny(axes)
        full, batch = _inputs(cfg, n)
        specs = transformer.partition_specs(cfg, mesh)
        loss, grads, norm, params = _step(
            cfg, sharding.place_tree(mesh, full, specs),
            sharding.make_global_batch(mesh, batch), mesh, specs)
        grads = sharding.gather_tree(mesh, grads, specs)
        params = sharding.gather_tree(mesh, params, specs)
        out: Dict[str, Any] = {"rank": rank, "loss": loss}
        if rank == 0:
            rloss, rgrads, rnorm, rparams = _step(
                cfg, *_inputs(cfg, n), pieces=_microbatches(axes))

            def err(a, b):
                return max(float((x - y).abs().max()) for x, y in zip(
                    flatten(a).values(), flatten(b).values()))

            out.update(ref_loss=rloss, grad_err=err(grads, rgrads),
                       param_err=err(params, rparams),
                       norm_err=abs(norm - rnorm))
            if cfg.n_experts:
                out["router_grad"] = float(
                    grads["layers"]["router"].abs().sum())
        q.put(out)
        dist.destroy_process_group()
    except Exception as e:      # reported to the parent, which raises
        q.put({"rank": rank, "error": f"{type(e).__name__}: {e}"})


def dryrun_multichip(n: int, timeout: float = 600.0,
                     axes: Optional[Dict[str, int]] = None
                     ) -> Dict[str, Any]:
    """One sharded training step over ``n`` gloo ranks on the CPU, laid
    out as ``axes`` (default dp x tp, :func:`factor_mesh`), held to one
    process (see the module docstring).  Returns rank 0's numbers and
    the mesh; raises ``RuntimeError`` on a failure or a
    disagreement."""
    import multiprocessing as mp

    axes = dict(axes or factor_mesh(n))
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
            or head["norm_err"] > TOL
            or head.get("router_grad", 1.0) == 0.0):
        raise RuntimeError(f"dryrun_multichip({n}) on {axes} disagrees "
                           f"with one process: {outs}")
    return {"mesh": axes, **head}


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    for axes in factorizations(n):
        print(dryrun_multichip(n, axes=axes))
