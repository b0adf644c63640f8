"""One rank of a gloo group running the port's mesh cases, for the
``tests/test_torch_*mesh*`` / ``test_torch_tp*`` files:

    python tests/torch_mesh_worker.py RANK WORLD PORT DIR

It joins a gloo process group at ``127.0.0.1:PORT`` through
``runtime.initialize`` (device ``cpu``), then runs every case of
``DIR/cases.json`` in order, each on a mesh over all ``WORLD`` ranks
built from the case's ``axes``; rank 0 writes each case's result to
``DIR/<name>.npz`` (arrays) or ``DIR/<name>.json``.  Inputs are numpy
files the test wrote: ``params`` an npz of a params tree (from the JAX
``init_params`` through ``convert.py``), ``tokens`` a global batch.

Case kinds:

* ``train``: ``loss_fn(mesh=)`` on this rank's share of the batch, the
  gradients averaged as the train step averages them and gathered
  whole, the whole-vocab logits of ``forward(mesh=)`` gathered over
  the data axes, ``make_eval_step(mesh=)``'s loss; then one AdamW step
  of ``make_train_step(mesh=, param_specs=)`` (its params gathered
  whole), and with ``ckpt`` the state saved (rank 0 writes).
* ``restore``: a template on the case's mesh restored from another
  case's checkpoint and gathered whole.
* ``decode``: ``decode_step(mesh=)`` over a linear or paged cache
  (plain or int8): a prefill, then ragged one-token steps, the logits
  gathered over the data axes.
* ``batcher``: ``ContinuousBatcher(mesh=)`` over the case's requests;
  the streams, each data shard's free pages and the graphs bypass.
"""

import json
import sys

import numpy as np


def _cfg(kw):
    import torch

    from tfmesos_tpu_torch.models import transformer

    return transformer.TransformerConfig(dtype=torch.float32, **kw)


def _gather_rows(x, mesh):
    from tfmesos_tpu_torch.parallel import collectives
    from tfmesos_tpu_torch.parallel.sharding import data_axes

    return collectives.all_gather(x.contiguous(), mesh,
                                  data_axes(mesh) or (), 0)


def _train(case, mesh, out_dir):
    import torch

    from tfmesos_tpu_torch import convert
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.parallel import sharding
    from tfmesos_tpu_torch.train import optim
    from tfmesos_tpu_torch.train.checkpoint import CheckpointManager
    from tfmesos_tpu_torch.train.trainer import (_flat_specs,
                                                 make_eval_step,
                                                 make_train_step,
                                                 sharded_grad_mean)

    cfg = _cfg(case["cfg"])
    full = convert.load_npz(f"{out_dir}/{case['params']}")
    specs = tt.partition_specs(cfg, mesh)
    params = sharding.place_tree(mesh, full, specs)
    tokens = np.load(f"{out_dir}/{case['tokens']}")
    batch = sharding.make_global_batch(mesh, {"tokens": tokens})
    flat = convert.flatten(params)
    for v in flat.values():
        v.requires_grad_(True)
    loss, _ = tt.loss_fn(cfg, params, batch, mesh=mesh)
    grads = sharded_grad_mean(
        list(torch.autograd.grad(loss, list(flat.values()))),
        _flat_specs(specs, list(flat)), mesh)
    whole = convert.flatten(sharding.gather_tree(
        mesh, convert.unflatten(dict(zip(flat, grads))), specs))
    with torch.no_grad():
        logits = _gather_rows(tt.forward(cfg, params,
                                         batch["tokens"][:, :-1],
                                         mesh=mesh), mesh)
    evaluated = make_eval_step(
        lambda p, b: tt.loss_fn(cfg, p, b, mesh=mesh), mesh=mesh)(params,
                                                                  batch)
    opt = optim.adamw(1e-3, weight_decay=0.01,
                      max_norm=case.get("max_norm", 0.0))
    step = make_train_step(lambda p, b: tt.loss_fn(cfg, p, b, mesh=mesh),
                           opt, mesh=mesh, param_specs=specs)
    state = opt.init(params)
    params, state, metrics = step(params, state, batch)
    after = convert.flatten(sharding.gather_tree(mesh, params, specs))
    if case.get("ckpt"):
        ckpt = CheckpointManager(f"{out_dir}/{case['ckpt']}", mesh=mesh,
                                 param_specs=specs)
        ckpt.save(1, {"params": params, "opt_state": state})
        ckpt.close()
    return {"loss": np.asarray(float(loss.detach())),
            "eval_loss": np.asarray(float(evaluated["loss"])),
            "step_loss": np.asarray(float(metrics["loss"])),
            "logits": logits.numpy(),
            **{f"grad/{k}": v.numpy() for k, v in whole.items()},
            **{f"after/{k}": v.detach().numpy() for k, v in after.items()}}


def _restore(case, mesh, out_dir):
    import torch

    from tfmesos_tpu_torch import convert
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.parallel import sharding
    from tfmesos_tpu_torch.train import optim
    from tfmesos_tpu_torch.train.checkpoint import CheckpointManager

    cfg = _cfg(case["cfg"])
    specs = tt.partition_specs(cfg, mesh)
    params = sharding.place_tree(
        mesh, tt.init_params(cfg, torch.Generator().manual_seed(9)), specs)
    opt = optim.adamw(1e-3, weight_decay=0.01)
    state = opt.init(params)
    got = CheckpointManager(f"{out_dir}/{case['ckpt']}", mesh=mesh,
                            param_specs=specs).restore(
        {"params": params, "opt_state": state})
    whole = convert.flatten(sharding.gather_tree(mesh, params, specs))
    mom = {}
    for name, t in state.moments()["exp_avg"].items():
        spec = specs
        for part in name.split("/"):
            spec = spec[part]
        mom[name] = sharding.uncut(t, spec, mesh)
    return {"count": np.asarray(got["opt_state"].count),
            **{f"params/{k}": v.numpy() for k, v in whole.items()},
            **{f"exp_avg/{k}": v.numpy() for k, v in mom.items()}}


def _decode(case, mesh, out_dir):
    import torch

    from tfmesos_tpu_torch import convert
    from tfmesos_tpu_torch.models import transformer as tt
    from tfmesos_tpu_torch.parallel import sharding
    from tfmesos_tpu_torch.parallel.sharding import data_axes

    cfg = _cfg(case["cfg"])
    full = convert.load_npz(f"{out_dir}/{case['params']}")
    if case.get("int8_weights"):
        full = tt.quantize_params(cfg, full)
    params = sharding.place_tree(mesh, full, tt.partition_specs(cfg, mesh))
    tokens = torch.from_numpy(np.load(f"{out_dir}/{case['tokens']}"))
    steps = torch.from_numpy(np.load(f"{out_dir}/{case['steps']}"))
    pos = torch.from_numpy(np.load(f"{out_dir}/{case['pos']}")).long()
    b = tokens.shape[0]
    nd = mesh.axis_size(data_axes(mesh) or ())
    lo = mesh.coord(data_axes(mesh) or ()) * (b // nd)
    rows = slice(lo, lo + b // nd)
    q = case.get("quantized", False)
    if case["paged"]:
        ps, np_ = case["page_size"], case["pages_per_row"]
        n_pages = b * np_ + nd            # a sink page a data shard
        cache = tt.init_paged_cache(cfg, n_pages, ps, quantized=q,
                                    mesh=mesh)
        # Row r's pages: shard-local ids 1 + (r % rows a shard) * np_ ..
        local = np.arange(b // nd)[:, None] * np_ + 1 + np.arange(np_)
        cache["pages"] = torch.from_numpy(local.astype(np.int32))
    else:
        cache = tt.init_cache(cfg, b, case["max_len"], quantized=q,
                              mesh=mesh)
    outs = []
    with torch.no_grad():
        lg, _ = tt.decode_step(cfg, params, cache, tokens[rows], 0,
                               mesh=mesh)
        outs.append(_gather_rows(lg, mesh))
        for i in range(steps.shape[1]):
            lg, _ = tt.decode_step(cfg, params, cache, steps[rows, i:i + 1],
                                   pos[rows] + i, mesh=mesh)
            outs.append(_gather_rows(lg, mesh))
    return {f"logits{i}": o.numpy() for i, o in enumerate(outs)}


def _batcher(case, mesh, out_dir):
    from tfmesos_tpu_torch import convert
    from tfmesos_tpu_torch.ops import prng
    from tfmesos_tpu_torch.serve import streams_differ
    from tfmesos_tpu_torch.serving import ContinuousBatcher, Request

    cfg = _cfg(case["cfg"])
    params = convert.load_npz(f"{out_dir}/{case['params']}")
    kw = dict(case["kw"])
    if "draft_cfg" in kw:
        kw["draft_cfg"] = _cfg(kw["draft_cfg"])
        kw["draft_params"] = convert.load_npz(
            f"{out_dir}/{kw['draft_params']}")
    if "prefix" in kw:
        kw["prefix"] = np.asarray(kw["prefix"], np.int32)
    if "rng" in kw:
        kw["rng"] = prng.PRNGKey(kw["rng"])
    b = ContinuousBatcher(cfg, params, mesh=mesh, device="cpu", **kw)
    reqs = [Request(prompt=np.asarray(p, np.int32), max_new_tokens=n)
            for p, n in case["requests"]]
    streams = {c.rid: c.tokens for c in b.run(reqs)}
    sides = [s for s in (b.t_side, b.d_side) if s is not None]
    refused = {}
    tiered = lambda: ContinuousBatcher(  # noqa: E731
        cfg, params, mesh=mesh, device="cpu", kv_tier=object(),
        **kw).kv_tier_bypass_reason
    for what, call in (("export_kv", lambda: b.export_kv(reqs[0])),
                       ("set_weights", lambda: b.set_weights(params)),
                       ("kv_tier", tiered)):
        try:
            got = call()
        except Exception as e:            # recorded for the test to read
            refused[what] = f"{type(e).__name__}: {e}"
        else:
            refused[what] = got
    return {"streams": {str(k): v for k, v in streams.items()},
            "ranks_differ": streams_differ(mesh, streams, "cpu"),
            "refused": refused,
            "free": [[s.shard_alloc(i).free_count()
                      for i in range(s.n_shards)] for s in sides],
            "per_shard": [s.n_pages // s.n_shards for s in sides],
            "rows_left": [len(s.alloc.rows) for s in sides],
            "n_shards": b.n_shards,
            "graphs_bypass_reason": b.graphs_bypass_reason}


KINDS = {"train": _train, "restore": _restore, "decode": _decode,
         "batcher": _batcher}


def run_cases(cases, world, out_dir, timeout=240.0):
    """Write ``cases`` to ``out_dir``, run this worker at every rank at
    once over a fresh port, and fail with a rank's stderr if one
    fails (the tests' side)."""
    import os
    import socket
    import subprocess
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    with open(f"{out_dir}/cases.json", "w") as f:
        json.dump(cases, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(port),
         str(out_dir)], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"mesh worker exited {p.returncode}: "
                                   f"{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def main(rank, world, port, out_dir):
    from tfmesos_tpu_torch import runtime
    from tfmesos_tpu_torch.parallel.mesh import build_mesh

    ctx = runtime.initialize(
        runtime.TaskContext(rank=rank, world_size=world,
                            coordinator=f"127.0.0.1:{port}"), device="cpu")
    with open(f"{out_dir}/cases.json") as f:
        cases = json.load(f)
    for case in cases:
        mesh = build_mesh(case["axes"], device_type="cpu")
        out = KINDS[case["kind"]](case, mesh, out_dir)
        if ctx.rank == 0:
            if case["kind"] == "batcher":
                with open(f"{out_dir}/{case['name']}.json", "w") as f:
                    json.dump(out, f)
            else:
                np.savez(f"{out_dir}/{case['name']}.npz", **out)
    runtime.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
