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

A case with ``ranks`` runs on a mesh over the first that many ranks
(the others take part in making its groups, then wait).

Case kinds:

* ``train``: ``loss_fn(mesh=)`` on this rank's share of the batch (or
  with ``1f1b`` ``train_step_1f1b``, also the step's ``grads_fn``), the
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
* ``attn``: ``attend(mesh=)`` (the ring or Ulysses) or the einsum
  ring (``ring_attention_local``)
  on this rank's shards of global q/k/v, its gradients from the
  rank's shard of a global output gradient; the output and dq/dk/dv
  gathered whole.
* ``moe``: ``parallel.moe.switch_moe(mesh=)`` on this rank's data
  shard of the tokens and its ep block of the experts: the output, the
  aux, and the gradients of the tokens and of every weight (from a
  global output gradient) gathered whole.
* ``pipe``: ``parallel.pipeline`` on a toy stage (``_pipe``).
* ``batcher_kv``: the KV surface of a tp-only mesh batcher with a KV
  tier: an export (packed, rank 0 writes it), the imports of the
  artifacts the test wrote, ``preempt_all`` after the first completion
  with every suspended request re-imported (one mid-stream artifact
  written), a session parked and its next turn resumed beside a cold
  prefill, then an adapter fold and ``set_weights``, each followed by
  a run.
"""

import json
import sys

import numpy as np


def _cfg(kw):
    import torch

    from tfmesos_tpu_torch.models import transformer

    return transformer.TransformerConfig(dtype=torch.float32, **kw)


def _gather_rows(x, mesh, seq_dim=None):
    """``x`` gathered over the data axes on dim 0 (and over sp on
    ``seq_dim``)."""
    from tfmesos_tpu_torch.parallel import collectives
    from tfmesos_tpu_torch.parallel.sharding import data_axes

    if seq_dim is not None:
        x = collectives.all_gather(x.contiguous(), mesh, "sp", seq_dim)
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
    grads_fn = None
    if case.get("1f1b"):
        def grads_fn(p, b):
            loss_, g = tt.train_step_1f1b(cfg, p, b, mesh)
            return g, loss_, {"perplexity": torch.exp(loss_)}

        g, loss, first = grads_fn(params, batch)
        grads = [convert.flatten(g)[k] for k in flat]
    else:
        loss, first = tt.loss_fn(cfg, params, batch, mesh=mesh)
        grads = sharded_grad_mean(
            list(torch.autograd.grad(loss, list(flat.values()))),
            _flat_specs(specs, list(flat)), mesh)
    whole = convert.flatten(sharding.gather_tree(
        mesh, convert.unflatten(dict(zip(flat, grads))), specs))
    with torch.no_grad():
        logits = _gather_rows(tt.forward(cfg, params,
                                         batch["tokens"][:, :-1],
                                         mesh=mesh), mesh, seq_dim=1)
    evaluated = make_eval_step(
        lambda p, b: tt.loss_fn(cfg, p, b, mesh=mesh), mesh=mesh)(params,
                                                                  batch)
    opt = optim.adamw(1e-3, weight_decay=0.01,
                      max_norm=case.get("max_norm", 0.0))
    step = make_train_step(lambda p, b: tt.loss_fn(cfg, p, b, mesh=mesh),
                           opt, mesh=mesh, param_specs=specs,
                           grads_fn=grads_fn)
    state = opt.init(params)
    params, state, metrics = step(params, state, batch)
    after = convert.flatten(sharding.gather_tree(mesh, params, specs))
    if case.get("ckpt"):
        ckpt = CheckpointManager(f"{out_dir}/{case['ckpt']}", mesh=mesh,
                                 param_specs=specs)
        ckpt.save(1, {"params": params, "opt_state": state})
        ckpt.close()
    aux = {f"metric/{k}": np.asarray(float(v)) for k, v in first.items()}
    return {"loss": np.asarray(float(loss.detach())), **aux,
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
            refused[what] = (got if got is None or isinstance(got, str)
                             else type(got).__name__)
    return {"streams": {str(k): v for k, v in streams.items()},
            "ranks_differ": streams_differ(mesh, streams, "cpu"),
            "refused": refused,
            "free": [[s.shard_alloc(i).free_count()
                      for i in range(s.n_shards)] for s in sides],
            "per_shard": [s.n_pages // s.n_shards for s in sides],
            "rows_left": [len(s.alloc.rows) for s in sides],
            "n_shards": b.n_shards,
            "graphs_bypass_reason": b.graphs_bypass_reason}


def _packed(art):
    from tfmesos_tpu_torch.serving import pack_prefilled

    meta, body = pack_prefilled(art)
    return {"meta": meta, "body": bytes(body).hex()}


def _batcher_kv(case, mesh, out_dir):
    from tfmesos_tpu_torch import convert
    from tfmesos_tpu_torch.fleet.kvtier import KVTierStore
    from tfmesos_tpu_torch.serve import streams_differ
    from tfmesos_tpu_torch.serving import (ContinuousBatcher, Prefilled,
                                           Request, Suspended,
                                           unpack_prefilled)

    cfg = _cfg(case["cfg"])
    params = convert.load_npz(f"{out_dir}/{case['params']}")
    b = ContinuousBatcher(cfg, params, mesh=mesh, device="cpu",
                          kv_tier=KVTierStore(ram_bytes=1 << 24),
                          **case["kw"])
    req = lambda p, n, **kw: Request(  # noqa: E731
        prompt=np.asarray(p, np.int32), max_new_tokens=n, **kw)
    reqs = [req(p, n) for p, n in case["requests"]]
    out = {"export": _packed(b.export_kv(reqs[0]))}
    # Imports of the test's artifacts (a one-process port export and a
    # JAX export), each run to its end.
    out["imports"] = {}
    for name, i in case["imports"].items():
        with open(f"{out_dir}/{name}.json") as f:
            packed = json.load(f)
        art = unpack_prefilled(packed["meta"], bytes.fromhex(packed["body"]))
        (c,) = b.run([Prefilled(reqs[i], art)])
        out["imports"][name] = c.tokens
    # preempt_all once the first completion is back (the same point on
    # every rank), then every suspended request re-imported.
    index = {id(r): i for i, r in enumerate(reqs)}
    final, back = {}, []
    for item in b.run(reqs):
        if isinstance(item, Suspended):
            back.append(item)
            continue
        final[index[id(item.request)]] = item.tokens
        if len(final) == 1:
            b.preempt_all()
    carried = [s for s in back if s.artifact is not None]
    mid = [s for s in carried if int(s.artifact["step"]) > 1]
    out["suspended"], out["carried"] = len(back), len(carried)
    if mid:
        out["mid_stream"] = dict(_packed(mid[0].artifact),
                                 index=index[id(mid[0].request)])
    for c in b.run([Prefilled(s.request, s.artifact)
                    if s.artifact is not None else s.request
                    for s in back]):
        final[index[id(c.request)]] = c.tokens
    out["preempt"] = {str(i): final[i] for i in sorted(final)}
    # A session parked, its next turn resumed from the tier beside a
    # cold prefill of the same history.
    p, n = case["requests"][1]
    (turn1,) = b.run([req(p, n, session_id="conv")])
    hist = list(p) + list(turn1.tokens) + [7, 2]
    (warm,) = b.run([req(hist, n, session_id="conv")])
    (cold,) = b.run([req(hist, n)])
    out["session"] = {"turn1": turn1.tokens, "history": hist,
                      "resumed": warm.tokens, "cold": cold.tokens,
                      "resume": b.kv_tier.stats().get("resume", 0)}
    # Weight swaps between runs: an adapter fold, then a whole tree.
    delta = np.load(f"{out_dir}/{case['delta']}")["embed"]
    b.swap_adapter({"embed": delta}, "d1")
    (folded,) = b.run([req(*case["requests"][0])])
    b.set_weights(convert.load_npz(f"{out_dir}/{case['params2']}"), "v2")
    (swapped,) = b.run([req(*case["requests"][0])])
    out["swaps"] = {"folded": folded.tokens, "set": swapped.tokens,
                    "weight_swaps": b.weight_swaps,
                    "adapter_version": b.adapter_version}
    every = {**{f"p{k}": v for k, v in out["preempt"].items()},
             **{f"i{k}": v for k, v in out["imports"].items()},
             "f": folded.tokens, "s": swapped.tokens,
             "w": warm.tokens}
    out["ranks_differ"] = streams_differ(mesh, every, "cpu")
    out["n_shards"] = b.n_shards
    return out


def _attn(case, mesh, out_dir):
    import torch

    from tfmesos_tpu_torch.ops.attention import attend
    from tfmesos_tpu_torch.parallel import ring_attention
    from tfmesos_tpu_torch.parallel.sharding import batch_spec, cut

    arrs = np.load(f"{out_dir}/{case['inputs']}")
    spec = batch_spec(mesh, extra_dims=3)
    q, k, v, do = (cut(torch.from_numpy(arrs[n]), spec, mesh).contiguous()
                   for n in ("q", "k", "v", "do"))
    for t in (q, k, v):
        t.requires_grad_(True)
    kw = dict(causal=case.get("causal", True), window=case.get("window"))
    if case.get("impl") == "einsum":
        o = ring_attention.ring_attention_local(q, k, v, mesh, **kw)
    else:
        o = attend(q, k, v, mesh, sp_impl=case.get("sp_impl", "ring"), **kw)
    grads = torch.autograd.grad(o, (q, k, v), do)
    return {name: _gather_rows(t.detach(), mesh, seq_dim=1).numpy()
            for name, t in zip(("o", "dq", "dk", "dv"), (o, *grads))}


def _moe(case, mesh, out_dir):
    import torch

    from tfmesos_tpu_torch.parallel import collectives
    from tfmesos_tpu_torch.parallel.moe import switch_moe
    from tfmesos_tpu_torch.parallel.sharding import batch_spec, cut

    arrs = {k: torch.from_numpy(v) for k, v in
            np.load(f"{out_dir}/{case['inputs']}").items()}
    x = cut(arrs["x"], batch_spec(mesh, 1), mesh).contiguous()
    do = cut(arrs["do"], batch_spec(mesh, 1), mesh).contiguous()
    ep = ("ep", None, None)
    ws = [cut(arrs[n], ep, mesh).contiguous()
          for n in ("w_gate", "w_up", "w_down")]
    router = arrs["router"].clone()
    leaves = [x, router, *ws]
    for t in leaves:
        t.requires_grad_(True)
    out, aux = switch_moe(x, router, *ws, mesh,
                          capacity_factor=case["capacity_factor"],
                          top_k=case["top_k"], return_aux=True)
    grads = torch.autograd.grad(out, leaves, do)
    data = ("dp",)
    # The router is whole on every rank: its gradient sums over the
    # data shards (each rank's covers its own tokens).
    g_router = collectives.all_reduce_sum(grads[1], mesh, data)
    res = {"out": _gather_rows(out.detach(), mesh).numpy(),
           "dx": _gather_rows(grads[0], mesh).numpy(),
           "drouter": g_router.numpy(),
           **{f"aux/{k}": np.asarray(float(v)) for k, v in aux.items()}}
    for name, g in zip(("w_gate", "w_up", "w_down"), grads[2:]):
        g = collectives.all_reduce_sum(g, mesh, data)
        res[f"d{name}"] = collectives.all_gather(g, mesh, "ep", 0).numpy()
    return res


def _pipe_stage(kind, mesh):
    """The toy stage bodies of the pipeline cases (``tests/
    test_torch_pipeline.py`` defines their JAX twins)."""
    import torch

    from tfmesos_tpu_torch.parallel import collectives

    def tanh(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    if kind == "tanh":
        return tanh
    if kind == "aux":
        return lambda p, h: (tanh(p, h), {"sq": (h ** 2).mean(),
                                          "abs": h.abs().mean()})
    if kind == "stage_aux":
        return lambda p, h: (tanh(p, h), 0.1 * (h ** 2).mean())
    if kind == "tp":
        def tp(p, h):
            hin = collectives.broadcast_replicated_grad(h, mesh, "tp")
            return h + collectives.psum_replicated_grad(
                torch.tanh(hin @ p["w1"]) @ p["w2"], mesh, "tp")
        return tp
    raise ValueError(kind)


def _pipe(case, mesh, out_dir):
    """``parallel.pipeline`` on a toy stage: this rank's chunks of the
    global stacked params (round-robin over pp with ``v`` > 1), its
    shares of ``x`` (and ``t``) over the data axes (and of the sequence
    over sp with ``seq_axis``).  ``apply``: ``pipeline_apply`` and the
    gradients of sum(out * g) (+ aux . g_aux, divided over the data
    shards and sp, whose ranks each add their own share) by autograd,
    summed over those axes; ``1f1b``: ``pipeline_train_1f1b``'s loss,
    grads (tail grads) and dx.  Everything gathered whole."""
    import torch

    from tfmesos_tpu_torch.parallel import collectives, pipeline, sharding
    from tfmesos_tpu_torch.parallel.sharding import data_axes

    arrs = {k: torch.from_numpy(v) for k, v in
            np.load(f"{out_dir}/{case['inputs']}").items()}
    v = case.get("v", 1)
    entry = sharding.Interleaved("pp", v) if v > 1 else "pp"
    rest = {"w1": (None, "tp"), "w2": ("tp", None)}
    names = [k for k in ("w", "b", "w1", "w2") if k in arrs]
    specs = {k: (entry,) + rest.get(k, (None,) * (arrs[k].dim() - 1))
             for k in names}
    params = {k: sharding.cut(arrs[k], specs[k], mesh).clone()
              .requires_grad_(True) for k in names}
    seq = case.get("seq_axis")
    rows = data_axes(mesh)
    xspec = (rows,) + ((seq,) if seq else ())

    def share(a):
        return sharding.cut(a, xspec, mesh).clone()

    x = share(arrs["x"]).requires_grad_(True)
    stage = _pipe_stage(case["stage"], mesh)
    m = case.get("m")
    out = {}
    if case["mode"] == "apply":
        aux_keys = case.get("aux")
        got = pipeline.pipeline_apply(
            stage, params, x, mesh, num_microbatches=m,
            schedule=case.get("schedule", "gpipe"), virtual_stages=v,
            with_aux={k: 0.0 for k in aux_keys} if aux_keys else False,
            seq_axis=seq)
        y, aux = got if aux_keys else (got, {})
        shards = mesh.axis_size(tuple(rows or ()) + ((seq,) if seq else ()))
        obj = torch.sum(y * share(arrs["g"]))
        for i, k in enumerate(sorted(aux)):
            obj = obj + aux[k] * float(arrs["g_aux"][i]) / shards
            out[f"aux/{k}"] = aux[k].detach().numpy()
        grads = torch.autograd.grad(obj, list(params.values()) + [x])
        sum_axes = tuple(rows or ()) + ((seq,) if seq else ())
        gp = {k: collectives.all_reduce_sum(g, mesh, sum_axes)
              for k, g in zip(params, grads)}
        out["out"] = sharding.uncut(y.detach(), xspec, mesh).numpy()
        dx = grads[-1]
    else:
        tail = ({"u": arrs["u"].clone()} if "u" in arrs else None)
        stage_aux = case["stage"] == "stage_aux"
        if tail is None:
            loss_fn = lambda h, t: torch.mean((h - t) ** 2)  # noqa: E731
        else:
            loss_fn = lambda tl, h, t: torch.mean(  # noqa: E731
                (h @ tl["u"] - t) ** 2)
        got = pipeline.pipeline_train_1f1b(
            stage, loss_fn, {k: p.detach() for k, p in params.items()},
            x.detach(), share(arrs["t"]), mesh, num_microbatches=m,
            tail_params=tail, stage_aux=stage_aux, virtual_stages=v)
        if tail is None:
            loss, gp, dx = got
        else:
            loss, gp, gtail, dx = got
            out["tail/u"] = gtail["u"].numpy()
        out["loss"] = loss.numpy()
    for k, g in gp.items():
        out[f"grad/{k}"] = sharding.uncut(g, specs[k], mesh).numpy()
    out["dx"] = sharding.uncut(dx.detach(), xspec, mesh).numpy()
    return out


KINDS = {"attn": _attn, "moe": _moe, "train": _train, "restore": _restore,
         "decode": _decode, "batcher": _batcher, "batcher_kv": _batcher_kv,
         "pipe": _pipe}


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


def _case_mesh(case, rank, world):
    """The case's mesh: over every rank, or over its first ``ranks``
    (every rank takes part in making the groups: ``new_group`` is
    collective over the world); None where this rank sits the case
    out."""
    from tfmesos_tpu_torch.parallel.mesh import (RankMesh, build_mesh,
                                                 resolve_axes)

    n = case.get("ranks", world)
    if n == world:
        return build_mesh(case["axes"], device_type="cpu")
    mesh = RankMesh(resolve_axes(case["axes"], n),
                    rank if rank < n else 0, "cpu")
    return mesh if rank < n else None


def main(rank, world, port, out_dir):
    from tfmesos_tpu_torch import runtime

    ctx = runtime.initialize(
        runtime.TaskContext(rank=rank, world_size=world,
                            coordinator=f"127.0.0.1:{port}"), device="cpu")
    with open(f"{out_dir}/cases.json") as f:
        cases = json.load(f)
    for case in cases:
        mesh = _case_mesh(case, ctx.rank, world)
        if mesh is None:
            continue
        out = KINDS[case["kind"]](case, mesh, out_dir)
        if ctx.rank == 0:
            if case["kind"].startswith("batcher"):
                with open(f"{out_dir}/{case['name']}.json", "w") as f:
                    json.dump(out, f)
            else:
                np.savez(f"{out_dir}/{case['name']}.npz", **out)
    runtime.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
