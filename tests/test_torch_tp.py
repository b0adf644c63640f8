"""The port's sharded model and trainer on a gloo group of 4 CPU ranks
(``tests/torch_mesh_worker.py``, started once for the file) against the
JAX package on one device: over dp2 x tp2 (GQA, the vocab-parallel
cross entropy, and the materialized logits), fsdp2 x tp2, dp2 x fsdp2
(the data-parallel fused cross entropy), tp4 (a vocab of 97 that tp
does not divide), fsdp4 (with the global-norm clip) and fsdp2 x tp2
under remat (each block's gathers and collectives run again in its
backward): the whole-vocab forward logits, the global batch's loss
(and ``make_eval_step(mesh=)``'s), every gradient leaf gathered whole,
and one AdamW step against the JAX global-batch step; z-loss on every
path.  Then sharded decode (``decode_step(mesh=)``) over a linear
and a paged cache, float32 and int8, ragged positions; and the
checkpoint round trip: saved under dp2 x tp2 (rank 0 writes the
gathered leaves), restored on one process and on two other meshes.

Inputs: numpy with a seed; params from the JAX ``init_params`` through
``convert.py``.  Tolerances (float32): forward, loss, gradients and the
step within atol 1e-5 / rtol 1e-4 (the JAX fused-CE tests' bound: the
shards sum in other orders); decode within 2e-4 (the JAX sharded
decode tests' bound); a restore bit for bit.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_mesh_worker import run_cases
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu.models import transformer as jt
from tfmesos_tpu.train.trainer import make_train_step as j_make_train_step
from tfmesos_tpu_torch import convert
from tfmesos_tpu_torch.models import transformer as tt
from tfmesos_tpu_torch.train import optim
from tfmesos_tpu_torch.train.checkpoint import CheckpointManager

WORLD = 4
GQA = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_ff=64,
           max_seq_len=64, n_kv_heads=2, z_loss=1e-3, ce_chunk=16)
MHA97 = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4, d_ff=64,
             max_seq_len=64, n_kv_heads=4, z_loss=1e-3, ce_chunk=16)
TRAIN = {
    "dp2tp2": ({"dp": 2, "tp": 2}, GQA, {}),
    "dp2tp2_unfused": ({"dp": 2, "tp": 2}, dict(GQA, fused_ce=False), {}),
    "fsdp2tp2": ({"fsdp": 2, "tp": 2}, GQA, {}),
    "dp2fsdp2": ({"dp": 2, "fsdp": 2}, GQA, {}),
    "tp4": ({"tp": 4}, MHA97, {}),
    "fsdp4_clip": ({"fsdp": 4}, GQA, {"max_norm": 0.5}),
    "fsdp2tp2_remat": ({"fsdp": 2, "tp": 2}, dict(GQA, remat=True), {}),
}
DECODE = {
    "linear": dict(paged=False, quantized=False),
    "linear_int8": dict(paged=False, quantized=True),
    "paged": dict(paged=True, quantized=False),
    "paged_int8_weights": dict(paged=True, quantized=True,
                               int8_weights=True),
}
RESTORE = {"restore_fsdp2tp2": {"fsdp": 2, "tp": 2},
           "restore_fsdp4": {"fsdp": 4}}


def _close(got, want, atol, rtol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)


def _jax_params(kw, seed):
    cfg = jt.TransformerConfig(dtype=jnp.float32, **kw)
    return cfg, jax.tree_util.tree_map(
        np.asarray, jt.init_params(cfg, jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case run once in one 4-rank gloo group: the directory of
    their results and the inputs."""
    d = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    # One global batch for every train case (ids below both vocabs), so
    # cases of one config share their JAX reference.
    np.save(d / "train.tokens.npy",
            rng.integers(0, 97, (8, 17)).astype(np.int64))
    cases = []
    for name, (axes, kw, extra) in TRAIN.items():
        _, jp = _jax_params(kw, 2)
        convert.save_npz(convert.params_from_jax(jp), d / f"{name}.params.npz")
        cases.append(dict(name=name, kind="train", axes=axes,
                          cfg=kw, params=f"{name}.params.npz",
                          tokens="train.tokens.npy",
                          ckpt="ck" if name == "dp2tp2" else None, **extra))
    for name, axes in RESTORE.items():
        cases.append(dict(name=name, kind="restore", axes=axes,
                          cfg=GQA, ckpt="ck"))
    _, jp = _jax_params(GQA, 3)
    convert.save_npz(convert.params_from_jax(jp), d / "decode.params.npz")
    np.save(d / "decode.tokens.npy",
            rng.integers(0, 128, (4, 9)).astype(np.int64))
    np.save(d / "decode.steps.npy",
            rng.integers(0, 128, (4, 3)).astype(np.int64))
    np.save(d / "decode.pos.npy", np.asarray([9, 4, 7, 2], np.int64))
    for name, kw in DECODE.items():
        cases.append(dict(name=name, kind="decode", axes={"dp": 2, "tp": 2},
                          cfg=GQA, params="decode.params.npz",
                          tokens="decode.tokens.npy", steps="decode.steps.npy",
                          pos="decode.pos.npy", page_size=8,
                          pages_per_row=4, max_len=32, **kw))
    run_cases(cases, WORLD, d)
    return d


@functools.lru_cache(maxsize=None)
def _jax_train_cached(key, d):
    kw, extra = (dict(x) for x in json.loads(key))
    cfg, jp = _jax_params(kw, 2)
    tokens = np.load(d / "train.tokens.npy")
    params = jax.tree_util.tree_map(jnp.asarray, jp)
    batch = {"tokens": jnp.asarray(tokens)}
    loss_fn = lambda p, b: jt.loss_fn(cfg, p, b)      # noqa: E731
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, batch)
    logits = jax.jit(lambda p, t: jt.forward(cfg, p, t))(
        params, batch["tokens"][:, :-1])
    opt = optax.adamw(1e-3, weight_decay=0.01)
    if extra.get("max_norm"):
        opt = optax.chain(optax.clip_by_global_norm(extra["max_norm"]), opt)
    step = j_make_train_step(loss_fn, opt)
    after, _, metrics = step(params, opt.init(params), batch)
    flat = lambda t: convert.flatten(convert.params_from_jax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, t)))
    return float(loss), np.asarray(logits), flat(grads), flat(after), \
        float(metrics["loss"])


def _jax_train(name, d):
    """The JAX single-device run of a case's config and extra, one run
    per distinct pair: remat and the materialized logits change no
    number, so their cases take the plain config's run."""
    _, kw, extra = TRAIN[name]
    kw = {k: v for k, v in kw.items() if k not in ("remat", "fused_ce")}
    return _jax_train_cached(json.dumps([sorted(kw.items()),
                                         sorted(extra.items())]), d)


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_forward_loss_grads_and_step_match_jax(ranks, name):
    """The case's logits (whole vocab, every data shard's rows), the
    global batch's loss on the mesh, each gradient leaf (averaged over
    the data axes, gathered whole) and the params after one AdamW step
    of ``make_train_step(mesh=, param_specs=)``, against the JAX
    single-device run on the global batch."""
    got = dict(np.load(ranks / f"{name}.npz"))
    loss, logits, grads, after, step_loss = _jax_train(name, ranks)
    _close(got["loss"], loss, 1e-5, 1e-4, "loss")
    _close(got["eval_loss"], loss, 1e-5, 1e-4, "eval loss")
    _close(got["step_loss"], step_loss, 1e-5, 1e-4, "step loss")
    _close(got["logits"], logits, 1e-5, 1e-4, "logits")
    assert sorted(k[5:] for k in got if k.startswith("grad/")) == \
        sorted(grads)
    for k, v in grads.items():
        _close(got[f"grad/{k}"], v.numpy(), 1e-5, 1e-4, f"grad {k}")
    for k, v in after.items():
        _close(got[f"after/{k}"], v.numpy(), 1e-5, 1e-4, f"step {k}")


def _jax_decode(kw, d):
    cfg, jp = _jax_params(GQA, 3)
    params = jax.tree_util.tree_map(jnp.asarray, jp)
    if kw.get("int8_weights"):
        params = jt.quantize_params(cfg, params)
    tokens = jnp.asarray(np.load(d / "decode.tokens.npy"), jnp.int32)
    steps = jnp.asarray(np.load(d / "decode.steps.npy"), jnp.int32)
    pos = jnp.asarray(np.load(d / "decode.pos.npy"), jnp.int32)
    q = kw["quantized"]
    b = tokens.shape[0]
    if kw["paged"]:
        ps, np_, nd = 8, 4, 2
        per = (b // nd) * np_ + 1          # a data shard's sub-pool
        cache = jt.init_paged_cache(cfg, nd * per, ps, quantized=q)
        local = np.arange(b // nd)[:, None] * np_ + 1 + np.arange(np_)
        table = np.concatenate([local + s * per for s in range(nd)])
        cache["pages"] = jnp.asarray(table, jnp.int32)
    else:
        cache = jt.init_cache(cfg, b, 32, quantized=q)
    step = jax.jit(lambda p, c, t, at: jt.decode_step(cfg, p, c, t, at))
    outs = []
    # The prefill at the python int 0 (attending only to itself, as the
    # port's does), the steps through the cache.
    lg, cache = jt.decode_step(cfg, params, cache, tokens, 0)
    outs.append(np.asarray(lg))
    for i in range(steps.shape[1]):
        lg, cache = step(params, cache, steps[:, i:i + 1], pos + i)
        outs.append(np.asarray(lg))
    return outs


@pytest.mark.parametrize("name", list(DECODE))
def test_sharded_decode_matches_jax_one_device(ranks, name):
    """``decode_step(mesh=)`` on dp2 x tp2 (each data shard its rows and
    sub-pool, each tp rank its kv heads; the write and the kernel's
    plain version per rank): a prefill, then three ragged one-token
    steps, every logit against the JAX single-device decode."""
    got = dict(np.load(ranks / f"{name}.npz"))
    want = _jax_decode(DECODE[name], ranks)
    assert len(got) == len(want)
    for i, w in enumerate(want):
        _close(got[f"logits{i}"], w, 2e-4, 2e-4, f"{name} call {i}")


@pytest.mark.parametrize("name", list(RESTORE))
def test_checkpoint_saved_on_one_mesh_restores_on_another(ranks, name):
    """The dp2 x tp2 state (params and AdamW moments after one step,
    saved with the leaves gathered whole) restores onto another mesh's
    blocks and onto one process, equal to JAX's step, bit for bit
    across the restores."""
    got = dict(np.load(ranks / f"{name}.npz"))
    step = dict(np.load(ranks / "dp2tp2.npz"))
    assert int(got["count"]) == 1
    tcfg = tt.TransformerConfig(dtype=torch.float32, **GQA)
    one = tt.init_params(tcfg, torch.Generator().manual_seed(1))
    opt = optim.adamw(1e-3)
    state = opt.init(one)
    back = CheckpointManager(ranks / "ck").restore(
        {"params": one, "opt_state": state})
    assert back["opt_state"].count == 1
    for k, v in convert.flatten(one).items():
        np.testing.assert_array_equal(got[f"params/{k}"], v.detach().numpy())
        np.testing.assert_array_equal(got[f"params/{k}"], step[f"after/{k}"])
    for k, v in state.moments()["exp_avg"].items():
        np.testing.assert_array_equal(got[f"exp_avg/{k}"], v.numpy())
