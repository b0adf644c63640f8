"""Sequence and expert parallelism of the port on one gloo group of 4 CPU
ranks (``tests/torch_mesh_worker.py``, started once for the file)
against the JAX package:

* ring attention (the kernel ring and the einsum ring: causal, full,
  windows 1, 7, 16 and 40 across shards of 8, GQA broadcast up) and
  Ulysses (GQA at kv 4, where sp divides the kv heads, and kv 2, where
  it does not) over sp=4, against JAX ``ring_attention`` /
  ``ulysses_attention`` on a 4-device sp mesh: outputs and dq/dk/dv;
* the transformer's loss, metrics, whole-vocab logits, every gradient
  leaf gathered whole and one AdamW step of
  ``make_train_step(mesh=, param_specs=)`` on sp=2 (dense MoE, ring),
  sp=2 with Ulysses, ep=2 (switch MoE with a shared expert),
  ep=2 x tp=2 (dense MoE, experts cut per expert over tp), tp=2
  (switch: the cut FFNs' partial outputs all-reduced after combining),
  sp=2 x ep=2 (switch: the tokens gathered over sp before routing) and
  dp=2 x sp=2 (dense MoE: router statistics over the global batch) and
  dp=2 (switch without ep: the tokens gathered over dp before routing,
  capacity a competition over the global batch as in JAX), against the JAX loss and step on one device;
* ``tfrun --mesh sp=2`` and ``pp=2`` accepted.

Inputs: numpy with a seed; params from the JAX ``init_params`` through
``convert.py``.  Tolerances (float32): attention outputs and gradients
within 2e-5 (the ring merges shards by their logsumexps, JAX's einsum
ring by online softmax: sums in other orders); the transformer within
atol 1e-5 / rtol 1e-4 (the JAX fused-CE tests' bound, as
``test_torch_tp.py``).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from torch_mesh_worker import run_cases
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu.models import transformer as jt
from tfmesos_tpu.parallel.mesh import build_mesh as j_build_mesh
from tfmesos_tpu.parallel.ring_attention import ring_attention as j_ring
from tfmesos_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from tfmesos_tpu.train.trainer import make_train_step as j_make_train_step
from tfmesos_tpu_torch import convert

WORLD = 4
SP = 4
B, T, H, D = 2, 32, 8, 8
ATTN = {
    "ring_causal": dict(kv=H),
    "ring_full": dict(kv=H, causal=False),
    "ring_w1": dict(kv=H, window=1),
    "ring_w7": dict(kv=H, window=7),
    "ring_w16": dict(kv=H, window=16),
    "ring_w40": dict(kv=H, window=40),
    "ring_gqa": dict(kv=2),
    "ring_einsum_w7": dict(kv=H, window=7, impl="einsum"),
    "ulysses_kv4": dict(kv=4, sp_impl="ulysses"),
    "ulysses_kv2": dict(kv=2, sp_impl="ulysses"),
    "ulysses_w7": dict(kv=4, sp_impl="ulysses", window=7),
}

BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=32,
            max_seq_len=64, n_kv_heads=2, z_loss=1e-3, ce_chunk=16)
DENSE = dict(BASE, n_experts=4, top_k=2)
SWITCH = dict(BASE, n_experts=4, top_k=2, moe_impl="switch",
              capacity_factor=1.0)
TRAIN = {
    "sp2": (2, {"sp": 2}, DENSE),
    "sp2_ulysses": (2, {"sp": 2}, dict(BASE, sp_impl="ulysses")),
    "ep2": (2, {"ep": 2}, dict(SWITCH, n_shared_experts=1)),
    "ep2tp2": (4, {"ep": 2, "tp": 2}, DENSE),
    "tp2_switch": (2, {"tp": 2}, SWITCH),
    "sp2ep2": (4, {"sp": 2, "ep": 2}, SWITCH),
    "dp2sp2": (4, {"dp": 2, "sp": 2}, DENSE),
    "dp2_switch": (2, {"dp": 2}, SWITCH),
}


def _close(got, want, atol, rtol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)


def _jax_params(kw, seed):
    cfg = jt.TransformerConfig(dtype=jnp.float32, **kw)
    return cfg, jax.tree_util.tree_map(
        np.asarray, jt.init_params(cfg, jax.random.PRNGKey(seed)))


def _attn_inputs(kv, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"q": f(B, T, H, D), "k": f(B, T, kv, D), "v": f(B, T, kv, D),
            "do": f(B, T, H, D)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case run once in one 4-rank gloo group: the directory of
    their results and the inputs."""
    d = tmp_path_factory.mktemp("sp")
    cases = []
    for i, (name, kw) in enumerate(ATTN.items()):
        np.savez(d / f"{name}.in.npz", **_attn_inputs(kw["kv"], i))
        cases.append(dict(name=name, kind="attn", axes={"sp": SP},
                          inputs=f"{name}.in.npz",
                          **{k: v for k, v in kw.items() if k != "kv"}))
    np.save(d / "train.tokens.npy", np.random.default_rng(0).integers(
        0, 64, (4, 17)).astype(np.int64))
    for name, (n, axes, kw) in TRAIN.items():
        _, jp = _jax_params(kw, 2)
        convert.save_npz(convert.params_from_jax(jp),
                         d / f"{name}.params.npz")
        cases.append(dict(name=name, kind="train", axes=axes, ranks=n,
                          cfg=kw, params=f"{name}.params.npz",
                          tokens="train.tokens.npy"))
    run_cases(cases, WORLD, d, timeout=300.0)
    return d


def _jax_attn(name, d):
    kw = ATTN[name]
    arrs = {k: jnp.asarray(v) for k, v in np.load(d / f"{name}.in.npz")
            .items()}
    mesh = j_build_mesh({"sp": SP}, devices=jax.devices()[:SP])
    causal, window = kw.get("causal", True), kw.get("window")

    def f(q, k, v):
        if kw.get("sp_impl") == "ulysses":
            return j_ulysses(q, k, v, mesh, causal=causal, window=window)
        rep = q.shape[2] // k.shape[2]
        if rep > 1:
            k, v = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
        return j_ring(q, k, v, mesh, causal=causal, window=window)

    def fwd_bwd(q, k, v, do):
        o, vjp = jax.vjp(f, q, k, v)
        return (o,) + vjp(do)

    return jax.jit(fwd_bwd)(arrs["q"], arrs["k"], arrs["v"], arrs["do"])


@pytest.mark.parametrize("name", list(ATTN))
def test_ring_and_ulysses_match_jax(ranks, name):
    """The port's sp=4 attention (each rank its shard of the sequence)
    against the JAX sp-mesh function: the output and the gradients of
    q, k and v, gathered whole."""
    got = np.load(ranks / f"{name}.npz")
    for key, want in zip(("o", "dq", "dk", "dv"), _jax_attn(name, ranks)):
        _close(got[key], want, 2e-5, 2e-5, f"{name} {key}")


@functools.lru_cache(maxsize=None)
def _jax_train_cached(key, d):
    kw = dict(json.loads(key))
    cfg, jp = _jax_params(kw, 2)
    tokens = np.load(d / "train.tokens.npy")
    params = jax.tree_util.tree_map(jnp.asarray, jp)
    batch = {"tokens": jnp.asarray(tokens)}
    loss_fn = lambda p, b: jt.loss_fn(cfg, p, b)      # noqa: E731
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, batch)
    logits = jax.jit(lambda p, t: jt.forward(cfg, p, t))(
        params, batch["tokens"][:, :-1])
    opt = optax.adamw(1e-3, weight_decay=0.01)
    after, _, step_metrics = j_make_train_step(loss_fn, opt)(
        params, opt.init(params), batch)
    flat = lambda t: convert.flatten(convert.params_from_jax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, t)))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            np.asarray(logits), flat(grads), flat(after),
            float(step_metrics["loss"]))


@pytest.mark.parametrize("name", list(TRAIN))
def test_sp_ep_loss_grads_and_step_match_jax(ranks, name):
    """The case's loss and MoE metrics on the mesh, its logits (whole
    vocab and sequence), each gradient leaf (averaged over the data
    axes and sp, gathered whole) and the params after one AdamW step,
    against the JAX single-device run on the global batch."""
    got = dict(np.load(ranks / f"{name}.npz"))
    kw = TRAIN[name][2]
    loss, metrics, logits, grads, after, step_loss = _jax_train_cached(
        json.dumps(sorted(kw.items())), ranks)
    _close(got["loss"], loss, 1e-5, 1e-4, "loss")
    for k, v in metrics.items():
        _close(got[f"metric/{k}"], v, 1e-5, 1e-4, f"metric {k}")
    _close(got["eval_loss"], loss, 1e-5, 1e-4, "eval loss")
    _close(got["step_loss"], step_loss, 1e-5, 1e-4, "step loss")
    _close(got["logits"], logits, 1e-5, 1e-4, "logits")
    assert sorted(k[5:] for k in got if k.startswith("grad/")) == \
        sorted(grads)
    for k, v in grads.items():
        _close(got[f"grad/{k}"], v.numpy(), 1e-5, 1e-4, f"grad {k}")
    for k, v in after.items():
        _close(got[f"after/{k}"], v.numpy(), 1e-5, 1e-4, f"step {k}")


def test_tfrun_accepts_sp_and_refuses_pp_by_name(capfd):
    """``tfrun --mesh sp=2,ep=2`` parses (the axes reach the tasks);
    ``pp=2`` (ported since) runs its job too, and an unknown axis exits
    2 naming it."""
    from tfmesos_tpu_torch import cli

    assert cli.parse_mesh("sp=2,ep=2") == {"sp": 2, "ep": 2}
    assert cli.parse_mesh("dp=2,sp=2") == {"dp": 2, "sp": 2}
    assert cli.parse_mesh("pp=2,sp=2") == {"pp": 2, "sp": 2}
    rc = cli.main(["run", "-w", "2", "-s", "0", "--mesh", "pp=2", "--",
                   "true"])
    assert rc == 0
    capfd.readouterr()
    rc = cli.main(["run", "-w", "2", "-s", "0", "--mesh", "qq=2", "--",
                   "true"])
    assert rc == 2
    assert capfd.readouterr().err.strip() == (
        "tfrun: unknown mesh axis qq (the axes: dp, fsdp, pp, ep, sp, tp)")
