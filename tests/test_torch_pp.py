"""The transformer over a pp mesh (``models/transformer.py``'s pipeline
branch and ``train_step_1f1b``, ``make_train_step(grads_fn=)``) on one
gloo group of 4 CPU ranks (``tests/torch_mesh_worker.py``, started once
for the file) against the JAX package on the same mesh of its 8 virtual
CPU devices:

* the loss, the metrics, the whole-vocab logits, every gradient leaf
  (averaged as the step averages it, gathered whole) and the params
  after one AdamW step of ``make_train_step(mesh=, param_specs=)``
  against JAX's ``loss_fn`` (gpipe, circular) or ``train_step_1f1b``
  (through the step's ``grads_fn``) and optax's AdamW on its gradients
  (the update JAX's ``make_train_step`` applies): pp=2 gpipe, pp=2 x
  dp=2, pp=2 x tp=2 with GQA, circular with 2 virtual stages, 1F1B at
  v=1 and v=2 (on pp=2 x dp=2), pp=2 x tp=2 on 1F1B (the vocab-parallel
  tail, and an odd vocab's replicated tail), pp=2 x ep=2 in the dense
  top-k MoE on 1F1B and in switch on gpipe, pp=2 x sp=2 (the einsum
  ring under gpipe, the K/V gather under 1F1B) and remat;
* ``tests/test_torch_pp_cli.py`` drives the entry points.

Inputs: numpy with a seed; params from the JAX ``init_params`` through
``convert.py``.  Tolerance (float32): atol 1e-5, rtol 1e-4 (the JAX
fused-CE and pipeline tests' bound, as ``test_torch_sp.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from torch_mesh_worker import run_cases
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu.models import transformer as jt
from tfmesos_tpu.parallel.mesh import build_mesh as j_build_mesh
from tfmesos_tpu_torch import convert

WORLD = 4
BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=32,
            max_seq_len=64, n_kv_heads=2, z_loss=1e-3, ce_chunk=16)
DENSE = dict(BASE, n_experts=4, top_k=2)
SWITCH = dict(BASE, n_experts=4, top_k=2, moe_impl="switch",
              capacity_factor=1.0)
# Two virtual stages a rank: circular forward passes, interleaved 1F1B.
V2 = dict(BASE, n_layers=4, pp_virtual_stages=2, pp_schedule="circular")
# name: (ranks, axes, config, 1F1B)
TRAIN = {
    "pp2": (2, {"pp": 2}, BASE, False),
    "pp2dp2": (4, {"dp": 2, "pp": 2}, BASE, False),
    "pp2tp2_gqa": (4, {"pp": 2, "tp": 2}, BASE, False),
    "pp2_circular_v2": (2, {"pp": 2}, V2, False),
    "pp2_1f1b": (2, {"pp": 2}, BASE, True),
    "pp2dp2_1f1b_v2": (4, {"dp": 2, "pp": 2}, V2, True),
    "pp2tp2_1f1b": (4, {"pp": 2, "tp": 2}, BASE, True),
    "pp2tp2_1f1b_odd_vocab": (4, {"pp": 2, "tp": 2},
                              dict(BASE, vocab_size=65), True),
    "pp2ep2_dense_1f1b": (4, {"pp": 2, "ep": 2}, DENSE, True),
    "pp2ep2_switch": (4, {"pp": 2, "ep": 2}, SWITCH, False),
    "pp2sp2_ring": (4, {"pp": 2, "sp": 2}, BASE, False),
    "pp2sp2_1f1b": (4, {"pp": 2, "sp": 2}, BASE, True),
    "pp2_remat": (2, {"pp": 2}, dict(BASE, remat=True), False),
}


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5,
                               rtol=1e-4, err_msg=what)


def _jax_params(kw, seed):
    cfg = jt.TransformerConfig(dtype=jnp.float32, **kw)
    return cfg, jax.tree_util.tree_map(
        np.asarray, jt.init_params(cfg, jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case run once in one 4-rank gloo group."""
    d = tmp_path_factory.mktemp("pp")
    np.save(d / "train.tokens.npy", np.random.default_rng(0).integers(
        0, 64, (4, 17)).astype(np.int64))
    cases = []
    for name, (n, axes, kw, one_f) in TRAIN.items():
        _, jp = _jax_params(kw, 2)
        convert.save_npz(convert.params_from_jax(jp),
                         d / f"{name}.params.npz")
        cases.append(dict(name=name, kind="train", axes=axes, ranks=n,
                          cfg=kw, params=f"{name}.params.npz",
                          tokens="train.tokens.npy", **{"1f1b": one_f}))
    run_cases(cases, WORLD, d, timeout=300.0)
    return d


@functools.lru_cache(maxsize=None)
def _jax_run(name, d):
    n, axes, kw, one_f = TRAIN[name]
    cfg, jp = _jax_params(kw, 2)
    mesh = j_build_mesh(axes, devices=jax.devices()[:n])
    tokens = np.load(d / "train.tokens.npy")
    params = jax.tree_util.tree_map(jnp.asarray, jp)
    batch = {"tokens": jnp.asarray(tokens)}
    loss_fn = lambda p, b: jt.loss_fn(cfg, p, b, mesh)      # noqa: E731
    if one_f:
        def grads_fn(p, b):
            loss, g = jt.train_step_1f1b(cfg, p, b, mesh)
            return g, loss, {"perplexity": jnp.exp(loss)}

        grads, loss, metrics = jax.jit(grads_fn)(params, batch)
    else:
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, batch)
    # 1F1B's forward-only passes are the gpipe / circular forward,
    # checked by the cases without it.
    logits = None if one_f else np.asarray(jax.jit(
        lambda p, t: jt.forward(cfg, p, t, mesh))(
            params, batch["tokens"][:, :-1]))
    # One AdamW step on those gradients (what make_train_step applies).
    opt = optax.adamw(1e-3, weight_decay=0.01)
    updates, _ = jax.jit(opt.update)(grads, opt.init(params), params)
    after = optax.apply_updates(params, updates)
    flat = lambda t: convert.flatten(convert.params_from_jax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, t)))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            logits, flat(grads), flat(after))


@pytest.mark.parametrize("name", list(TRAIN))
def test_pp_loss_grads_and_step_match_jax(ranks, name):
    """The case's loss and metrics on the pp mesh, its logits (whole
    vocab and sequence), the eval loss, each gradient leaf gathered
    whole and the params after one AdamW step, against JAX on the same
    mesh."""
    got = dict(np.load(ranks / f"{name}.npz"))
    loss, metrics, logits, grads, after = _jax_run(name, ranks)
    _close(got["loss"], loss, "loss")
    assert sorted(k[7:] for k in got if k.startswith("metric/")) == \
        sorted(metrics)
    for k, v in metrics.items():
        _close(got[f"metric/{k}"], v, f"metric {k}")
    # The eval step's and the train step's loss: the same objective.
    _close(got["eval_loss"], loss, "eval loss")
    _close(got["step_loss"], loss, "step loss")
    if logits is not None:
        _close(got["logits"], logits, "logits")
    assert sorted(k[5:] for k in got if k.startswith("grad/")) == \
        sorted(grads)
    for k, v in grads.items():
        _close(got[f"grad/{k}"], v.numpy(), f"grad {k}")
    for k, v in after.items():
        _close(got[f"after/{k}"], v.numpy(), f"step {k}")
