"""The port's MoE against the JAX package on the CPU:

* ``parallel/moe.py``: the routing (``combine`` scattered from the kept
  triples, drops at tight capacity, top-1 and top-2, the overflow
  fraction, the aux losses), the reference's output, and the gradients
  through the dispatch of the tokens, router and expert weights,
  against the JAX ``_routing`` / ``switch_moe_reference`` and their
  ``jax.vjp``;
* ``switch_moe`` over ep=2 and dp=2 x ep=2 on a gloo group of 4 CPU
  ranks (``tests/torch_mesh_worker.py``, started once for the file):
  the output, aux and every gradient against the JAX reference (per
  data shard under dp, as the JAX sharded tests hold it);
* the JAX ``tests/test_moe.py`` cases that need neither a JAX mesh nor
  JAX autodiff through the function (routing drops, top-2 mixing,
  overflow) through ``port_cases``, the port's reference behind
  ``tests/torch_moe_bridge.py``;
* the transformer with dense, switch and shared experts: forward,
  loss, MoE metrics and every gradient leaf; ``quantize_params`` over
  an MoE tree (bit-exact values and scales, switch experts left fp);
  the MoE leaves through ``convert.py`` both ways;
* an MoE config served by the port's ``ContinuousBatcher`` against the
  JAX batcher on the same requests: switch (a row's output depends on
  the other rows of its tick through capacity, so identical streams
  need the same rows in every tick), dense, and dense over int8
  weights, streams identical.

Inputs: numpy with a seed; params from the JAX ``init_params`` through
``convert.py``.  Tolerances (float32): the reference and its gradients
within 1e-5 (gathers and index sums against one-hot products: the same
terms in other orders); the mesh within 2e-5 (the JAX sharded tests'
bound); the transformer within atol 1e-5 / rtol 1e-4 (as
``test_torch_tp.py``); quantized values bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_cases import port_cases
from torch_mesh_worker import run_cases
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu import serving as js
from tfmesos_tpu.models import transformer as jt
from tfmesos_tpu.parallel import moe as jm
from tfmesos_tpu_torch import convert
from tfmesos_tpu_torch import serving as ts
from tfmesos_tpu_torch.models import transformer as tt
from tfmesos_tpu_torch.parallel import moe as tm

_PORTED = ("test_reference_routing_drops_overflow",
           "test_topk_combines_two_experts",
           "test_overflow_frac_reports_dropped_assignments")
globals().update({k: v for k, v in port_cases(
    "test_moe.py",
    subs=[(r"from tfmesos_tpu_torch\.parallel\.moe import",
           "from torch_moe_bridge import")]).items() if k in _PORTED})

WORLD = 4
D, F, E = 16, 32, 8


def _close(got, want, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)


def _moe_inputs(n, seed, e=E):
    rng = np.random.default_rng(seed)

    def f(*s):
        return (rng.standard_normal(s) / np.sqrt(s[-2] if len(s) > 1
                                                 else 1)).astype(np.float32)

    return {"x": rng.standard_normal((n, D)).astype(np.float32),
            "router": f(D, e), "w_gate": f(e, D, F), "w_up": f(e, D, F),
            "w_down": f(e, F, D),
            "do": rng.standard_normal((n, D)).astype(np.float32)}


ARGS = ("x", "router", "w_gate", "w_up", "w_down")


@functools.lru_cache(maxsize=None)
def _jax_ref_fn(cf, k):
    def f(x, router, w_gate, w_up, w_down, do):
        (out, aux), vjp = jax.vjp(
            lambda *args: jm.switch_moe_reference(
                *args, capacity_factor=cf, top_k=k, return_aux=True),
            x, router, w_gate, w_up, w_down)
        zero = {kk: jnp.zeros_like(v) for kk, v in aux.items()}
        return out, aux, vjp((do, zero))
    return jax.jit(f)


def _jax_ref(a, cf, k):
    """The JAX reference's output, aux and gradients (vjp with ``do``)."""
    return _jax_ref_fn(cf, k)(*(jnp.asarray(a[n]) for n in ARGS + ("do",)))


@pytest.mark.parametrize("k,cf", [(1, 1.25), (2, 1.25), (1, 0.25),
                                  (2, 0.25), (2, 4.0)])
def test_routing_and_reference_match_jax(k, cf):
    """``combine`` scattered from the kept (token, expert, slot) triples
    equals the JAX product over [n, k, E, C] — slot priority
    choice-major, drops past capacity — and the reference's output, aux
    and gradients (tokens, router, each expert weight) equal JAX's."""
    n = 64
    a = _moe_inputs(n, 10 * k + int(4 * cf))
    cap = jm._capacity(n, E, cf, k)
    want, _ = jm._routing(jnp.asarray(a["x"]), jnp.asarray(a["router"]), E,
                          cap, k)
    route, _ = tm._routing(torch.from_numpy(a["x"]),
                           torch.from_numpy(a["router"]), E, cap, k)
    _close(route.dense().numpy(), want, 1e-6, what="combine")
    out, aux, grads = _jax_ref(a, cf, k)
    leaves = [torch.from_numpy(a[n_]).requires_grad_(True) for n_ in ARGS]
    got, taux = tm.switch_moe_reference(*leaves, capacity_factor=cf,
                                        top_k=k, return_aux=True)
    tgrads = torch.autograd.grad(got, leaves, torch.from_numpy(a["do"]))
    _close(got.detach().numpy(), out, 1e-5, what="out")
    for key, v in aux.items():
        _close(float(taux[key]), float(v), 1e-6, 1e-6, key)
    for name, g, w in zip(ARGS, tgrads, grads):
        _close(g.numpy(), w, 1e-5, 1e-5, f"d{name}")
    if cf < 1:
        assert 0.0 < float(taux["overflow_frac"]) < 1.0


MESH = {"ep2_k1": (2, {"ep": 2}, 1), "ep2_k2": (2, {"ep": 2}, 2),
        "dp2ep2_k2": (4, {"dp": 2, "ep": 2}, 2)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The sharded cases run once in one 4-rank gloo group."""
    d = tmp_path_factory.mktemp("moe")
    cases = []
    for i, (name, (n, axes, k)) in enumerate(MESH.items()):
        np.savez(d / f"{name}.in.npz", **_moe_inputs(48, 100 + i))
        cases.append(dict(name=name, kind="moe", axes=axes, ranks=n,
                          inputs=f"{name}.in.npz", top_k=k,
                          capacity_factor=1.25))
    run_cases(cases, WORLD, d)
    return d


@pytest.mark.parametrize("name", list(MESH))
def test_switch_moe_over_ep_matches_reference(ranks, name):
    """``switch_moe`` with the experts cut over ep (two all-to-all hops)
    against the JAX reference: the same output and aux, and gradients of
    the tokens, router and every expert weight (each expert's kept to
    one copy of its tokens, though every ep rank dispatches them).
    Under dp routing and capacity are per data shard: the reference
    runs on each shard, aux averaged, gradients summed."""
    n, axes, k = MESH[name]
    a = dict(np.load(ranks / f"{name}.in.npz"))
    got = np.load(ranks / f"{name}.npz")
    shards = axes.get("dp", 1)
    parts = [_jax_ref({kk: (np.split(v, shards)[s] if kk in ("x", "do")
                            else v) for kk, v in a.items()}, 1.25, k)
             for s in range(shards)]
    _close(got["out"], np.concatenate([p[0] for p in parts]), 2e-5,
           what="out")
    _close(got["dx"], np.concatenate([p[2][0] for p in parts]), 2e-5,
           what="dx")
    for i, name_ in enumerate(ARGS[1:], start=1):
        _close(got[f"d{name_}"], sum(np.asarray(p[2][i]) for p in parts),
               2e-5, what=f"d{name_}")
    for key in parts[0][1]:
        _close(float(got[f"aux/{key}"]),
               np.mean([float(p[1][key]) for p in parts]), 1e-5, 1e-5, key)


BASE = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2, d_ff=32,
            max_seq_len=64)
MODELS = {
    "dense": dict(n_experts=4, top_k=2),
    "switch_k1": dict(n_experts=4, top_k=1, moe_impl="switch"),
    "switch_k2": dict(n_experts=4, top_k=2, moe_impl="switch",
                      capacity_factor=1.0),
    "dense_shared": dict(n_experts=4, top_k=2, n_shared_experts=2),
    "switch_shared": dict(n_experts=4, top_k=1, moe_impl="switch",
                          n_shared_experts=1),
}


def _pair(kw, seed=0):
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **BASE, **kw)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **BASE, **kw)
    jp = jax.tree_util.tree_map(
        np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, jp, tcfg, convert.params_from_jax(jp)


@pytest.mark.parametrize("name", list(MODELS))
def test_moe_transformer_matches_jax(name):
    """Forward logits, the loss with the router's losses, the MoE metrics
    and every gradient leaf against JAX on one device."""
    jcfg, jp, tcfg, tp = _pair(MODELS[name])
    tokens = np.random.default_rng(1).integers(0, 64, (2, 17))
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(jcfg, p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True))(jparams)
    jlog = jt.forward(jcfg, jparams, jnp.asarray(tokens[:, :-1]))
    flat = convert.flatten(tp)
    for v in flat.values():
        v.requires_grad_(True)
    tl, tmet = tt.loss_fn(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(tl, list(flat.values()))
    with torch.no_grad():
        tlog = tt.forward(tcfg, tp, torch.from_numpy(tokens[:, :-1]))
    _close(tlog.numpy(), jlog, 1e-5, 1e-4, "logits")
    _close(float(tl), float(jl), 1e-5, 1e-4, "loss")
    assert sorted(tmet) == sorted(jmet)
    for k, v in jmet.items():
        _close(float(tmet[k]), float(v), 1e-5, 1e-4, k)
    want = convert.flatten(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jg)))
    assert sorted(want) == sorted(flat)
    for k, g in zip(flat, grads):
        _close(g.numpy(), want[k].numpy(), 1e-5, 1e-4, f"grad {k}")


@pytest.mark.parametrize("name", ["dense_shared", "switch_shared"])
def test_moe_quantize_params_and_convert_match_jax(name):
    """``quantize_params`` over an MoE tree: every quantizable leaf's
    values and scales bit-equal to JAX's (the router stays fp; switch
    experts stay fp), the int8 forward within the float bound; and the
    MoE leaves carried through ``convert.py`` both ways bit for bit."""
    jcfg, jp, tcfg, tp = _pair(MODELS[name])
    jq = jt.quantize_params(jcfg, jax.tree_util.tree_map(jnp.asarray, jp))
    tq = tt.quantize_params(tcfg, tp)
    want = convert.flatten(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jq)))
    got = convert.flatten(tq)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert ("layers/e_gate/values" in got) == (MODELS[name].get(
        "moe_impl") != "switch")
    assert "layers/router" in got and "layers/s_gate/values" in got
    tokens = np.random.default_rng(2).integers(0, 64, (2, 9))
    _close(tt.forward(tcfg, tq, torch.from_numpy(tokens)).numpy(),
           jt.forward(jcfg, jq, jnp.asarray(tokens)), 1e-5, 1e-4, "int8")
    back = convert.params_from_jax(convert.params_to_numpy(tp))
    for k, v in convert.flatten(back).items():
        assert torch.equal(v, convert.flatten(tp)[k]), k
    assert {"router", "e_gate", "e_up", "e_down", "s_gate", "s_up",
            "s_down"} <= set(back["layers"])


SERVE = {"switch": dict(n_experts=4, top_k=2, moe_impl="switch",
                        capacity_factor=1.0),
         "dense": dict(n_experts=4, top_k=2, n_shared_experts=1),
         "dense_int8": dict(n_experts=4, top_k=2)}


@pytest.mark.parametrize("name", list(SERVE))
def test_moe_batcher_streams_identical_to_jax(name):
    """An MoE config through both batchers on the same weights and
    requests (more requests than rows, staggered lengths): greedy
    streams identical, the pool's high-water mark and the prefill count
    equal.  ``dense_int8`` serves ``quantize_params`` trees."""
    jcfg, jp, tcfg, tp = _pair(dict(SERVE[name]), seed=3)
    if name.endswith("int8"):
        jp = jt.quantize_params(jcfg, jax.tree_util.tree_map(jnp.asarray,
                                                              jp))
        tp = tt.quantize_params(tcfg, tp)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 64, n).astype(np.int32)
               for n in (3, 17, 30, 9, 21)]
    new = [6, 9, 5, 8, 7]
    kw = dict(rows=2, page_size=16, prefill_bucket=16)
    tb = ts.ContinuousBatcher(tcfg, tp, device="cpu", **kw)
    got = {c.rid: list(c.tokens) for c in tb.run(
        ts.Request(p, n) for p, n in zip(prompts, new))}
    jb = js.ContinuousBatcher(jcfg, jp, **kw)
    want = {c.rid: list(c.tokens) for c in jb.run(
        js.Request(p, n) for p, n in zip(prompts, new))}
    assert got == want
    assert tb.peak_pages_used == jb.peak_pages_used
    assert tb.prefills == len(prompts)


def test_moe_config_fields_and_refusals():
    """The JAX config's MoE and sp fields with its defaults; shared
    experts without routed ones refused as in JAX; an sp or ep mesh
    refused for serving with the JAX ``_check_sharded_paged`` message."""
    for f in ("n_experts", "top_k", "n_shared_experts", "moe_impl",
              "capacity_factor", "router_aux_weight", "router_z_weight",
              "sp_impl"):
        assert getattr(tt.TransformerConfig(), f) == getattr(
            jt.TransformerConfig(), f), f
    cfg = dataclasses.replace(tt.TransformerConfig(**BASE),
                              n_shared_experts=1)
    with pytest.raises(ValueError, match="n_shared_experts requires"):
        tt.init_params(cfg, torch.Generator().manual_seed(0))
    from tfmesos_tpu_torch.parallel.mesh import LocalMesh

    with pytest.raises(ValueError, match=r"sharded paged decode runs on "
                       r"data \(dp/fsdp\) x tp meshes; got axes \['ep'\]"):
        tt._check_serving_mesh(LocalMesh("cpu", axes={"ep": 2}))
