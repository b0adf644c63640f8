"""Pipeline parallelism of the port (``parallel/pipeline.py``) against
the JAX package's ``parallel/pipeline.py``:

* ``_schedule_1f1b``'s timetables equal JAX's, kind, microbatch and lap
  of every tick, over pp 1-4, m 1-8, v 1-3 (pure Python);
* ``pipeline_apply`` (gpipe on pp=2 x dp=2 and pp=4, circular with 2
  virtual stages, ``with_aux``, ``seq_axis`` over pp=2 x sp=2, a manual
  tp stage on pp=2 x tp=2) and ``pipeline_train_1f1b`` (v 1 and 2, a
  stage aux with tail params, a manual tp stage) on one gloo group of 4
  CPU ranks (``tests/torch_mesh_worker.py``, started once for the
  file), each rank its chunks and its share of the batch: outputs, aux,
  loss, the gathered gradients and dx against JAX's functions on the
  same mesh of its 8 virtual CPU devices;
* bubble-heavy pp=4 with one microbatch, both schedules, inside the
  file's one timeout;
* JAX's validation messages.

Inputs: numpy with a seed.  Tolerance (float32): atol 1e-5, rtol 1e-4
(the JAX pipeline tests' bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mesh_worker import run_cases
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu.parallel import pipeline as jpipe
from tfmesos_tpu.parallel.collectives import (broadcast_replicated_grad,
                                              psum_replicated_grad)
from tfmesos_tpu.parallel.mesh import build_mesh as j_build_mesh
from tfmesos_tpu_torch.parallel import pipeline as tpipe

WORLD = 4
DIM, FFN = 8, 16
ATOL, RTOL = 1e-5, 1e-4
P = jax.sharding.PartitionSpec

# name: (axes, mode, stage, kw); the batch is 8 rows ([8, 6, DIM] with
# a sequence dim), the chunks pp x v.
CASES = {
    "apply_gpipe_pp2dp2": ({"pp": 2, "dp": 2}, "apply", "tanh", dict(m=2)),
    "apply_gpipe_pp4": ({"pp": 4}, "apply", "tanh", dict(m=4)),
    "apply_circular_v2": ({"pp": 2, "dp": 2}, "apply", "tanh",
                          dict(m=2, schedule="circular", v=2)),
    "apply_aux": ({"pp": 2, "dp": 2}, "apply", "aux",
                  dict(m=2, aux=["abs", "sq"])),
    "apply_seq": ({"pp": 2, "sp": 2}, "apply", "aux",
                  dict(m=2, aux=["abs", "sq"], seq_axis="sp")),
    "apply_tp": ({"pp": 2, "tp": 2}, "apply", "tp", dict(m=2)),
    "apply_bubble_pp4_m1": ({"pp": 4}, "apply", "tanh", dict(m=1)),
    "1f1b_pp2dp2": ({"pp": 2, "dp": 2}, "1f1b", "tanh", dict(m=2)),
    "1f1b_pp4": ({"pp": 4}, "1f1b", "tanh", dict(m=4)),
    "1f1b_v2": ({"pp": 2, "dp": 2}, "1f1b", "tanh", dict(m=2, v=2)),
    "1f1b_aux_tail": ({"pp": 2, "dp": 2}, "1f1b", "stage_aux",
                      dict(m=2, tail=True)),
    "1f1b_tp": ({"pp": 2, "tp": 2}, "1f1b", "tp", dict(m=2)),
    "1f1b_bubble_pp4_m1": ({"pp": 4}, "1f1b", "tanh", dict(m=1)),
}


def _inputs(name):
    axes, mode, stage, kw = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    n = axes.get("pp", 1) * kw.get("v", 1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    shape = (8, 6, DIM) if kw.get("seq_axis") else (8, DIM)
    arrs = {"x": f(*shape)}
    if stage == "tp":
        arrs.update(w1=f(n, DIM, FFN) / np.sqrt(DIM),
                    w2=f(n, FFN, DIM) / np.sqrt(FFN))
    else:
        arrs.update(w=f(n, DIM, DIM) / np.sqrt(DIM), b=0.1 * f(n, DIM))
    if mode == "apply":
        arrs.update(g=f(*shape), g_aux=f(2))
    else:
        arrs["t"] = f(*shape)
        if kw.get("tail"):
            arrs["u"] = f(DIM, DIM) / np.sqrt(DIM)
    return {k: a.astype(np.float32) for k, a in arrs.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case run once in one 4-rank gloo group."""
    d = tmp_path_factory.mktemp("pipeline")
    cases = []
    for name, (axes, mode, stage, kw) in CASES.items():
        np.savez(d / f"{name}.in.npz", **_inputs(name))
        n = 1
        for s in axes.values():
            n *= s
        cases.append(dict(name=name, kind="pipe", axes=axes, ranks=n,
                          mode=mode, stage=stage, inputs=f"{name}.in.npz",
                          **{k: v for k, v in kw.items() if k != "tail"}))
    run_cases(cases, WORLD, d, timeout=300.0)
    return d


def _jax_stage(kind):
    def tanh(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    if kind == "tanh":
        return tanh
    if kind == "aux":
        return lambda p, h: (tanh(p, h), {"sq": jnp.mean(h ** 2),
                                          "abs": jnp.mean(jnp.abs(h))})
    if kind == "stage_aux":
        return lambda p, h: (tanh(p, h), 0.1 * jnp.mean(h ** 2))
    return None


def _jax_case(name, arrs):
    """JAX's pipeline function on the same mesh and inputs."""
    axes, mode, stage, kw = CASES[name]
    n = 1
    for s in axes.values():
        n *= s
    mesh = j_build_mesh(axes, devices=jax.devices()[:n])
    a = {k: jnp.asarray(v) for k, v in arrs.items()}
    names = [k for k in ("w", "b", "w1", "w2") if k in a]
    params = {k: a[k] for k in names}
    partition = ({"w1": P(None, "tp"), "w2": P("tp", None)}
                 if stage == "tp" else None)
    v = kw.get("v", 1)
    if mode == "apply":
        if stage == "tp":
            def fn(p, h):   # outer AD: the plain psum
                return h + jax.lax.psum(jnp.tanh(h @ p["w1"]) @ p["w2"],
                                        "tp")
        else:
            fn = _jax_stage(stage)
        aux = kw.get("aux")

        def run(p, x):
            return jpipe.pipeline_apply(
                fn, p, x, mesh, num_microbatches=kw["m"],
                param_partition=partition,
                schedule=kw.get("schedule", "gpipe"), virtual_stages=v,
                with_aux={k: 0.0 for k in aux} if aux else False,
                seq_axis=kw.get("seq_axis"))

        out, vjp = jax.vjp(run, params, a["x"])
        if aux:
            y, auxes = out
            cot = (a["g"], {k: a["g_aux"][i]
                            for i, k in enumerate(sorted(aux))})
        else:
            y, auxes, cot = out, {}, a["g"]
        gp, dx = vjp(cot)
        return {"out": y, **{f"aux/{k}": x for k, x in auxes.items()},
                **{f"grad/{k}": g for k, g in gp.items()}, "dx": dx}
    if stage == "tp":
        def fn(p, h):   # in-body AD: the f/g pair
            hin = broadcast_replicated_grad(h, "tp")
            return h + psum_replicated_grad(jnp.tanh(hin @ p["w1"])
                                            @ p["w2"], "tp")
    else:
        fn = _jax_stage(stage)
    tail = {"u": a["u"]} if "u" in a else None
    if tail is None:
        loss_fn = lambda h, t: jnp.mean((h - t) ** 2)  # noqa: E731
    else:
        loss_fn = lambda tl, h, t: jnp.mean((h @ tl["u"] - t) ** 2)  # noqa
    got = jpipe.pipeline_train_1f1b(
        fn, loss_fn, params, a["x"], a["t"], mesh, num_microbatches=kw["m"],
        param_partition=partition, tail_params=tail,
        stage_aux=stage == "stage_aux", virtual_stages=v)
    if tail is None:
        loss, gp, dx = got
        extra = {}
    else:
        loss, gp, gt, dx = got
        extra = {"tail/u": gt["u"]}
    return {"loss": loss, **{f"grad/{k}": g for k, g in gp.items()},
            "dx": dx, **extra}


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_jax(ranks, name):
    """The case's outputs, aux, loss, gathered gradients and dx on 4
    ranks against JAX's pipeline function on the same mesh."""
    got = dict(np.load(ranks / f"{name}.npz"))
    want = _jax_case(name, _inputs(name))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=f"{name} {k}")


@pytest.mark.parametrize("v", [1, 2, 3])
@pytest.mark.parametrize("m", list(range(1, 9)))
@pytest.mark.parametrize("pp", [1, 2, 3, 4])
def test_schedule_1f1b_equals_jax(pp, m, v):
    """The 1F1B timetable (kind, microbatch, lap of every tick on every
    stage) is JAX's."""
    want = jpipe._schedule_1f1b(pp, m, v)
    got = tpipe._schedule_1f1b(pp, m, v)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


class _Mesh:
    """A mesh stub for the checks that run before any collective."""

    def __init__(self, axes):
        self.axes = dict(axes)

    def axis_size(self, a):
        names = (a,) if isinstance(a, str) else tuple(a or ())
        out = 1
        for n in names:
            out *= self.axes.get(n, 1)
        return out

    def coord(self, a):
        return 0


def test_pipeline_validation_messages_are_jax():
    """JAX's ``test_pipeline_1f1b_validation`` cases and the
    ``pipeline_apply`` refusals, with JAX's messages."""
    stage = lambda p, h: h @ p["w"]  # noqa: E731
    loss = lambda h, t: torch.mean(h)  # noqa: E731
    x = torch.ones(8, 4)
    one_chunk = {"w": torch.eye(4)[None]}
    with pytest.raises(ValueError, match="chunk"):   # 2 chunks, 4 stages
        tpipe.pipeline_train_1f1b(stage, loss, {"w": torch.eye(4)[None]
                                                .repeat(2, 1, 1)},
                                  x, x, _Mesh({"pp": 4, "dp": 2}))
    with pytest.raises(ValueError, match="no 'pp' axis"):
        tpipe.pipeline_train_1f1b(stage, loss, one_chunk, x, x,
                                  _Mesh({"dp": 8}))
    with pytest.raises(ValueError, match="not divisible into 3 "
                       "microbatches x 2 data shards"):
        tpipe.pipeline_train_1f1b(stage, loss, one_chunk, x, x,
                                  _Mesh({"pp": 2, "dp": 2}),
                                  num_microbatches=3)
    with pytest.raises(ValueError, match="need a real pp axis"):
        tpipe.pipeline_train_1f1b(stage, loss, one_chunk, x, x,
                                  _Mesh({"pp": 1}), virtual_stages=2)
    with pytest.raises(ValueError, match="unknown schedule"):
        tpipe.pipeline_apply(stage, one_chunk, x, _Mesh({"pp": 2}),
                             schedule="zb")
    with pytest.raises(ValueError, match="requires schedule='circular'"):
        tpipe.pipeline_apply(stage, one_chunk, x, _Mesh({"pp": 2}),
                             virtual_stages=2)
    with pytest.raises(ValueError, match=r"circular schedule needs "
                       r"microbatches \(3\) divisible by pp \(2\)"):
        tpipe.pipeline_apply(stage, one_chunk, torch.ones(6, 4),
                             _Mesh({"pp": 2}), num_microbatches=3,
                             schedule="circular")
    with pytest.raises(ValueError, match="pass the structure"):
        tpipe.pipeline_apply(stage, one_chunk, x, _Mesh({"pp": 2}),
                             with_aux=True)
    # One stage: the chunks in order, no microbatching (JAX's shortcut).
    two = tpipe.stack_stage_params([{"w": 2 * torch.eye(4)},
                                    {"w": 3 * torch.eye(4)}])
    assert two["w"].shape == (2, 4, 4)
    assert torch.equal(tpipe.pipeline_apply(stage, two, x,
                                            _Mesh({"dp": 1})), 6 * x)
