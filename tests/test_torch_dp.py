"""The port's data-parallel pieces against the JAX package on the CPU:
the MNIST MLP, ``SyntheticMNIST``, ``sgd``, the runtime's backend rule
and device binding, the data mesh, and the data-parallel train step as
a whole — N gloo processes (``tests/torch_dp_worker.py``), each on its
own share of the global batch, against the JAX single-process
``make_train_step`` on the concatenated global batch.

Tolerances (float32): the MLP and ``sgd`` within 1e-6 (one matmul and
one multiply-add an element, summed in other orders); the
data-parallel steps within atol 1e-5 / rtol 1e-4, the same float32
arithmetic as ``tests/test_torch_train.py``'s step parity plus the
mean over ranks, which sums the batch in another order.  The ranks'
params are held bitwise equal to each other.
"""

import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu.models import mlp as jmlp
from tfmesos_tpu.models import transformer as jt
from tfmesos_tpu.parallel.mesh import build_mesh as j_build_mesh
from tfmesos_tpu.train import data as jdata
from tfmesos_tpu.train.trainer import make_train_step as j_make_train_step
from tfmesos_tpu_torch import convert, runtime
from tfmesos_tpu_torch.models import mlp as tmlp
from tfmesos_tpu_torch.parallel import mesh as tmesh
from tfmesos_tpu_torch.train import data as tdata
from tfmesos_tpu_torch.train import optim

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


# -- the MLP, its data and its optimizer --------------------------------------


def _jax_mlp(hidden, seed):
    cfg = jmlp.MLPConfig(hidden=hidden)
    return cfg, jax.tree_util.tree_map(
        np.asarray, jmlp.init_params(cfg, jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("hidden", [100, 32])
def test_mlp_forward_loss_accuracy_match_jax(hidden):
    jcfg, jp = _jax_mlp(hidden, 3)
    tcfg = tmlp.MLPConfig(hidden=hidden)
    tp = convert.params_from_jax(jp)
    batch = tdata.SyntheticMNIST().eval_batch(64, seed=5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    _close(tmlp.forward(tcfg, tp, tb["image"]),
           jmlp.forward(jcfg, jparams, jb["image"]), atol=1e-6, rtol=1e-6)
    (tloss, tm), (jloss, jm) = (tmlp.loss_fn(tcfg, tp, tb),
                                jmlp.loss_fn(jcfg, jparams, jb))
    _close(float(tloss), float(jloss), atol=1e-6, rtol=1e-6)
    assert float(tm["accuracy"]) == float(jm["accuracy"])


def test_mlp_init_params_layout_matches_jax():
    """Same leaves, shapes and dtypes as the JAX init; the weights at
    1/sqrt(fan-in) (the draws differ: torch's generator, not JAX's)."""
    jcfg, jp = _jax_mlp(100, 0)
    tp = tmlp.init_params(tmlp.MLPConfig(), torch.Generator().manual_seed(0))
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape
        assert str(tp[k].dtype).split(".")[1] == str(jp[k].dtype)
    assert abs(float(tp["w1"].std()) * 28 - 1) < 0.02
    assert abs(float(tp["w2"].std()) * 10 - 1) < 0.05
    assert not tp["b1"].any() and not tp["b2"].any()


@pytest.mark.parametrize("seed,start_step,batch", [(1, 0, 16), (100, 0, 34),
                                                   (101, 7, 34), (2, 3, 1)])
def test_synthetic_mnist_is_bit_identical(seed, start_step, batch):
    mine, theirs = tdata.SyntheticMNIST(), jdata.SyntheticMNIST()
    assert np.array_equal(mine.templates, theirs.templates)
    a = mine.batches(batch, seed=seed, start_step=start_step)
    b = theirs.batches(batch, seed=seed, start_step=start_step)
    for _ in range(3):
        x, y = next(a), next(b)
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            assert np.array_equal(x[k], y[k])
    e1, e2 = mine.eval_batch(50), theirs.eval_batch(50)
    assert all(np.array_equal(e1[k], e2[k]) for k in e1)


@pytest.mark.parametrize("schedule", [False, True])
def test_sgd_three_steps_match_optax(schedule):
    _, jp = _jax_mlp(32, 4)
    lr = (lambda c: 0.1 / (1.0 + c)) if schedule else 0.05
    rng = np.random.RandomState(9)
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in
              jp.items()} for _ in range(3)]
    jopt = optax.sgd(lr)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jstate = jopt.init(jparams)
    topt = optim.sgd(lr)
    tp = convert.params_from_jax(jp)
    tstate = topt.init(tp)
    for g in grads:
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                  jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tstate = topt.update(convert.params_from_jax(g), tstate)
    assert tstate.count == 3
    for k in jp:
        _close(tp[k].detach(), jparams[k], atol=1e-6, rtol=1e-6)


# -- the runtime ---------------------------------------------------------------


def _ctx(hosts, rank=0):
    """A context whose cluster_def puts rank r on ``hosts[r]``."""
    return runtime.TaskContext(
        rank=rank, world_size=len(hosts),
        cluster_def={"worker": [f"{h}:{1000 + i}"
                                for i, h in enumerate(hosts)]})


@pytest.mark.parametrize("hosts,device_type,cards,want", [
    (["a", "a"], "cpu", 0, "gloo"),
    (["a", "a"], "cuda", 1, "gloo"),        # two ranks share one card
    (["a", "a"], "cuda", 2, "nccl"),
    (["a", "b"], "cuda", 1, "nccl"),
    (["a", "a", "b", "b"], "cuda", 2, "nccl"),
    (["a", "a", "b"], "cuda", 1, "gloo"),   # the busiest host decides
    (["a"], "cuda", 1, "nccl"),
])
def test_backend_rule(hosts, device_type, cards, want):
    for rank in range(len(hosts)):
        assert runtime.choose_backend(_ctx(hosts, rank), device_type,
                                      cards) == want


def test_local_index_counts_ranks_on_the_same_host():
    hosts = ["a", "b", "a", "b", "a"]
    assert [runtime.local_index(_ctx(hosts, r)) for r in range(5)] == \
        [0, 0, 1, 1, 2]
    # No cluster map (a program started by hand): one host.
    bare = runtime.TaskContext(rank=2, world_size=3)
    assert runtime.rank_hosts(bare) == ["", "", ""]
    assert runtime.local_index(bare) == 2


def test_initialize_at_world_size_one(monkeypatch):
    monkeypatch.setattr(runtime, "_device", None)
    ctx = runtime.TaskContext()
    assert ctx.device is None
    assert runtime.initialize(ctx, device="cpu") is ctx
    assert ctx.device == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    mesh = ctx.mesh()
    assert isinstance(mesh, tmesh.LocalMesh) and mesh.size() == 1
    assert mesh.mesh_dim_names == ("dp",) and mesh.device_type == "cpu"
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.get_group()
    runtime.shutdown()                  # nothing to leave: a no-op
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            runtime.initialize(ctx)
    with pytest.raises(RuntimeError, match="no coordinator"):
        runtime.initialize(runtime.TaskContext(rank=1, world_size=2),
                           device="cpu")
    assert not torch.distributed.is_initialized()


# -- the data mesh --------------------------------------------------------------


@pytest.mark.parametrize("axes,item", [
    ({"tp": 2, "dp": -1}, None),
    ({"dp": 2, "tp": -1}, None),
    ({"sp": 2}, "mesh axis sp (ROADMAP A.10)"),
    ({"pp": 4}, "mesh axis pp (ROADMAP A.10)"),
    ({"dp": 2, "ep": 2}, "mesh axis ep (ROADMAP A.10)"),
    ({"dcn.dp": 2, "dp": 2}, "mesh axis dcn.dp (ROADMAP A.9 (c))"),
    ({"dp": 2, "fsdp": 2}, None),
])
def test_mesh_refuses_later_axes_by_name(axes, item):
    """sp, pp, ep and dcn. axes are refused by name; tp and dp x fsdp
    (item None) resolve to the JAX mesh's shape over 4 devices."""
    if item is None:
        jshape = dict(j_build_mesh(axes, devices=jax.devices()[:4]).shape)
        assert tmesh.resolve_axes(axes, 4) == jshape
        return
    with pytest.raises(ValueError, match="not ported yet: .*"
                       + item.replace("(", r"\(").replace(")", r"\)")):
        tmesh.resolve_axes(axes, 4)


@pytest.mark.parametrize("axes", [None, {"dp": -1}, {"fsdp": -1},
                                  {"dp": 4}, {"fsdp": 2, "tp": 1},
                                  {"dp": -1, "fsdp": 1}, {"tp": 1},
                                  {"dp": -1, "tp": 2}, {"fsdp": 2, "tp": -1},
                                  {"dp": 2, "fsdp": -1}])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_mesh_axes_resolve_as_jax_builds_them(axes, n):
    """The port's axes above size 1 are the JAX mesh's, in its order,
    over the same count (sizes multiplying to it); where JAX refuses
    the count, so does the port."""
    try:
        jmesh = j_build_mesh(axes, devices=jax.devices()[:n])
    except ValueError:
        with pytest.raises(ValueError):
            tmesh.resolve_axes(axes, n)
        return
    got = tmesh.resolve_axes(axes, n)
    assert math.prod(got.values()) == n
    assert [(a, s) for a, s in got.items() if s > 1] == \
        [(a, s) for a, s in dict(jmesh.shape).items() if s > 1]


def test_mesh_wildcards_and_counts():
    with pytest.raises(ValueError, match="mesh axis x "):
        tmesh.resolve_axes({"dp": -1, "tp": 1, "fsdp": 1, "x": -1}, 2)
    with pytest.raises(ValueError, match="wants 3 ranks, have 2"):
        tmesh.resolve_axes({"dp": 3}, 2)
    assert tmesh.MeshSpec({"tp": 1, "dp": 2, "fsdp": 1}).size == 2
    with pytest.raises(ValueError, match="positive size"):
        tmesh.resolve_axes({"dp": 0}, 2)


def test_default_mesh_axes_follow_the_job_spec():
    from tfmesos_tpu.scheduler import TPUMesosScheduler as JaxScheduler
    from tfmesos_tpu_torch.backends.local import LocalBackend
    from tfmesos_tpu_torch.scheduler import TPUMesosScheduler
    from tfmesos_tpu_torch.spec import Job

    from tfmesos_tpu.backends.local import LocalBackend as JaxLocal
    from tfmesos_tpu.spec import Job as JaxJob

    for names in (["worker"], ["ps", "worker"]):
        mine = TPUMesosScheduler([Job(name=n, num=1, cmd="true")
                                  for n in names], backend=LocalBackend())
        theirs = JaxScheduler([JaxJob(name=n, num=1, cmd="true")
                               for n in names], backend=JaxLocal())
        assert mine._default_mesh_axes() == theirs._default_mesh_axes()
    assert mine._default_mesh_axes() == {"fsdp": -1}


# -- the data-parallel step, N processes against JAX's global batch ---------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(case, world, out_dir):
    """Run the worker at every rank at once; each rank's npz back."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), case, str(r), str(world), str(port),
         str(out_dir)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


def _check_ranks(ranks, world, jparams, jlosses):
    """Every rank's params bitwise equal, the mesh of ``world`` ranks,
    and the losses and params at the JAX global-batch run's."""
    for r in ranks:
        assert int(r["mesh"][0]) == world
        for k in ranks[0]:
            assert np.array_equal(r[k], ranks[0][k]), k
    _close(ranks[0]["losses"], jlosses, atol=1e-5, rtol=1e-4)
    want = {k: np.asarray(v) for k, v in convert.flatten(
        convert.params_from_jax(jax.tree_util.tree_map(
            np.asarray, jparams))).items()}
    assert sorted(want) == sorted(k for k in ranks[0]
                                  if k not in ("losses", "mesh"))
    for k, v in want.items():
        _close(ranks[0][k], v, atol=1e-5, rtol=1e-4)


def test_dp_transformer_adamw_two_ranks_match_the_global_batch(tmp_path):
    """2 ranks over ``dp``: the tiny transformer (GQA), AdamW 1e-3 with
    weight decay 0.01, 2 steps at a global batch of 4 x 64 tokens, each
    rank on its half."""
    base = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                max_seq_len=64, n_kv_heads=2)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **base)
    jp = jax.tree_util.tree_map(np.asarray,
                                jt.init_params(jcfg, jax.random.PRNGKey(2)))
    convert.save_npz(convert.params_from_jax(jp), tmp_path / "params.npz")
    stream = jdata.token_batches(4, 64, 256, seed=100)
    batches = [next(stream)["tokens"] for _ in range(2)]
    np.savez(tmp_path / "batches.npz",
             **{f"b{i}_tokens": b for i, b in enumerate(batches)})
    jopt = optax.adamw(1e-3, weight_decay=0.01)
    jstep = j_make_train_step(lambda p, b: jt.loss_fn(jcfg, p, b), jopt)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jstate = jopt.init(jparams)
    jlosses = []
    for tok in batches:
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {"tokens": jnp.asarray(tok)})
        jlosses.append(float(jm["loss"]))
    ranks = _run_ranks("transformer", 2, tmp_path)
    _check_ranks(ranks, 2, jparams, jlosses)


def test_dp_mlp_sgd_three_ranks_fsdp_match_the_global_batch(tmp_path):
    """3 ranks over ``fsdp`` (replicated params, all-reduced grads): the
    MLP (32 hidden), SGD 0.1, 3 steps at a global batch of 12."""
    jcfg, jp = _jax_mlp(32, 6)
    convert.save_npz(convert.params_from_jax(jp), tmp_path / "params.npz")
    stream = jdata.SyntheticMNIST().batches(12, seed=7)
    batches = [next(stream) for _ in range(3)]
    np.savez(tmp_path / "batches.npz",
             **{f"b{i}_{k}": v for i, b in enumerate(batches)
                for k, v in b.items()})
    jopt = optax.sgd(0.1)
    jstep = j_make_train_step(lambda p, b: jmlp.loss_fn(jcfg, p, b), jopt)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jstate = jopt.init(jparams)
    jlosses = []
    for b in batches:
        jparams, jstate, jm = jstep(
            jparams, jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jlosses.append(float(jm["loss"]))
    ranks = _run_ranks("mlp", 3, tmp_path)
    _check_ranks(ranks, 3, jparams, jlosses)
