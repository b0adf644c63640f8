"""The port's CheckpointManager and its Orbax converter on the CPU.

The manager's own cases mirror tests/test_checkpoint.py on the port's
format; the converter is held against the JAX trainer: a JAX run saved
through the JAX (Orbax) CheckpointManager, converted, continues in the
port within ``test_train_steps_match_jax``'s tolerances (atol 1e-5,
rtol 1e-4: the same float32 arithmetic summed in other orders).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401
from torch_parity import to_torch as _t

from tfmesos_tpu.models import transformer as jt
from tfmesos_tpu.train.checkpoint import CheckpointManager as JaxManager
from tfmesos_tpu.train.trainer import make_train_step as j_make_train_step
from tfmesos_tpu_torch import convert
from tfmesos_tpu_torch.models import transformer as tt
from tfmesos_tpu_torch.ops.quant import QTensor
from tfmesos_tpu_torch.train import data as tdata
from tfmesos_tpu_torch.train import optim, trainer
from tfmesos_tpu_torch.train.checkpoint import (STATE_FILE,
                                                CheckpointManager,
                                                convert_orbax)

ATOL, RTOL = 1e-5, 1e-4
TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
            max_seq_len=64, n_kv_heads=2)
# Peak 1e-3, the rate of test_train_steps_match_jax.  At 1e-2 Adam's
# normalized update turns the float32 summation-order difference of a
# near-zero embedding gradient into ~7e-5 after 4 steps, with no
# checkpoint at all (the same 1 of 16,384 elements either way).
SCHED = dict(init_value=0.0, peak_value=1e-3, warmup_steps=2,
             decay_steps=6, end_value=1e-4)


def _cfg():
    return tt.TransformerConfig(dtype=torch.float32, **TINY)


def _batches(n, seed=100, b=2, t=32):
    return [_t(x["tokens"]) for _, x in zip(
        range(n), tdata.token_batches(b, t, 256, seed=seed))]


def _fresh(seed=0, lr=1e-3, max_norm=0.0):
    cfg = _cfg()
    params = tt.init_params(cfg, torch.Generator().manual_seed(seed))
    opt = optim.adamw(lr, weight_decay=0.01, max_norm=max_norm)
    step = trainer.make_train_step(lambda p, b: tt.loss_fn(cfg, p, b), opt)
    return params, opt.init(params), step


def _equal_trees(a, b):
    fa, fb = convert.flatten(a), convert.flatten(b)
    return sorted(fa) == sorted(fb) and all(torch.equal(fa[k], fb[k])
                                            for k in fa)


@pytest.mark.parametrize("wait", [True, False])
def test_params_opt_state_step_round_trip(tmp_path, wait):
    """Save after 2 steps, restore into a fresh state (no optimizer
    state yet) in place: params, moments, per-leaf steps and count come
    back, the template's tensors are the restored ones, and 2 more steps
    from the restore equal 2 more steps of the original bit for bit."""
    batches = _batches(4)
    params, state, step = _fresh()
    for tok in batches[:2]:
        params, state, _ = step(params, state, {"tokens": tok})
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None
    assert mgr.restore({"params": params}) is None
    mgr.save(2, {"params": params, "opt_state": state, "step": 2}, wait=wait)
    mgr.wait_until_finished()
    assert mgr.latest_step() == 2 and mgr.all_steps() == [2]

    p2, s2, step2 = _fresh(seed=1)
    assert not _equal_trees(p2, params) and s2.count == 0
    leaves = list(convert.flatten(p2).values())
    out = mgr.restore({"params": p2, "opt_state": s2, "step": 0})
    mgr.close()
    assert out["step"] == 2 and out["opt_state"] is s2 and s2.count == 2
    assert all(a is b for a, b in zip(convert.flatten(out["params"]).values(),
                                      leaves))
    assert all(a is b for a, b in zip(s2.leaves, leaves))
    assert _equal_trees(p2, params)
    want, got = state.moments(), s2.moments()
    for m in want:
        assert all(torch.equal(want[m][n], got[m][n]) for n in want[m])
    for tok in batches[2:]:
        params, state, m1 = step(params, state, {"tokens": tok})
        p2, s2, m2 = step2(p2, s2, {"tokens": tok})
        assert torch.equal(m1["loss"], m2["loss"])
    assert _equal_trees(p2, params)


def test_quantized_params_round_trip(tmp_path):
    """QTensor leaves (int8 values and float32 scales) survive a save and
    restore into a zeroed template (mirrors
    tests/test_checkpoint.py::test_quantized_params_checkpoint_roundtrip)."""
    cfg = tt.TransformerConfig(vocab_size=32, d_model=16, n_layers=2,
                               n_heads=2, d_ff=32, max_seq_len=8,
                               dtype=torch.float32)
    qparams = tt.quantize_params(cfg, tt.init_params(
        cfg, torch.Generator().manual_seed(0)))
    mgr = CheckpointManager(str(tmp_path / "q"))
    mgr.save(1, {"qparams": qparams})
    like = convert.unflatten({k: torch.zeros_like(v) for k, v in
                              convert.flatten(qparams).items()})
    restored = mgr.restore({"qparams": like})["qparams"]
    mgr.close()
    wq = restored["layers"]["wq"]
    assert isinstance(wq, QTensor) and wq.values.dtype == torch.int8
    assert torch.equal(wq.values, qparams["layers"]["wq"].values)
    assert torch.equal(restored["embed"].scales, qparams["embed"].scales)
    assert _equal_trees(restored, qparams)


def test_async_snapshot_survives_later_in_place_update(tmp_path):
    """save(wait=False) copies every tensor before it returns: an in-place
    update made right after (as the next optimizer step makes) is not
    in the checkpoint, and the next save joins the write in flight."""
    w = torch.arange(1 << 16, dtype=torch.float32)
    mgr = CheckpointManager(str(tmp_path / "a"))
    mgr.save(3, {"w": w, "n": 3}, wait=False)
    w.add_(1000.0)
    mgr.save(4, {"w": w, "n": 4}, wait=False)
    w.mul_(-1.0)
    like = {"w": torch.zeros_like(w), "n": 0}
    got3 = mgr.restore(like, step=3)
    assert got3["n"] == 3 and torch.equal(
        like["w"], torch.arange(1 << 16, dtype=torch.float32))
    got4 = mgr.restore(like)
    assert got4["n"] == 4 and torch.equal(
        like["w"], torch.arange(1 << 16, dtype=torch.float32) + 1000.0)
    mgr.close()


def test_max_to_keep_and_resave(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "k"), max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.full((3,), float(s))}, wait=s % 2 == 0)
    mgr.close()
    assert mgr.all_steps() == [3, 4]
    assert sorted(os.listdir(mgr.workdir)) == ["step_3", "step_4"]
    mgr.save(4, {"x": torch.full((3,), 40.0)})
    like = {"x": torch.zeros(3)}
    mgr.restore(like)
    assert torch.equal(like["x"], torch.full((3,), 40.0))
    keep_all = CheckpointManager(str(tmp_path / "all"), max_to_keep=None)
    for s in range(5):
        keep_all.save(s, {"x": torch.zeros(1)})
    assert keep_all.all_steps() == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError, match="max_to_keep"):
        CheckpointManager(str(tmp_path / "z"), max_to_keep=0)


def test_leftover_temporary_directory_is_ignored(tmp_path):
    """A save that died mid-write leaves a hidden temporary directory:
    latest_step never reads it, and the step before stays restorable."""
    mgr = CheckpointManager(str(tmp_path / "t"))
    mgr.save(5, {"x": torch.ones(4)})
    crashed = tmp_path / "t" / ".tmp-step_9-1234-5678"
    crashed.mkdir()
    (crashed / STATE_FILE).write_bytes(b"\x80partial")
    (tmp_path / "t" / "step_7").mkdir()          # no state file
    assert mgr.latest_step() == 5 and mgr.all_steps() == [5]
    like = {"x": torch.zeros(4)}
    mgr.restore(like)
    assert torch.equal(like["x"], torch.ones(4))
    mgr.save(6, {"x": torch.full((4,), 6.0)})
    assert mgr.latest_step() == 6
    mgr.close()


def test_template_mismatches_raise(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "m"))
    mgr.save(1, {"a": torch.zeros(2, 3), "n": 1})
    with pytest.raises(KeyError, match="'b'"):
        mgr.restore({"a": torch.zeros(2, 3), "b": torch.zeros(1)})
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore({"a": torch.zeros(3, 2), "n": 0})
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore({"a": torch.zeros(2, 3, dtype=torch.float64), "n": 0})
    with pytest.raises(TypeError, match="template a tensor"):
        mgr.restore({"a": torch.zeros(2, 3), "n": torch.zeros(())})
    with pytest.raises(TypeError, match="state tree holds"):
        mgr.save(2, {"a": "text"})
    mgr.close()


def _jax_params():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **TINY)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(2))
    return jcfg, jp


@pytest.mark.parametrize("form", ["example", "train_loop"])
def test_orbax_checkpoint_converts_and_continues(tmp_path, form):
    """2 JAX steps of optax.chain(clip_by_global_norm, adamw(warmup
    cosine)) saved through the JAX (Orbax) CheckpointManager in the
    example's (params, opt_state) form or TrainLoop's dict, restored as
    numpy, converted: 2 more steps on each side agree in loss and params
    within atol 1e-5 / rtol 1e-4 (the schedule and the bias correction
    pick up at optax's count)."""
    jcfg, jparams = _jax_params()
    batches = _batches(4)
    jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(**SCHED), weight_decay=0.01))
    jstep = j_make_train_step(lambda p, b: jt.loss_fn(jcfg, p, b), jopt)
    jstate = jopt.init(jparams)
    for tok in batches[:2]:
        jparams, jstate, _ = jstep(jparams, jstate,
                                   {"tokens": jnp.asarray(tok.numpy())})
    tree = ((jparams, jstate) if form == "example" else
            {"params": jparams, "opt_state": jstate, "step": jnp.asarray(2)})
    jmgr = JaxManager(str(tmp_path / "orbax"))
    try:
        jmgr.save(2, tree)
        restored = jmgr.restore(jax.tree_util.tree_map(jnp.zeros_like, tree))
    finally:
        jmgr.close()
    as_np = jax.tree_util.tree_map(np.asarray, restored)
    step = convert_orbax(as_np, str(tmp_path / "port"),
                         step=2 if form == "example" else None)
    assert step == 2

    cfg = _cfg()
    params = tt.init_params(cfg, torch.Generator().manual_seed(9))
    opt = optim.adamw(optim.warmup_cosine_decay_schedule(**SCHED),
                      weight_decay=0.01, max_norm=1.0)
    state = opt.init(params)
    like = ((params, state) if form == "example" else
            {"params": params, "opt_state": state, "step": 0})
    mgr = CheckpointManager(str(tmp_path / "port"))
    out = mgr.restore(like)
    mgr.close()
    assert state.count == 2
    if form == "train_loop":
        assert out["step"] == 2
    assert all(float(t) == 2.0 for t in state.moments()["step"].values())
    tstep = trainer.make_train_step(lambda p, b: tt.loss_fn(cfg, p, b), opt)
    for tok in batches[2:]:
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {"tokens": jnp.asarray(tok.numpy())})
        params, state, tm = tstep(params, state, {"tokens": tok})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=ATOL, rtol=RTOL)
    want = convert.flatten(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    got = convert.flatten(params)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   atol=ATOL, rtol=RTOL)


def test_converter_needs_exactly_one_adam_state(tmp_path):
    jparams = jax.tree_util.tree_map(np.asarray, _jax_params()[1])
    sgd = jax.tree_util.tree_map(np.asarray, optax.sgd(0.1).init(jparams))
    with pytest.raises(ValueError, match="exactly one optax Adam state"):
        convert_orbax((jparams, sgd), str(tmp_path / "x"), step=1)
    adam = jax.tree_util.tree_map(np.asarray,
                                  optax.adamw(1e-3).init(jparams))
    with pytest.raises(ValueError, match="found 2"):
        convert_orbax((jparams, (adam, adam)), str(tmp_path / "y"), step=1)
    with pytest.raises(ValueError, match="step is required"):
        convert_orbax((jparams, adam), str(tmp_path / "z"))
    # A template-free restore hands back dicts: found by their keys.
    as_dict = {"0": {"count": np.asarray(3), "mu": adam[0].mu,
                     "nu": adam[0].nu}}
    assert convert_orbax((jparams, as_dict), str(tmp_path / "d"),
                         step=3) == 3
