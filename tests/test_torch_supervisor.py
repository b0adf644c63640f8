"""The port's restart supervision on the CPU (the cases of
tests/test_supervisor.py, with the tiny transformer in place of the
MLP, which comes with the Mode-A slice, ROADMAP A.9 (a)).

The retry-policy cases run the same scripted attempts through the JAX
``supervise`` and the port's and hold the outcomes equal.  The resumed
runs are held to the uninterrupted run's final params with
``torch.equal``.  The reference's
``test_end_to_end_kill_restart_resume`` needs ``cluster()`` and a real
LocalBackend cluster, which the port gains with A.9 (a); it waits for
that slice.
"""

import pytest
import torch
from torch_parity import to_torch as _t

from tfmesos_tpu import scheduler as jsched
from tfmesos_tpu.train import supervisor as jsup
from tfmesos_tpu_torch import convert, scheduler
from tfmesos_tpu_torch.models import transformer as tt
from tfmesos_tpu_torch.train import data as tdata
from tfmesos_tpu_torch.train import optim, supervisor
from tfmesos_tpu_torch.train.checkpoint import CheckpointManager
from tfmesos_tpu_torch.train.trainer import (TrainLoop, TrainState,
                                             make_train_step)

SCRIPTS = {
    "retries_cluster_errors_then_succeeds": (["cluster", "cluster", "ok"], 3),
    "workload_bugs_do_not_retry": (["bug", "ok"], 3),
    "remote_user_code_errors_do_not_retry": (["remote", "ok"], 3),
    "restart_budget_exhausted": (["cluster"] * 5, 2),
    "retry_override_widens": (["bug", "bug", "ok"], 3),
}


def _run_script(sup, sched, script, max_restarts, widen):
    calls = []
    errors = {"cluster": sched.ClusterError, "remote": sched.RemoteError,
              "bug": ValueError}

    def attempt(i):
        calls.append(i)
        if script[i] == "ok":
            return "done"
        raise errors[script[i]](f"{script[i]} on attempt {i}")

    kw = dict(should_retry=lambda e: True) if widen else {}
    try:
        r = sup.supervise(attempt, max_restarts=max_restarts,
                          restart_wait=0.0, **kw)
        return calls, ("ok", r.value, r.attempts)
    except Exception as e:        # the outcome under test
        return calls, ("raised", type(e).__name__, str(e))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_retry_policy_matches_jax(name):
    script, max_restarts = SCRIPTS[name]
    widen = name == "retry_override_widens"
    want = _run_script(jsup, jsched, script, max_restarts, widen)
    got = _run_script(supervisor, scheduler, script, max_restarts, widen)
    assert got == want
    expected = {
        "retries_cluster_errors_then_succeeds": ([0, 1, 2], ("ok", "done",
                                                             3)),
        "workload_bugs_do_not_retry": ([0], "ValueError"),
        "remote_user_code_errors_do_not_retry": ([0], "RemoteError"),
        "restart_budget_exhausted": ([0, 1, 2], "ClusterError"),
        "retry_override_widens": ([0, 1, 2], ("ok", "done", 3)),
    }[name]
    calls, outcome = got
    assert calls == expected[0]
    assert (outcome if outcome[0] == "ok" else outcome[1]) == expected[1]


TINY = dict(vocab_size=256, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            max_seq_len=16, dtype=torch.float32)


def _setup():
    cfg = tt.TransformerConfig(**TINY)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0))
    opt = optim.adamw(1e-3, weight_decay=0.01)
    step = make_train_step(lambda p, b: tt.loss_fn(cfg, p, b), opt)
    return params, opt.init(params), step


def _stream(start_step=0):
    return ({"tokens": _t(b["tokens"])} for b in tdata.token_batches(
        2, 16, 256, seed=7, start_step=start_step))


def _uninterrupted(total_steps):
    params, state, step = _setup()
    gen = _stream()
    for _ in range(total_steps):
        params, state, metrics = step(params, state, next(gen))
    return params, float(metrics["loss"])


def _equal_params(a, b):
    fa, fb = convert.flatten(a), convert.flatten(b)
    return all(torch.equal(fa[k], fb[k]) for k in fa)


def test_training_resumes_from_checkpoint_across_restarts(tmp_path):
    """A 12-step job whose cluster dies after 4 steps on its first
    attempt runs 12 effective steps, not 16, and ends with the
    uninterrupted run's params."""
    total_steps, fail_at = 12, 4
    steps_run = []
    final = {}

    def attempt(i):
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        try:
            params, state, step = _setup()
            restored = mgr.restore({"params": params, "opt_state": state,
                                    "step": 0})
            start_step = restored["step"] if restored is not None else 0
            gen = _stream(start_step)
            for s in range(start_step, total_steps):
                params, state, metrics = step(params, state, next(gen))
                steps_run.append(s)
                if (s + 1) % 4 == 0:
                    mgr.save(s + 1, {"params": params, "opt_state": state,
                                     "step": s + 1})
                if i == 0 and s + 1 == fail_at:
                    raise scheduler.ClusterError("simulated task death")
            final["params"] = params
            return float(metrics["loss"])
        finally:
            mgr.close()

    result = supervisor.supervise(attempt, max_restarts=2, restart_wait=0.0)
    assert result.attempts == 2
    assert steps_run == list(range(total_steps))
    ref_params, ref_loss = _uninterrupted(total_steps)
    assert result.value == ref_loss
    assert _equal_params(final["params"], ref_params)


def _build(draws, fail_at_draw=None):
    def build(attempt):
        params, state, step = _setup()
        loop = TrainLoop(step_fn=step, state=TrainState(params, state),
                         log_every=1000)
        gen = _stream()
        seen = draws.setdefault(attempt, [])

        def batches():
            for n, batch in enumerate(gen):
                if attempt == 0 and n == fail_at_draw:
                    raise scheduler.ClusterError("simulated task death")
                seen.append(n)
                yield batch

        return loop, batches()
    return build


def test_supervise_training_resumes_from_checkpoint(tmp_path):
    """A 12-step job dying at its 8th batch draw resumes from the last
    save (step 4), re-runs only 8 steps through the default skip-ahead,
    and ends with params torch.equal to an uninterrupted supervised
    run's."""
    draws = {}
    mgr = CheckpointManager(str(tmp_path / "sup"))
    try:
        r = supervisor.supervise_training(
            _build(draws, fail_at_draw=7), 12, mgr, save_every=4,
            max_restarts=2, restart_wait=0.0)
    finally:
        mgr.close()
    assert r.attempts == 2 and r.restarts == 1
    assert r.resumed_steps == [0, 4]
    assert r.result["start_step"] == 4 and r.result["final_step"] == 12
    assert r.result["restores"] == 1 and r.result["resumed_step"] == 4
    assert draws[0] == list(range(7)) and draws[1] == list(range(12))
    assert mgr.all_steps() == [4, 8, 12]

    ref_draws = {}
    mgr2 = CheckpointManager(str(tmp_path / "ref"))
    try:
        ref = supervisor.supervise_training(
            _build(ref_draws), 12, mgr2, save_every=4, max_restarts=0,
            restart_wait=0.0)
    finally:
        mgr2.close()
    assert ref.restarts == 0 and ref.resumed_steps == [0]
    assert (r.result["final_metrics"]["loss"]
            == ref.result["final_metrics"]["loss"])
    params = CheckpointManager(str(tmp_path / "sup")).restore(
        {"params": _setup()[0]}, step=12)["params"]
    ref_params = CheckpointManager(str(tmp_path / "ref")).restore(
        {"params": _setup()[0]}, step=12)["params"]
    assert _equal_params(params, ref_params)
    assert _equal_params(params, _uninterrupted(12)[0])


def test_supervise_training_already_complete_is_noop(tmp_path):
    """A checkpoint at total_steps runs zero further steps and draws no
    batch."""
    draws = {}
    mgr = CheckpointManager(str(tmp_path / "done"))
    try:
        supervisor.supervise_training(_build(draws), 4, mgr, save_every=2,
                                      max_restarts=0, restart_wait=0.0)
        drawn = []
        loop, batches = _build({})(0)
        gen = (drawn.append(1) or b for b in batches)
        r2 = supervisor.supervise_training(lambda a: (loop, gen), 4, mgr,
                                           max_restarts=0, restart_wait=0.0)
    finally:
        mgr.close()
    assert r2.resumed_steps == [4]
    assert r2.result["final_step"] == 4
    assert drawn == []


def test_skip_hook_none_with_a_seekable_stream(tmp_path):
    """``skip_hook=None`` with a stream that ``build`` starts at the
    manager's latest step itself (the seekable form the docstring
    names) gives the same final params as the draining default."""
    mgr = CheckpointManager(str(tmp_path / "seek"))

    def build(attempt):
        params, state, step = _setup()
        loop = TrainLoop(step_fn=step, state=TrainState(params, state),
                         log_every=1000)
        gen = _stream(mgr.latest_step() or 0)

        def batches():
            for n, batch in enumerate(gen):
                if attempt == 0 and n == 5:
                    raise scheduler.ClusterError("simulated task death")
                yield batch

        return loop, batches()

    try:
        r = supervisor.supervise_training(build, 8, mgr, save_every=4,
                                          max_restarts=1, restart_wait=0.0,
                                          skip_hook=None)
        params = mgr.restore({"params": _setup()[0]})["params"]
    finally:
        mgr.close()
    assert r.resumed_steps == [0, 4]
    assert _equal_params(params, _uninterrupted(8)[0])
