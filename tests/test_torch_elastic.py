"""The port's elastic restart policy: ports of the JAX tests of gang
re-formation and generation fencing (``tests/test_chaos.py``) and of the
supervisor's end-to-end kill test (``tests/test_supervisor.py``).

The control-plane decisions run on a fake backend whose tasks are
generation-aware threads.  The two end-to-end tests run real
``LocalBackend`` clusters training the tiny transformer data parallel
over gloo on the CPU (``transformer_train.train_chunk``, dispatched to
every rank); a worker is SIGKILLed directly where the JAX tests use a
``FaultPlan`` (``chaos=`` is not ported, ROADMAP A.12 (f)).
"""

import os
import signal
import socket
import threading
import time

import pytest
import torch

from tfmesos_tpu_torch import ClusterError, Job, cluster, wire
from tfmesos_tpu_torch.backends.local import LocalBackend
from tfmesos_tpu_torch.scheduler import TPUMesosScheduler
from tfmesos_tpu_torch.spec import Offer, TaskStatus
from tfmesos_tpu_torch.train.checkpoint import STATE_FILE, CheckpointManager
from tfmesos_tpu_torch.train.supervisor import supervise

from test_torch_mode_a import FakeBackend

CHUNK = "tfmesos_tpu_torch.transformer_train:train_chunk"
# The tiny transformer at a global batch of 4 x 32 tokens, 2 a rank.
TRAIN_ARGV = ["--tiny", "--device", "cpu", "--batch_size", "4",
              "--seq_len", "32"]


class GenFakeBackend(FakeBackend):
    """Fake tasks that register with the TPUMESOS_GENERATION of their
    launch env and stamp every reply with the broadcast generation, as
    the node runtime does.  ``stale_reply_next`` makes each prepend one
    zombie reply (gen - 1, the same call id) to its next result."""

    def __init__(self):
        super().__init__(handshake=False)
        self.stale_reply_next = False

    def launch(self, offer, task_infos):
        self.launched.append(
            (offer.id, [i["task_id"]["value"] for i in task_infos]))
        for info in task_infos:
            t = threading.Thread(target=self._gen_task, args=(info,),
                                 daemon=True)
            t.start()
            self.threads.append(t)

    def _gen_task(self, info):
        env = {v["name"]: v["value"]
               for v in info["command"]["environment"]["variables"]}
        gen = int(env.get("TPUMESOS_GENERATION", "0"))
        token = self.scheduler.token
        try:
            sock = wire.connect(self.scheduler.addr)
            wire.send_msg(sock, {"op": "register",
                                 "task_id": info["task_id"]["value"],
                                 "addr": "127.0.0.1:9999", "coord_port": 1,
                                 "gen": gen}, token)
            config = wire.recv_msg(sock, token)
            wire.send_msg(sock, "ok", token)
            bgen = int(config.get("generation", 0))
            assert bgen == gen, (bgen, gen)
            while True:
                msg = wire.recv_msg(sock, token)
                if not isinstance(msg, dict) or msg.get("op") == "shutdown":
                    return
                if msg.get("op") != "run":
                    continue
                if self.stale_reply_next:
                    wire.send_msg(sock, {"op": "result",
                                         "call_id": msg["call_id"],
                                         "gen": bgen - 1, "ok": True,
                                         "value": "zombie"}, token)
                wire.send_msg(sock, {"op": "result",
                                     "call_id": msg["call_id"], "gen": bgen,
                                     "ok": True,
                                     "value": f"g{bgen}r{config['rank']}"},
                              token)
        except (OSError, wire.WireError):
            return


def _offer(cpus=16.0):
    return Offer(id=f"o{time.monotonic_ns()}", agent_id="agent-x",
                 hostname="h", cpus=cpus, mem=8192.0, chips=0)


def _start_elastic(num=2, **kw):
    """A started elastic Mode-A cluster over GenFakeBackend, with an
    offer feeder re-placing unoffered tasks as a live master would."""
    backend = GenFakeBackend()
    kw.setdefault("max_cluster_restarts", 3)
    s = TPUMesosScheduler([Job(name="worker", num=num, cpus=1.0, mem=10.0)],
                          backend=backend, quiet=True, start_timeout=15.0,
                          restart_policy="elastic", restart_backoff=0.02,
                          restart_backoff_max=0.1, restart_jitter=0.0,
                          restart_seed=0, **kw)
    stop = threading.Event()

    def feed():
        while not stop.is_set():
            try:
                if (s.addr and s.addr != "127.0.0.1:0"
                        and any(not t.offered for t in s.tasks)):
                    s.on_offers([_offer()])
            except Exception:       # pragma: no cover - defensive
                pass
            time.sleep(0.01)

    threading.Thread(target=feed, daemon=True).start()
    s.start()
    return s, backend, stop


def _fail_current_task(s, idx=0):
    with s._lock:
        tid = s.tasks[idx].id
    s.on_status(TaskStatus(tid, "TASK_FAILED", message="injected failure"))


def test_elastic_recovery_reforms_gang_and_bumps_generation():
    s, b, stop = _start_elastic()
    try:
        assert s.run_all("tests.whatever:ignored") == ["g0r0", "g0r1"]
        old_ids = [t.id for t in s.tasks]
        _fail_current_task(s, 0)
        assert s.wait_ready(timeout=30.0)
        assert s.generation == 1
        assert s.cluster_restarts == 1
        assert all(t.id not in old_ids for t in s.tasks)
        assert set(old_ids) <= set(b.killed)
        assert s.run_all("tests.whatever:ignored") == ["g1r0", "g1r1"]
        assert s.restart_stats["recovering"] is False
    finally:
        stop.set()
        s.stop()


def test_stale_generation_reply_dropped_never_matched():
    s, b, stop = _start_elastic()
    try:
        _fail_current_task(s, 1)
        assert s.wait_ready(timeout=30.0)
        b.stale_reply_next = True
        assert s.run_all("tests.whatever:ignored") == ["g1r0", "g1r1"]
        b.stale_reply_next = False
        assert s.run_all("tests.whatever:ignored") == ["g1r0", "g1r1"]
    finally:
        stop.set()
        s.stop()


def test_second_death_in_teardown_window_does_not_revive():
    """Deaths after a recovery was accepted and before its teardown are
    that incident's: no revive, no bring-up charge."""
    s, b, stop = _start_elastic()
    try:
        with s._lock:
            t0, t1 = s.tasks[0].id, s.tasks[1].id
            s.on_status(TaskStatus(t0, "TASK_FAILED", message="first"))
            assert s._recovering and not s._recover_teardown_done
            base_revives = b.revive_count
            s.on_status(TaskStatus(t1, "TASK_KILLED",
                                   message="same incident"))
            assert b.revive_count == base_revives
            assert s.task_failure_count == {}
            assert s.tasks[1].id == t1
        assert s.wait_ready(timeout=30.0)
        assert s.cluster_restarts == 1 and s.generation == 1
    finally:
        stop.set()
        s.stop()


def test_restart_budget_recharges_after_window():
    s, b, stop = _start_elastic(max_cluster_restarts=2, restart_window=0.6)
    try:
        _fail_current_task(s, 0)
        assert s.wait_ready(timeout=30.0)
        assert s.restart_stats["restart_budget_left"] == 1
        time.sleep(0.8)
        assert s.restart_stats["restart_budget_left"] == 2
    finally:
        stop.set()
        s.stop()


def test_stale_generation_registration_dropped():
    s = TPUMesosScheduler([Job(name="worker", num=1, cpus=1.0, mem=10.0)],
                          backend=FakeBackend(), quiet=True,
                          restart_policy="elastic")
    s.generation = 3
    a, peer = socket.socketpair()
    try:
        assert s._handle_register(a, {"op": "register",
                                      "task_id": s.tasks[0].id,
                                      "addr": "127.0.0.1:9", "gen": 2})
        assert not s.tasks[0].initialized
        assert s.tasks[0].connection is None
    finally:
        peer.close()
    b2, peer2 = socket.socketpair()
    try:
        assert s._handle_register(b2, {"op": "register",
                                       "task_id": s.tasks[0].id,
                                       "addr": "127.0.0.1:9",
                                       "coord_port": 1, "gen": 3})
        assert s.tasks[0].initialized
    finally:
        b2.close()
        peer2.close()


def test_restart_budget_exhausted_goes_fatal():
    s, b, stop = _start_elastic(max_cluster_restarts=2, restart_window=600.0)
    try:
        for expect in (1, 2):
            _fail_current_task(s, 0)
            assert s.wait_ready(timeout=30.0)
            assert s.cluster_restarts == expect
        assert s.restart_stats["restart_budget_left"] == 0
        _fail_current_task(s, 0)
        with pytest.raises(ClusterError, match="budget exhausted"):
            s.finished()
        with pytest.raises(ClusterError):
            s.run_all("tests.whatever:ignored")
        with pytest.raises(ClusterError, match="budget exhausted"):
            s.wait_ready(timeout=1.0)
        assert s.generation == 2
    finally:
        stop.set()
        s.stop()


def test_fail_fast_policy_unchanged_by_default():
    backend = FakeBackend()
    s = TPUMesosScheduler([Job(name="worker", num=2, cpus=1.0, mem=10.0)],
                          backend=backend, quiet=True)
    s.addr = "127.0.0.1:0"
    backend.start(s)
    s.on_offers([_offer()])
    s.started = True
    _fail_current_task(s, 0)
    with pytest.raises(ClusterError, match="terminated after cluster start"):
        s.finished()
    assert s.generation == 0 and s.cluster_restarts == 0


def test_dispatch_during_recovery_raises_retryable_cluster_error():
    s, b, stop = _start_elastic()
    try:
        with s._lock:
            s._request_recovery("test: hold the gang down")
        with pytest.raises(ClusterError, match="re-forming"):
            s.run_all("tests.whatever:ignored")
        assert not s.finished()
        assert s.wait_ready(timeout=30.0)
        assert s.run_all("tests.whatever:ignored") == ["g1r0", "g1r1"]
    finally:
        stop.set()
        s.stop()


def test_policy_refusals_keep_the_jax_wording():
    from tfmesos_tpu.scheduler import TPUMesosScheduler as JaxScheduler

    for kw in ({"dynamic": True, "restart_policy": "elastic"},
               {"restart_policy": "sometimes"}):
        with pytest.raises(ValueError) as mine:
            TPUMesosScheduler([], backend=FakeBackend(), **kw)
        with pytest.raises(ValueError) as theirs:
            JaxScheduler([], backend=FakeBackend(), **kw)
        assert str(mine.value) == str(theirs.value)


# -- end to end on real processes ---------------------------------------------


def _final_state(ckpt_dir, step):
    return torch.load(os.path.join(ckpt_dir, f"step_{step}", STATE_FILE),
                      weights_only=True)


def test_e2e_kill_recover_resume_reaches_uninterrupted_loss(tmp_path):
    """Two ranks train 3 chunks of 2 steps; rank 1 is SIGKILLed after
    chunk 2.  The elastic scheduler re-forms the gang on its own, the
    caller resumes from rank 0's last checkpoint, and the losses and the
    final state EQUAL an uninterrupted run's (the re-formed gang's, from
    step 0), bit for bit."""
    total, steps = 3, 2
    resumed, ref = str(tmp_path / "resumed"), str(tmp_path / "ref")
    outs, recovered, killed = {}, 0, False
    with cluster(Job(name="worker", num=2, cpus=0.5, mem=256.0),
                 backend=LocalBackend(), quiet=True, start_timeout=120.0,
                 extra_config={"device": "cpu"}, restart_policy="elastic",
                 max_cluster_restarts=3, restart_backoff=0.05,
                 restart_jitter=0.0, restart_seed=0) as c:
        chunk = 0
        while chunk < total:
            try:
                out = c.run_all(CHUNK, TRAIN_ARGV, resumed, chunk * steps,
                                steps)
            except ClusterError:
                assert c.wait_ready(timeout=120.0)
                recovered += 1
                chunk = CheckpointManager(resumed).latest_step() // steps
                continue
            outs[chunk] = out
            chunk += 1
            if chunk == 2 and not killed:
                os.kill(out[1]["pid"], signal.SIGKILL)
                killed = True
        stats = c.restart_stats
        want = [c.run_all(CHUNK, TRAIN_ARGV, ref, i * steps, steps)
                for i in range(total)]
    assert recovered == 1
    assert stats["generation"] == 1 and stats["cluster_restarts"] == 1
    assert outs[2][0]["pid"] != outs[1][0]["pid"]   # a new gang ran it
    for i in range(total):
        for rank in (0, 1):
            assert outs[i][rank]["step"] == want[i][rank]["step"]
            assert outs[i][rank]["losses"] == want[i][rank]["losses"]
        assert outs[i][0]["losses"] == outs[i][1]["losses"]
    a, b = _final_state(resumed, total * steps), _final_state(ref,
                                                              total * steps)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
               else a[k] == b[k] for k in a)


def test_supervised_kill_restart_resume_end_to_end(tmp_path):
    """The supervisor's scenario with nothing simulated: a fail-fast
    cluster trains chunks while rank 0 checkpoints; a worker is
    SIGKILLed mid-train; the supervised retry brings up a fresh cluster
    that resumes from the latest saved step — each chunk runs exactly
    once overall."""
    total, kill_after, steps = 4, 2, 1
    ckpt = str(tmp_path / "ckpt")
    chunks_run = []

    def attempt(i):
        with cluster(Job(name="worker", num=2, cpus=0.5, mem=256.0),
                     backend=LocalBackend(), quiet=True,
                     start_timeout=120.0,
                     extra_config={"device": "cpu"}) as c:
            start = CheckpointManager(ckpt).latest_step() or 0
            if i > 0:
                assert start == kill_after * steps, (start, kill_after)
            out = None
            for chunk in range(start // steps, total):
                out = c.run_all(CHUNK, TRAIN_ARGV, ckpt, chunk * steps,
                                steps)
                chunks_run.append(chunk)
                if i == 0 and chunk + 1 == kill_after:
                    os.kill(out[1]["pid"], signal.SIGKILL)
            return out[0]["losses"][-1]

    result = supervise(attempt, max_restarts=2, restart_wait=0.5)
    assert result.attempts == 2
    assert chunks_run == list(range(total))
    assert torch.isfinite(torch.tensor(result.value))
    assert CheckpointManager(ckpt).latest_step() == total * steps
