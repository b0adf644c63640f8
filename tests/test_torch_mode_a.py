"""Mode A on the port's own scheduler and node runtime: ports of the JAX
tests of SPMD dispatch (``tests/test_local_backend.py``,
``tests/test_scheduler.py``).  Real ``LocalBackend`` clusters run the
JAX tests' own ``support_funcs`` (its dispatched functions import no
JAX) with ``no_jax`` or over a gloo process group on the CPU; the full
bring-up runs over a fake backend whose tasks speak the wire by hand.
"""

import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

from tfmesos_tpu_torch import ClusterError, Job, RemoteError, cluster, wire
from tfmesos_tpu_torch.backends import ResourceBackend
from tfmesos_tpu_torch.backends.local import LocalBackend
from tfmesos_tpu_torch.scheduler import TPUMesosScheduler, _func_spec
from tfmesos_tpu_torch.spec import Offer, TaskStatus
from tfmesos_tpu_torch.train.supervisor import supervise

ROOT = Path(__file__).resolve().parent.parent
NO_RUNTIME = {"no_jax": True}


class FakeBackend(ResourceBackend):
    """Records the scheduler's decisions; with ``handshake`` its tasks
    are threads that register, ack and answer dispatches as the node
    runtime does (``tests/test_scheduler.py``'s fake, on the port)."""

    def __init__(self, handshake=False):
        self.launched, self.declined, self.killed = [], [], []
        self.suppress_count = self.revive_count = 0
        self.handshake = handshake
        self.scheduler = None
        self.threads = []

    def start(self, scheduler):
        self.scheduler = scheduler
        scheduler.on_registered({"backend": "fake"})

    def stop(self):
        pass

    def launch(self, offer, task_infos):
        self.launched.append((offer.id, [i["task_id"]["value"]
                                         for i in task_infos]))
        if self.handshake:
            for info in task_infos:
                t = threading.Thread(target=self._task, args=(info,),
                                     daemon=True)
                t.start()
                self.threads.append(t)

    def _task(self, info):
        token = self.scheduler.token
        task_id = info["task_id"]["value"]
        sock = wire.connect(self.scheduler.addr)
        wire.send_msg(sock, {"op": "register", "task_id": task_id,
                             "addr": "127.0.0.1:9999", "coord_port": 8476},
                      token)
        config = wire.recv_msg(sock, token)
        wire.send_msg(sock, "ok", token)
        while True:
            msg = wire.recv_msg(sock, token)
            if msg.get("op") == "shutdown":
                return
            if msg.get("op") == "run":
                wire.send_msg(sock, {"op": "result",
                                     "call_id": msg["call_id"], "ok": True,
                                     "value": f"rank{config['rank']}"},
                              token)

    def decline(self, offer, refuse_seconds=5.0):
        self.declined.append((offer.id, refuse_seconds))

    def suppress(self):
        self.suppress_count += 1

    def revive(self):
        self.revive_count += 1

    def kill(self, task_id):
        self.killed.append(task_id)


def offer(oid="o1", cpus=8.0, mem=8192.0, chips=0):
    return Offer(id=oid, agent_id="agent-1", hostname="h", cpus=cpus,
                 mem=mem, chips=chips)


def test_mode_a_dispatch_no_jax():
    """ps + 2 workers: run_all in rank order with job names, and the
    task env contract seen by dispatched code."""
    jobs = [Job(name="ps", num=1, cpus=0.5, mem=64.0),
            Job(name="worker", num=2, cpus=0.5, mem=64.0)]
    with cluster(jobs, backend=LocalBackend(), quiet=True,
                 start_timeout=60.0, extra_config=NO_RUNTIME) as c:
        results = c.run_all("support_funcs:ping", "hi")
        assert [r["rank"] for r in results] == [0, 1, 2]
        assert results[0]["job"] == "ps:0"
        assert results[2] == {"rank": 2, "world": 3, "job": "worker:1",
                              "value": "hi"}
        assert c.run("support_funcs:read_env", "TFMESOS_DISTRIBUTED") == "1"
        assert c.run_all("support_funcs:read_env", "TPUMESOS_RANK") == \
            ["0", "1", "2"]
        assert c.run_all("support_funcs:read_env", "TPUMESOS_MESH_AXES") == \
            ['{"fsdp":-1}'] * 3


def test_remote_exception_propagates():
    with cluster(Job(name="w", num=1, cpus=0.5, mem=64.0),
                 backend=LocalBackend(), quiet=True, start_timeout=60.0,
                 extra_config=NO_RUNTIME) as c:
        with pytest.raises(RemoteError, match="No module named"):
            c.run("no_such_module_xyz:func")
        # A remote failure is not an infrastructure death: the channel
        # stays usable.
        assert c.run("support_funcs:ping", 1)["rank"] == 0


def test_mode_a_task_killed_mid_dispatch_raises_cluster_error():
    """SIGKILL a Mode-A task while a dispatch is in flight: the caller
    sees ClusterError (not OSError / WireError, not RemoteError), the
    cluster is fatal, and supervise() treats it as retryable."""
    attempts = []

    def run_attempt(attempt):
        attempts.append(attempt)
        if attempt >= 1:
            return "recovered"
        with cluster([Job(name="w", num=2, cpus=0.5, mem=64.0)],
                     backend=LocalBackend(), quiet=True, start_timeout=60.0,
                     extra_config=NO_RUNTIME) as c:
            pids = c.run_all("support_funcs:my_pid")
            errs = []

            def dispatch():
                try:
                    c.run_all("support_funcs:sleep_forever", 60.0)
                except BaseException as e:  # noqa: BLE001 - for asserts
                    errs.append(e)

            t = threading.Thread(target=dispatch)
            t.start()
            time.sleep(1.0)
            os.kill(pids[1], signal.SIGKILL)
            t.join(timeout=30)
            assert not t.is_alive(), "dispatch never unblocked after kill"
            assert errs, "dispatch did not raise"
            assert isinstance(errs[0], ClusterError), errs[0]
            assert not isinstance(errs[0], RemoteError)
            with pytest.raises(ClusterError):
                c.run("support_funcs:my_pid")
            raise errs[0]

    result = supervise(run_attempt, max_restarts=2, restart_wait=0.1)
    assert result.value == "recovered"
    assert result.attempts == 2
    assert attempts == [0, 1]


def test_run_on_duplicate_ranks_rejected():
    with cluster(Job(name="w", num=2, cpus=0.5, mem=64.0),
                 backend=LocalBackend(), quiet=True, start_timeout=60.0,
                 extra_config=NO_RUNTIME) as c:
        with pytest.raises(ClusterError, match="duplicate"):
            c.run_on([0, 0], "support_funcs:ping", "x")
        # The rejection happens before any send: the channel is usable.
        assert [r["rank"] for r in c.run_on([1, 0], "support_funcs:ping",
                                            "x")] == [1, 0]
        with pytest.raises(ClusterError, match="not connected"):
            c.run_on([2], "support_funcs:ping", "x")


def test_full_bringup_run_and_dispatch():
    """Rendezvous, config broadcast, SPMD dispatch and teardown over real
    sockets, the tasks simulated."""
    backend = FakeBackend(handshake=True)
    s = TPUMesosScheduler([Job(name="worker", num=3, cpus=1.0, mem=10.0)],
                          backend=backend, quiet=True, start_timeout=15.0)

    def feed_offers():
        while not all(t.offered for t in s.tasks):
            if s.addr and s.addr != "127.0.0.1:0":
                s.on_offers([offer("oX", cpus=16.0)])
            time.sleep(0.01)

    threading.Thread(target=feed_offers, daemon=True).start()
    s.start()
    try:
        assert s.started
        assert len(s.cluster_def["worker"]) == 3
        assert set(s.targets) == {f"/job:worker/task:{i}" for i in range(3)}
        assert s.run_all("tests.whatever:ignored_by_fake") == [
            "rank0", "rank1", "rank2"]
        assert s.run("tests.whatever:ignored_by_fake") == "rank0"
        assert s.run_on([2], "tests.whatever:ignored_by_fake") == ["rank2"]
    finally:
        s.stop()


def _top_level():
    pass


@pytest.mark.parametrize("func", ["pkg.mod:Cls.method", "support_funcs:ping",
                                  _top_level, _func_spec])
def test_func_spec_matches_jax(func):
    from tfmesos_tpu.scheduler import _func_spec as jax_func_spec

    assert _func_spec(func) == jax_func_spec(func)


def test_func_spec_refuses_what_cannot_ship():
    with pytest.raises(ValueError, match="module:qualname"):
        _func_spec("no-colon")
    with pytest.raises(ValueError, match="top level"):
        _func_spec(lambda ctx: 0)


def test_dispatch_of_a_main_script_function_over_gloo(tmp_path):
    """A script's own ``__main__`` function ships by its file;
    both ranks join one gloo group on the CPU (ctx.device, the default
    dp mesh of a workers-only spec) and all-reduce over it."""
    script = tmp_path / "main_script.py"
    script.write_text(textwrap.dedent('''
        import torch, torch.distributed as dist
        from tfmesos_tpu_torch import Job, cluster

        def total(ctx, x):
            mesh = ctx.mesh()
            t = torch.tensor([x * (ctx.rank + 1)], device=ctx.device)
            dist.all_reduce(t, group=mesh.get_group())
            return [float(t), mesh.mesh_dim_names[0], mesh.size(),
                    dist.get_backend(), str(ctx.device)]

        if __name__ == "__main__":
            with cluster(Job(name="worker", num=2, cpus=0.5, mem=64.0),
                         quiet=True, start_timeout=60.0,
                         extra_config={"device": "cpu"}) as c:
                print(c.run_all(total, 2.0))
        '''))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    want = [6.0, "dp", 2, "gloo", "cpu"]
    assert out.stdout.strip().splitlines()[-1] == repr([want, want])
