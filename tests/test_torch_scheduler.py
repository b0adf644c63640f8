"""The port's scheduler and node runtime: dynamic ``add_task`` /
``remove_task`` and a static Mode-B job over the port's ``LocalBackend``,
each task running ``python -m tfmesos_tpu_torch.server`` and its shell
command; what is still refused by name (gangs, the Mesos backend,
elastic recovery of a dynamic fleet); the node runtime's Mode-A
executor spoken to by hand; the task env contract equal to the JAX
runtime's; the log pump equal to the JAX pump's Python path."""

import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from tfmesos_tpu_torch import wire
from tfmesos_tpu_torch.scheduler import ClusterError, TPUMesosScheduler
from tfmesos_tpu_torch.spec import Job

ROOT = Path(__file__).resolve().parent.parent


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def test_dynamic_add_and_remove_task(tmp_path):
    sched = TPUMesosScheduler([], dynamic=True, quiet=True,
                              start_timeout=60.0)
    deaths = []
    sched.on_dynamic_death = deaths.append
    sched.start()
    try:
        marker = tmp_path / "ran"
        task = sched.add_task(
            "svc", cmd=f"echo {{job_name}}:{{task_index}}:{{rank}} "
                       f"> {marker}; exec sleep 60")
        assert (task.job_name, task.task_index) == ("svc", 0)
        assert _wait(lambda: marker.exists()
                     and marker.read_text().strip())
        assert marker.read_text().strip() == "svc:0:0"
        assert _wait(lambda: task.initialized)
        second = sched.add_task("svc", cmd="exit 3")
        assert second.task_index == 1
        # A dynamic death is a serving event: counted and reported, the
        # task leaves the table, the cluster stays up.
        assert _wait(lambda: len(deaths) == 1)
        assert deaths[0].task_index == 1
        assert sched.dynamic_failures == {"svc": 1}
        assert [t.task_index for t in sched.tasks_of("svc")] == [0]
        assert sched.task_by_index("svc", 0) is task
        assert not sched.finished()
        proc = sched.backend._procs[task.id]
        assert sched.remove_task(task.id)
        assert not sched.remove_task(task.id)
        assert sched.tasks_of("svc") == []
        assert _wait(lambda: proc.poll() is not None)
        assert deaths == [deaths[0]]    # a removal is not a death
    finally:
        sched.stop()


def test_static_mode_b_job_runs_to_its_end(tmp_path):
    out = tmp_path / "ranks"
    jobs = [Job(name="worker", num=2,
                cmd=f"echo {{rank}}/{{world_size}} $TPUMESOS_JOB_NAME "
                    f">> {out}")]
    sched = TPUMesosScheduler(jobs, quiet=True, start_timeout=60.0)
    sched.start()
    try:
        assert sched.started
        assert sorted(sched.cluster_def["worker"]) == sorted(
            t.addr for t in sched.tasks)
        deadline = time.monotonic() + 60.0
        while not sched.finished() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sched.finished()
    finally:
        sched.stop()
    assert sorted(out.read_text().split("\n")[:-1]) == [
        "0/2 worker", "1/2 worker"]


def test_mode_a_elastic_and_gangs_are_refused_by_name():
    """Mode A and the elastic policy are ported (a Mode-A job and an
    elastic scheduler construct; dispatch before start is a plain
    ClusterError); gangs and the Mesos backend are still refused by
    name, and a dynamic fleet refuses the elastic policy as the JAX
    scheduler does."""
    TPUMesosScheduler([Job(name="worker", num=1)], restart_policy="elastic")
    with pytest.raises(ValueError, match="mutually exclusive: a dynamic "
                                         "fleet has no gang to re-form"):
        TPUMesosScheduler([], dynamic=True, restart_policy="elastic")
    with pytest.raises(ClusterError, match=r"not ported yet: the Mesos "
                                           r"backend \(ROADMAP A\.12 "
                                           r"\(g\)\)"):
        TPUMesosScheduler([], dynamic=True, master="10.0.0.1:5050")
    sched = TPUMesosScheduler([Job(name="worker", num=1, cmd="true")],
                              dynamic=True)
    for call in (lambda: sched.run("m:f"), lambda: sched.run_all("m:f"),
                 lambda: sched.run_on([0], "m:f")):
        with pytest.raises(ClusterError, match="cluster not started"):
            call()
    with pytest.raises(ClusterError, match=r"not ported yet: add_gang, "
                                           r"gang replicas \(ROADMAP A\.9 "
                                           r"\(c\)\)"):
        sched.add_gang("replica", ["true", "true"])


def test_server_refuses_a_mode_a_config():
    """The node runtime registers, reads a config without ``cmd`` (and
    ``no_jax``: no process group) and acks; its executor refuses a
    dispatch of another generation (no reply), runs one of its own
    (``func(ctx, *args)``: a value, or the remote traceback), and exits
    0 on ``shutdown``."""
    token = "server-token"
    listen = wire.bind_ephemeral("127.0.0.1")
    addr = wire.sock_addr(listen, advertise_host="127.0.0.1")
    env = dict(os.environ, TPUMESOS_TOKEN=token,
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("TPUMESOS_TOKEN_FILE", None)
    proc = subprocess.Popen([sys.executable, "-m", "tfmesos_tpu_torch.server",
                             "task-1", addr], cwd=ROOT, env=env,
                            stderr=subprocess.PIPE, text=True)
    try:
        listen.settimeout(60.0)
        conn, _ = listen.accept()
        conn.settimeout(60.0)
        reg = wire.recv_msg(conn, token)
        assert reg["op"] == "register" and reg["task_id"] == "task-1"
        assert reg["gen"] == 0
        wire.send_msg(conn, {"job_name": "worker", "task_index": 0,
                             "rank": 0, "world_size": 1, "cmd": None,
                             "generation": 2,
                             "extra_config": {"no_jax": True}}, token)
        assert wire.recv_msg(conn, token) == "ok"
        func = {"module": "tfmesos_tpu_torch.runtime",
                "qualname": "rank_hosts", "path": None}
        for call_id, gen in ((1, 1), (2, 2)):
            wire.send_msg(conn, {"op": "run", "call_id": call_id,
                                 "gen": gen, "func": func, "args": [],
                                 "kwargs": {}}, token)
        assert wire.recv_msg(conn, token) == {
            "op": "result", "call_id": 2, "gen": 2, "ok": True,
            "value": [""]}
        wire.send_msg(conn, {"op": "run", "call_id": 3, "gen": 2,
                             "func": dict(func, qualname="nope"),
                             "args": [], "kwargs": {}}, token)
        reply = wire.recv_msg(conn, token)
        assert reply["call_id"] == 3 and reply["ok"] is False
        assert "AttributeError" in reply["error"]
        wire.send_msg(conn, {"op": "shutdown"}, token)
        _, err = proc.communicate(timeout=60)
        conn.close()
    finally:
        listen.close()
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err
    assert "dropping stale-generation dispatch (gen 1, ours 2)" in err


@pytest.mark.parametrize("config", [
    {"job_name": "worker", "task_index": 1, "rank": 3, "world_size": 4,
     "cluster_def": {"ps": ["a:1"], "worker": ["b:2", "c:3"]},
     "coordinator": "b:9", "mesh_axes": {"dp": -1}},
    {"job_name": "replica", "task_index": 0},
    {}])
def test_task_env_equals_the_jax_runtime(config):
    from tfmesos_tpu import runtime as jax_runtime
    from tfmesos_tpu_torch import runtime

    assert runtime.task_env(config) == jax_runtime.task_env(config)
    mine, theirs = (r.TaskContext.from_config(config)
                    for r in (runtime, jax_runtime))
    assert mine.__dict__ == theirs.__dict__


def test_log_pump_equals_the_jax_python_pump(tmp_path, monkeypatch):
    from tfmesos_tpu import logpump as jax_logpump
    from tfmesos_tpu_torch.logpump import pump_lines

    monkeypatch.setattr(jax_logpump, "_load", lambda: None)
    lines = b"one\ntwo\n\nthree without newline"
    outs = []
    for pump in (pump_lines, jax_logpump.pump_lines):
        src = tmp_path / "src"
        src.write_bytes(lines)
        local = tmp_path / "local"
        a, b = socket.socketpair()
        got = []
        reader = threading.Thread(
            target=lambda: got.extend(iter(lambda: b.recv(4096), b"")))
        reader.start()
        with open(src, "rb") as s, open(local, "wb") as out:
            pump(s, out, a.fileno(), b"[w:0] ")
        a.close()
        reader.join(timeout=10.0)
        b.close()
        outs.append((local.read_bytes(), b"".join(got)))
    assert outs[0] == outs[1]
    assert outs[0][0] == lines
    assert outs[0][1].startswith(b"[w:0] one\n[w:0] two\n[w:0] \n")
