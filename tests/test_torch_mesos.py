"""The port's Mesos and ZooKeeper backends (``backends/mesos.py``,
``backends/zk.py``): the JAX ``tests/test_mesos_backend.py``,
``tests/test_zk.py`` and ``tests/test_mesos_golden.py`` cases run on
them (the goldens with one stated difference: the task command runs
``-m tfmesos_tpu_torch.server``), the port's and JAX's SUBSCRIBE and
ACCEPT bodies are equal on the same inputs, and ``cluster()`` and
``tfrun -m`` run the port's ``plus`` (42) through a ``zk://`` master on
the fake master and agent of ``tests/torch_fake_mesos.py``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_jax_cases import port_cases, port_module
from torch_fake_mesos import FakeMesos, FakeZK

ROOT = Path(__file__).resolve().parent.parent

globals().update(port_cases("test_mesos_backend.py"))
globals().update(port_cases("test_zk.py"))

_golden = port_module("test_mesos_golden.py")
_check_jax_golden = _golden._check_golden


def _check_golden(name, payload):
    """The JAX golden check, after the one stated difference: the port's
    node runtime is ``-m tfmesos_tpu_torch.server``."""
    text = json.dumps(payload)
    assert "-m tfmesos_tpu_torch.server" in text or "SUBSCRIBE" in text
    _check_jax_golden(name, json.loads(text.replace(
        "-m tfmesos_tpu_torch.server", "-m tfmesos_tpu.server")))


_golden._check_golden = _check_golden
globals().update({k: v for k, v in vars(_golden).items()
                  if k.startswith("test_golden")})


def _bodies(mesos_mod, spec_mod):
    """SUBSCRIBE (fresh and failover) and ACCEPT bodies of one backend
    on fixed inputs, each launch shape of the goldens."""
    b = mesos_mod.MesosBackend("127.0.0.1:5050", framework_name="fw",
                               role="gpu", user="svc")
    out = [b._subscribe_body()]
    b.framework_id = "FW-9"
    out.append(b._subscribe_body())
    for resource, kw in (("gpus", {}),
                         ("tpus", {"secret_token": True}),
                         ("gpus", {"token_file": "/tmp/tok",
                                   "docker_image": "img:1",
                                   "containerizer_type": "DOCKER"})):
        offer = spec_mod.Offer(id="o-1", agent_id="a-1", hostname="h",
                               cpus=8.0, mem=4096.0, chips=2,
                               chips_resource=resource)
        task = spec_mod.Task("worker", 1, cpus=1.0, mem=512.0, chips=1)
        task.id = "task-fixed-1"
        task.volumes = {"/data": "/mnt/data"}
        ti = task.to_task_info(offer, "127.0.0.1:7077", token="tok",
                               env={"A": "1"}, **kw)
        out.append(b._with_envelope(b._accept_body(offer, [ti])))
    return json.loads(json.dumps(out).replace(
        "-m tfmesos_tpu_torch.server", "-m tfmesos_tpu.server"))


def test_subscribe_and_accept_bodies_equal_jax():
    from tfmesos_tpu import spec as jax_spec
    from tfmesos_tpu.backends import mesos as jax_mesos
    from tfmesos_tpu_torch import spec
    from tfmesos_tpu_torch.backends import mesos

    mine, theirs = _bodies(mesos, spec), _bodies(jax_mesos, jax_spec)
    assert mine == theirs
    gpus = [r for r in mine[2]["accept"]["operations"][0]["launch"][
        "task_infos"][0]["resources"] if r["name"] == "gpus"]
    assert gpus == [{"name": "gpus", "type": "SCALAR",
                     "scalar": {"value": 1.0}}]


def test_scheduler_builds_mesos_for_every_master_form():
    from tfmesos_tpu_torch.backends.mesos import MesosBackend
    from tfmesos_tpu_torch.scheduler import TPUMesosScheduler

    master = FakeMesos()
    zk = FakeZK(master.addr)
    try:
        port = int(master.addr.rsplit(":", 1)[1])
        for form in (master.addr, f"http://{master.addr}", zk.url()):
            b = TPUMesosScheduler([], dynamic=True, master=form).backend
            assert isinstance(b, MesosBackend)
            assert (b.host, b.port) == ("127.0.0.1", port), form
    finally:
        zk.close()
        master.close()


@pytest.fixture(scope="module")
def zk_master():
    master = FakeMesos(cpus=8.0, mem=16384.0, gpus=2.0)
    zk = FakeZK(master.addr)
    try:
        yield master, zk
    finally:
        zk.close()
        master.close()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("MESOS_MASTER", None)
    return env


def test_plus_over_a_zk_master_prints_42(zk_master):
    """``cluster()`` over ``zk://``: plus's two Mode-A tasks are launched
    by the fake agent, all-reduce over gloo, and rank 0 prints 42."""
    master, zk = zk_master
    before = len(master.tasks)
    p = subprocess.run([sys.executable, "-m", "tfmesos_tpu_torch.plus",
                        zk.url(), "--device", "cpu"], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip() == "42"
    assert "plus: ['cpu', 'cpu'] over gloo" in p.stderr
    tasks = list(master.tasks.values())[before:]
    assert len(tasks) == 2
    assert {t.state for t in tasks} <= {"TASK_KILLED", "TASK_FINISHED"}
    kinds = [c["type"] for c in master.calls]
    assert "ACCEPT" in kinds and "ACKNOWLEDGE" in kinds \
        and kinds[-1] == "TEARDOWN"


def test_tfrun_master_runs_plus_on_each_worker(zk_master):
    """``tfrun -m zk://... -w 2 -s 0``: two Mode-B worker tasks on the
    fake agent each run the port's ``plus``; both print 42 through the
    forwarded logs, and tfrun exits 0."""
    master, zk = zk_master
    before = len(master.tasks)
    p = subprocess.run([sys.executable, "-m", "tfmesos_tpu_torch.cli",
                        "run", "-m", zk.url(), "-w", "2", "-s", "0",
                        "--worker-logs", "*", "--", sys.executable, "-m",
                        "tfmesos_tpu_torch.plus", "--device", "cpu"],
                       cwd=ROOT, env=_env(), capture_output=True,
                       text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.splitlines()
    assert sorted(x for x in lines if x.endswith(" 42")) == [
        "[worker:0] 42", "[worker:1] 42"]
    tasks = list(master.tasks.values())[before:]
    assert len(tasks) == 2
    assert all(t.exit_code == 0 for t in tasks)
    assert len(master.running_times()) >= 2
