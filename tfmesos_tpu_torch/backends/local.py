"""Local subprocess backend: run a whole "cluster" on this host (port of
``tfmesos_tpu/backends/local.py``).

It synthesizes offers describing the local host and launches tasks as
child processes, so the control plane (rendezvous, config, the Mode-B
node runtime, the failure policy) runs with no Mesos.  Unlike the JAX
backend it pins no platform in the children's environment: several port
processes share one card, and each chooses its device by its own flags
(a replica's ``--device``), never by an inherited variable.  Chips are
offered under the resource name ``gpus``.
"""

from __future__ import annotations

import os
import shlex
import signal
import subprocess
import threading
import time
import uuid
from typing import Dict, List, Optional, Sequence

from tfmesos_tpu_torch.backends import ResourceBackend
from tfmesos_tpu_torch.spec import Offer, TaskStatus
from tfmesos_tpu_torch.utils.logging import get_logger


class LocalBackend(ResourceBackend):
    colocated = True

    def __init__(self, cpus: Optional[float] = None, mem: float = 1 << 20,
                 chips: int = 0, offer_interval: float = 0.05,
                 inherit_env: bool = True, chaos=None):
        # "cpus" here are scheduling slots, not a pinning claim: this backend
        # exists to run many-task dev clusters on small hosts, so advertise a
        # generous floor rather than the literal core count.
        self.cpus = float(cpus if cpus is not None else max(os.cpu_count() or 1, 16))
        self.mem = float(mem)
        self.chips = chips
        self.offer_interval = offer_interval
        self.inherit_env = inherit_env
        # Optional chaos.FaultPlan: launched pids register with it (so
        # kill_task faults can SIGKILL by job:index name) and drop_agent
        # faults execute through chaos_drop_agent below.
        self.chaos = chaos
        self.log = get_logger("tfmesos_tpu_torch.local")

        self._scheduler = None
        self._suppressed = threading.Event()
        self._shutdown = threading.Event()
        self._offer_thread: Optional[threading.Thread] = None
        self._procs: Dict[str, subprocess.Popen] = {}
        self._in_use = [0.0, 0.0, 0]  # cpus, mem, chips
        self._lock = threading.Lock()

    # -- ResourceBackend ---------------------------------------------------

    def start(self, scheduler) -> None:
        self._scheduler = scheduler
        if self.chaos is not None:
            self.chaos.bind_backend(self)
        scheduler.on_registered({"backend": "local", "cpus": self.cpus,
                                 "mem": self.mem, "chips": self.chips})
        self._offer_thread = threading.Thread(target=self._offer_loop,
                                              name="local-offers", daemon=True)
        self._offer_thread.start()

    def _offer_loop(self) -> None:
        while not self._shutdown.is_set():
            if not self._suppressed.is_set():
                with self._lock:
                    free = Offer(
                        id=str(uuid.uuid4()), agent_id="local",
                        hostname="127.0.0.1",
                        cpus=self.cpus - self._in_use[0],
                        mem=self.mem - self._in_use[1],
                        chips=self.chips - self._in_use[2],
                        chips_resource="gpus",
                    )
                if free.cpus > 0 and free.mem > 0:
                    try:
                        self._scheduler.on_offers([free])
                    except Exception as e:  # pragma: no cover - defensive
                        self.log.exception("offer delivery failed: %s", e)
            self._shutdown.wait(self.offer_interval)

    def launch(self, offer: Offer, task_infos: Sequence[dict]) -> None:
        for info in task_infos:
            task_id = info["task_id"]["value"]
            env = dict(os.environ) if self.inherit_env else {}
            for var in info["command"]["environment"]["variables"]:
                env[var["name"]] = var["value"]
            cmd = info["command"]["value"]
            argv = cmd if info["command"].get("shell") else shlex.split(cmd)
            res = info["resources"]
            used = [_res(res, "cpus"), _res(res, "mem"), int(_res(res, "gpus"))]
            with self._lock:
                for i in range(3):
                    self._in_use[i] += used[i]
            try:
                proc = subprocess.Popen(argv,
                                        shell=bool(info["command"].get("shell")),
                                        env=env, start_new_session=True)
            except OSError as e:
                # A spawn failure (bad interpreter, ENOENT, EMFILE...) must
                # feed the failure policy, not vanish into a log line with
                # the task stuck offered=True until start_timeout.
                with self._lock:
                    for i in range(3):
                        self._in_use[i] -= used[i]
                self.log.warning("local launch of %s failed: %s",
                                 task_id[:8], e)
                self._scheduler.on_status(TaskStatus(
                    task_id, "TASK_DROPPED", message=f"launch failed: {e}",
                    agent_id="local"))
                continue
            self._procs[task_id] = proc
            self.log.info("launched local task %s pid=%d", task_id[:8], proc.pid)
            if self.chaos is not None:
                self.chaos.observe_launch(info.get("name", task_id),
                                          task_id, proc.pid)
            self._scheduler.on_status(TaskStatus(task_id, "TASK_RUNNING",
                                                 agent_id="local"))
            threading.Thread(target=self._watch, args=(task_id, proc, used),
                             name=f"watch-{task_id[:8]}", daemon=True).start()

    def _watch(self, task_id: str, proc: subprocess.Popen, used) -> None:
        rc = proc.wait()
        with self._lock:
            for i in range(3):
                self._in_use[i] -= used[i]
        if self._shutdown.is_set():
            return
        state = "TASK_FINISHED" if rc == 0 else "TASK_FAILED"
        self._scheduler.on_status(
            TaskStatus(task_id, state, message=f"exit code {rc}", agent_id="local"))

    def decline(self, offer: Offer, refuse_seconds: float = 5.0) -> None:
        pass  # synthetic offers; nothing to return

    def suppress(self) -> None:
        self._suppressed.set()

    def revive(self) -> None:
        self._suppressed.clear()

    def kill(self, task_id: str) -> None:
        proc = self._procs.get(task_id)
        if proc is not None and proc.poll() is None:
            _terminate(proc)

    def chaos_drop_agent(self) -> None:
        """Fault-injection entry (chaos.FaultPlan 'drop_agent'): the whole
        agent vanishes — every task process group SIGKILLed at once, then
        the agent-lost callback, exactly the order a real host loss
        presents."""
        for proc in list(self._procs.values()):
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
        self._scheduler.on_agent_lost("local")

    def stop(self) -> None:
        self._shutdown.set()
        for proc in self._procs.values():
            if proc.poll() is None:
                _terminate(proc)
        # A task is its whole process group (the node runtime, its shell,
        # the command): wait for every member, not the leader alone — a
        # replica still draining after its runtime exited would outlive
        # the backend and keep holding its card.
        deadline = time.monotonic() + 5.0
        groups = [proc.pid for proc in self._procs.values()]
        for proc in self._procs.values():
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        while _live_groups(groups) and time.monotonic() < deadline:
            time.sleep(0.02)
        for pgid in _live_groups(groups):
            try:
                os.killpg(pgid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        if self._offer_thread is not None:
            self._offer_thread.join(timeout=2.0)


def _live_groups(pgids: List[int]) -> List[int]:
    """The process groups of ``pgids`` that still hold a live (not
    zombie) process: read from ``/proc`` where there is one (a zombie
    stays a group member until its new parent reaps it), else asked of
    the kernel with signal 0."""
    want = set(pgids)
    if not want:
        return []
    if not os.path.isdir("/proc"):
        live = []
        for pgid in want:
            try:
                os.killpg(pgid, 0)
                live.append(pgid)
            except (ProcessLookupError, PermissionError):
                pass
        return live
    live = set()
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[0] != "Z" and int(fields[2]) in want:
            live.add(int(fields[2]))
    return sorted(live)


def _terminate(proc: subprocess.Popen) -> None:
    # Tasks are session leaders (start_new_session=True) so Mode B shell
    # children die with them.
    try:
        os.killpg(proc.pid, signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        try:
            proc.terminate()
        except ProcessLookupError:
            pass


def _res(resources: List[dict], name: str) -> float:
    for r in resources:
        if r["name"] == name:
            return float(r["scalar"]["value"])
    return 0.0
