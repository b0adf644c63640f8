"""Cluster scheduler: offer matching, rendezvous, config delivery and
SPMD dispatch (port of ``tfmesos_tpu/scheduler.py``).

``TPUMesosScheduler`` owns the task table and talks to a narrow
:class:`~tfmesos_tpu_torch.backends.ResourceBackend`: ``LocalBackend``
with no master, ``MesosBackend`` for a ``host:port``, ``http://`` or
``zk://`` one.  Three shapes of job run:

* a **static gang** — bring-up waits until every task registered, sends
  each its config (rank, world size, cluster map, the coordinator: rank
  0's host and its reserved port) and awaits the acks.  A task with a
  command (Mode B) then execs it; a task without one (Mode A) joins the
  process group and stays on its control connection, over which
  :meth:`run` / :meth:`run_on` / :meth:`run_all` dispatch functions.
  Before the cluster starts a dead task is revived with a fresh id up
  to ``MAX_FAILURE_COUNT``; after it, any death is fatal (fail-fast).
* the same under ``restart_policy="elastic"``: a death after start
  tears the survivors down, bumps the cluster **generation** and
  re-forms the whole gang from fresh offers, with exponential backoff,
  jitter and a sliding-window restart budget before it goes fatal after
  all.  The generation is the fencing token: launches carry it in
  ``TPUMESOS_GENERATION``, registrations and Mode-A replies echo it,
  and a registration or reply of another generation is dropped.  A
  dispatch that meets the recovery raises :class:`ClusterError`; the
  caller waits with :meth:`wait_ready` and resumes from its checkpoint.
* **dynamic mode** (the serving fleet) — the table starts empty and
  :meth:`add_task` / :meth:`remove_task` grow and shrink it at runtime;
  each registration is served on its own, and a task death is a serving
  event (``on_dynamic_death``), never a cluster-fatal one.
  :meth:`add_gang` adds N tasks as one gang replica, placed
  all-or-nothing within an offer batch.

``chaos=`` takes a :class:`~tfmesos_tpu_torch.chaos.FaultPlan`: each
SPMD dispatch counts as one ``scheduler.dispatch`` event, so "kill task
i at dispatch N" replays a mid-training preemption exactly.
"""

from __future__ import annotations

import collections
import getpass
import os
import random
import selectors
import socket
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from tfmesos_tpu_torch import wire
from tfmesos_tpu_torch.backends import FOREVER, ResourceBackend, first_fit
from tfmesos_tpu_torch.spec import Job, Offer, Task, TaskStatus
from tfmesos_tpu_torch.utils.logging import get_logger

__all__ = ["MAX_FAILURE_COUNT", "ClusterError", "RemoteError",
           "TPUMesosScheduler"]

MAX_FAILURE_COUNT = 3


class ClusterError(RuntimeError):
    """Fatal cluster failure."""


class RemoteError(ClusterError):
    """A dispatched function raised on a task: a failure of user code,
    not of the infrastructure.  Restart supervision must not retry it."""


class TPUMesosScheduler:
    """Owns the task table and drives bring-up → run → teardown.

    ``chips`` count accelerator cards per task (``gpus`` is accepted as
    an alias on :class:`~tfmesos_tpu_torch.spec.Job`).  The elastic
    policy's knobs are the JAX scheduler's: ``max_cluster_restarts``
    within ``restart_window`` seconds, a backoff of ``restart_backoff``
    doubling per restart up to ``restart_backoff_max``, stretched by up
    to ``restart_jitter`` of itself from a ``restart_seed``-ed RNG."""

    def __init__(self, task_spec: List[Job], backend: Optional[ResourceBackend] = None,
                 master: Optional[str] = None, name: Optional[str] = None,
                 quiet: bool = False, volumes: Optional[Dict[str, str]] = None,
                 containerizer_type: Optional[str] = None,
                 force_pull_image: bool = False,
                 forward_addresses: Optional[Dict[str, str]] = None,
                 protocol: str = "xla", env: Optional[Dict[str, str]] = None,
                 extra_config: Optional[Dict[str, Any]] = None,
                 role: str = "*", mesh_axes: Optional[Dict[str, int]] = None,
                 gang_scheduling: bool = False,
                 start_timeout: float = 300.0,
                 token_transport: Optional[str] = None,
                 token: Optional[str] = None,
                 restart_policy: str = "fail_fast",
                 max_cluster_restarts: int = 3,
                 restart_window: float = 600.0,
                 restart_backoff: float = 1.0,
                 restart_backoff_max: float = 30.0,
                 restart_jitter: float = 0.1,
                 restart_seed: Optional[int] = None,
                 dynamic: bool = False,
                 chaos=None):
        if restart_policy not in ("fail_fast", "elastic"):
            raise ValueError(f"restart_policy must be fail_fast|elastic, "
                             f"got {restart_policy!r}")
        self.task_spec = task_spec
        self.master = master or os.environ.get("MESOS_MASTER")
        self.name = name or f"[tpumesos] {getpass.getuser()} {' '.join(sys.argv)}"
        self.quiet = quiet
        self.volumes = volumes or {}
        self.containerizer_type = containerizer_type
        self.force_pull_image = force_pull_image
        self.forward_addresses = forward_addresses or {}
        self.protocol = protocol
        self.extra_config = extra_config or {}
        self.role = role
        self.mesh_axes = mesh_axes
        self.gang_scheduling = gang_scheduling
        self.start_timeout = start_timeout
        self.env = dict(env or {})
        # Dynamic mode (the serving fleet): the task table is a runtime
        # property — add_task()/remove_task() grow and shrink it after
        # start(), registrations are served continuously instead of
        # through one barrier, and a task death is a SERVING event (the
        # fleet re-converges), never a cluster-fatal one.  Elastic
        # recovery is whole-gang replacement and has no meaning over a
        # membership that changes one task at a time.
        self.dynamic = bool(dynamic)
        if self.dynamic and restart_policy == "elastic":
            raise ValueError("dynamic task management and elastic gang "
                             "recovery are mutually exclusive: a dynamic "
                             "fleet has no gang to re-form")
        self.restart_policy = restart_policy
        self.max_cluster_restarts = int(max_cluster_restarts)
        self.restart_window = float(restart_window)
        self.restart_backoff = float(restart_backoff)
        self.restart_backoff_max = float(restart_backoff_max)
        self.restart_jitter = float(restart_jitter)
        # Seedable jitter, so a recovery's timing replays exactly.
        self._restart_rng = random.Random(restart_seed)
        self.chaos = chaos

        self.log = get_logger("tfmesos_tpu_torch.scheduler", quiet=quiet)
        # One token per bring-up by default; an explicit ``token`` lets
        # co-resident control-plane services (the fleet's registry and
        # gateway) share a single cluster secret with the tasks.
        self.token = token or wire.new_token()

        # Expand Jobs into the task table.  Creation order — jobs in
        # declared order, indices ascending — IS the global rank order.
        self.tasks: List[Task] = []
        for job in task_spec:
            for task_index in range(job.start, job.num):
                self.tasks.append(Task(job.name, task_index, cpus=job.cpus,
                                       mem=job.mem, chips=job.chips,
                                       cmd=job.cmd, volumes=self.volumes))

        if backend is None:
            backend = self._default_backend()
        self.backend = backend

        # How tasks learn the HMAC token: co-located backends default to
        # a mode-0600 file (an env var is readable through /proc).
        colocated = getattr(backend, "colocated", False)
        if token_transport is None:
            token_transport = "file" if colocated else "env"
        if token_transport not in ("env", "file", "secret"):
            raise ValueError(f"token_transport must be env|file|secret, "
                             f"got {token_transport!r}")
        if token_transport == "file" and not colocated:
            raise ValueError(
                "token_transport='file' needs a colocated backend: a remote "
                "task cannot read the scheduler's local token file")
        if token_transport == "secret" and colocated:
            raise ValueError(
                "token_transport='secret' is a Mesos secret-resolver "
                "feature; colocated backends use 'file' (the default)")
        self.token_transport = token_transport
        self._token_file: Optional[str] = None

        if not self.tasks and not self.dynamic:
            raise ValueError("job spec expands to zero tasks")
        # Per-job index counters and bring-up failure counts for tasks
        # added at runtime (dynamic mode).
        self._dyn_index: Dict[str, int] = {}
        for task in self.tasks:
            self._dyn_index[task.job_name] = max(
                self._dyn_index.get(task.job_name, 0), task.task_index + 1)
        self.dynamic_failures: Dict[str, int] = {}
        # Dynamic-death notification: called with the dead Task AFTER it
        # left the table, on a fresh thread (a callback may kill or
        # launch tasks, which must never run on the status thread).
        self.on_dynamic_death = None
        self._gang_seq = 0

        self._lock = threading.RLock()
        self.started = False
        self._registered_once = False
        self._broadcasting = False
        self._stopped = False
        self._fatal: Optional[str] = None
        # Heartbeat-revive gating: the backstop only fires on EVIDENCE the
        # offer tap is closed (a revive failed, or no offer since the
        # last heartbeat).
        self._revive_failed = False
        self._offers_since_beat = False
        self.task_failure_count: Dict[str, int] = {}
        self.job_finished: Dict[str, int] = {}
        self._listen: Optional[socket.socket] = None
        self.addr: Optional[str] = None
        self._call_id = 0

        # Elastic recovery state.  ``generation`` is the gang epoch: it
        # is stamped into every launch's env, echoed in registrations
        # and Mode-A replies, and bumped the moment a recovery is
        # accepted.
        self.generation = 0
        self.cluster_restarts = 0           # successful re-formations
        self._recovering = False
        self._recover_teardown_done = False
        self._recover_reason: Optional[str] = None
        self._recover_event = threading.Event()
        self._restart_times: collections.deque = collections.deque()
        self._backoff_exponent = 0
        self._elastic_thread: Optional[threading.Thread] = None
        self._dynamic_thread: Optional[threading.Thread] = None

    # -- backend selection -------------------------------------------------

    def _default_backend(self) -> ResourceBackend:
        if self.master in (None, "", "local"):
            from tfmesos_tpu_torch.backends.local import LocalBackend
            return LocalBackend()
        try:
            from tfmesos_tpu_torch.backends.mesos import MesosBackend
        except ImportError as e:
            raise ClusterError(f"Mesos backend unavailable: {e}") from e
        return MesosBackend(self.master, framework_name=self.name,
                            role=self.role)

    # -- backend callback surface -----------------------------------------

    def on_registered(self, info: Dict[str, Any]) -> None:
        self.log.info("backend registered: %s", info)
        with self._lock:
            rejoin = self._registered_once
            self._registered_once = True
            unplaced = any(not t.offered for t in self.tasks)
        if rejoin and unplaced:
            # Re-subscription after a stream break: a REVIVE issued while
            # the master was unreachable may have been lost, and FOREVER
            # decline filters survive failover — re-open the offer tap.
            self._revive_backend("re-registration")
        version = info.get("master_version")
        if self.containerizer_type is None and version:
            # Reference semantics (scheduler.py:378-382): Mesos >= 1.0 uses
            # the unified MESOS containerizer, older masters need DOCKER.
            try:
                major = int(str(version).split(".")[0])
            except ValueError:
                return
            self.containerizer_type = "MESOS" if major >= 1 else "DOCKER"
            self.log.info("auto-detected containerizer %s (master %s)",
                          self.containerizer_type, version)

    def on_offers(self, offers: List[Offer]) -> None:
        """Offer matching (reference resourceOffers, scheduler.py:223-277).

        State decisions and TaskInfo rendering happen under ``_lock``;
        the backend calls they produce (HTTP POSTs on Mesos, up to 30s
        each) run OUTSIDE it, so a slow master never stalls ``on_status``
        processing on the subscribe thread.
        """
        to_decline: List[tuple] = []        # (offer, refuse_seconds)
        to_launch: List[tuple] = []         # (offer, infos, placed, ids)
        suppress = False
        with self._lock:
            self._offers_since_beat = True
            if self._fatal or self._stopped:
                to_decline = [(o, 5.0) for o in offers]
            elif all(task.offered for task in self.tasks):
                suppress = True
                to_decline = [(o, FOREVER) for o in offers]
            elif self.gang_scheduling and not self._gang_fits(offers):
                # TPU slice atomicity: refuse partial placement; short
                # refusal so re-offers accumulate into a big enough batch.
                to_decline = [(o, 1.0) for o in offers]
            else:
                batch_tasks = self._batch_order(offers)
                for offer in offers:
                    placed = first_fit(batch_tasks, offer)
                    if not placed:
                        to_decline.append((offer, 5.0))
                        continue
                    infos = [t.to_task_info(offer, self.addr, self.token,
                                            containerizer_type=self.containerizer_type,
                                            force_pull_image=self.force_pull_image,
                                            env=self._launch_env(t),
                                            token_file=self._token_file,
                                            secret_token=(self.token_transport
                                                          == "secret"))
                             for t in placed]
                    to_launch.append((offer, infos, placed,
                                      [t.id for t in placed]))
        if suppress:
            self.backend.suppress()
        for offer, refuse_seconds in to_decline:
            self.backend.decline(offer, refuse_seconds=refuse_seconds)
        for offer, infos, placed, ids in to_launch:
            with self._lock:
                # A terminal status on another thread (LocalBackend's
                # reaper) can reset() a placed task between rendering and
                # this launch; launching the stale batch would spawn
                # processes under ids the scheduler no longer tracks.
                stale = [t for t, tid in zip(placed, ids) if t.id != tid]
                if stale:
                    for t, tid in zip(placed, ids):
                        if t.id == tid and t.offered:
                            # Un-place the still-valid batchmates (nothing
                            # launched); the next offer re-places them.
                            t.offered = False
                            t.offer_id = t.agent_id = t.hostname = None
            if stale:
                self.log.warning(
                    "dropping launch on %s: %d task(s) reset between "
                    "placement and launch", offer.hostname, len(stale))
                self.backend.decline(offer, refuse_seconds=1.0)
                continue
            self.log.info("launching %d task(s) on %s: %s",
                          len(placed), offer.hostname, placed)
            self.backend.launch(offer, infos)
            with self._lock:
                # The reset can also race the launch call itself (the
                # pre-check only narrows the window): a task reset DURING
                # backend.launch leaves a process running under an id the
                # scheduler no longer tracks — terminal statuses for
                # unknown ids are ignored, so it would leak.  Kill it.
                dead = [tid for t, tid in zip(placed, ids) if t.id != tid]
            for tid in dead:
                self.log.warning("task %s reset during launch; killing the "
                                 "stale process", tid[:8])
                try:
                    self.backend.kill(tid)
                except Exception as e:
                    self.log.warning("stale-launch kill of %s failed: %s",
                                     tid[:8], e)

    def _batch_order(self, offers: List[Offer]) -> List:
        """Gang-atomic placement order for one offer batch (lock held).

        Tasks added by :meth:`add_gang` carry a ``gang`` label, and a
        gang is placed ALL-OR-NOTHING within a batch: a reservation pass
        checks each gang's unplaced members against the batch's free
        capacity (in the greedy order ``first_fit`` will use), admits
        the gangs that wholly fit and withholds the rest for a later,
        bigger batch.  A gang may split across the batch's offers
        (hosts), never across batches.  Admitted members sort first so
        loose tasks cannot eat the capacity just reserved."""
        loose = [t for t in self.tasks
                 if getattr(t, "gang", None) is None]
        gangs: Dict[str, List] = {}
        for t in self.tasks:
            g = getattr(t, "gang", None)
            if g is not None and not t.offered:
                gangs.setdefault(g, []).append(t)
        if not gangs:
            return loose
        free = [[o.cpus, o.mem, o.chips] for o in offers]
        admitted: List = []
        for gid, members in gangs.items():
            trial = [slot[:] for slot in free]
            for t in members:
                for slot in trial:
                    if (slot[0] >= t.cpus and slot[1] >= t.mem
                            and slot[2] >= t.chips):
                        slot[0] -= t.cpus
                        slot[1] -= t.mem
                        slot[2] -= t.chips
                        break
                else:
                    self.log.info(
                        "withholding gang %s from this offer batch: "
                        "%d member(s) do not all fit", gid, len(members))
                    break
            else:
                free = trial
                admitted.extend(members)
        return admitted + loose

    def _gang_fits(self, offers: List[Offer]) -> bool:
        """Would the *entire* remaining task set fit across this offer batch?"""
        free = [[o.cpus, o.mem, o.chips] for o in offers]
        for task in self.tasks:
            if task.offered:
                continue
            for slot in free:
                if slot[0] >= task.cpus and slot[1] >= task.mem and slot[2] >= task.chips:
                    slot[0] -= task.cpus
                    slot[1] -= task.mem
                    slot[2] -= task.chips
                    break
            else:
                return False
        return True

    def on_status(self, status: TaskStatus) -> None:
        """Two-phase failure policy (reference statusUpdate,
        scheduler.py:384-420)."""
        # The ack and revive are HTTP POSTs on Mesos — keep them outside
        # the lock (a slow master must not stall other status processing).
        self.backend.acknowledge(status)
        revive = False
        with self._lock:
            task = self._find_task(status.task_id)
            if task is None:
                if status.terminal and status.state != "TASK_FINISHED":
                    # Update for a stale (revived) task id — ignore, as the
                    # reference does for unknown ids.
                    self.log.info("status for unknown task %s: %s",
                                  status.task_id, status.state)
                return
            task.last_state = status.state
            if not status.terminal:
                return
            if getattr(task, "dynamic", False):
                # A dynamic (serving) task's death is a SERVING event:
                # drop it from the table — the fleet routes around it and
                # the autoscaler re-converges the tier — never a
                # cluster-fatal or a revive charge.  (Tasks removed via
                # remove_task() report under an id no longer in the
                # table and land in the unknown-id branch above.)
                self.tasks.remove(task)
                if status.state == "TASK_FINISHED":
                    self.log.info("dynamic task finished: %s", task)
                else:
                    self.dynamic_failures[task.job_name] = \
                        self.dynamic_failures.get(task.job_name, 0) + 1
                    self.log.warning("dynamic task %s terminated: %s %s",
                                     task, status.state, status.message)
                    cb = self.on_dynamic_death
                    if cb is not None:
                        # Off-thread: the callback (gang teardown) kills
                        # sibling tasks — backend HTTP it must not run
                        # on the status thread or under our lock.
                        threading.Thread(
                            target=self._fire_dynamic_death,
                            args=(cb, task), daemon=True,
                            name="tpumesos-dyn-death").start()
                return
            if status.state == "TASK_FINISHED":
                self.job_finished[task.job_name] = \
                    self.job_finished.get(task.job_name, 0) + 1
                self.log.info("task finished: %s (%d done in job %s)",
                              task, self.job_finished[task.job_name], task.job_name)
                return
            elif self.started or self._broadcasting:
                # Post-start (or mid-broadcast, when peers may already be
                # acting on their config): fail fast, whole-cluster abort
                # — unless the elastic policy re-forms the gang.
                self._post_start_failure(
                    f"task {task} terminated after cluster start: "
                    f"{status.state} {status.message}")
            elif self._recovering and not self._recover_teardown_done:
                # A recovery was accepted and the old gang is not torn
                # down yet: these are that gang's expected deaths (one
                # host loss reports once per task).  Reviving here would
                # relaunch with no backoff for the teardown to kill and
                # charge the bring-up budget for deaths that already
                # bought the recovery.
                self.log.info("ignoring terminal status for %s during "
                              "gang teardown: %s", task, status.state)
            else:
                # Pre-start: revive with a fresh uuid up to MAX_FAILURE_COUNT
                # (reference: scheduler.py:404-434).
                key = f"{task.job_name}:{task.task_index}"
                self.task_failure_count[key] = \
                    self.task_failure_count.get(key, 0) + 1
                if self.task_failure_count[key] >= MAX_FAILURE_COUNT:
                    self._set_fatal(
                        f"task {task} failed {MAX_FAILURE_COUNT} times "
                        f"during bring-up: {status.state} {status.message}")
                else:
                    self.log.warning("reviving task %s after %s (%s), "
                                     "attempt %d", task, status.state,
                                     status.message,
                                     self.task_failure_count[key] + 1)
                    task.reset()
                    revive = True
        if revive:
            # Task state is already reset; a failed REVIVE POST (master
            # unreachable) must not unwind the event thread — the
            # heartbeat backstop and the re-registration hook re-issue it
            # (_revive_backend tracks the failure for them).
            self._revive_backend("post-status")

    def on_rescind(self, offer_id: str) -> None:
        """An outstanding offer was withdrawn by the master.  Tasks placed
        on it whose launch never confirmed (no TASK_RUNNING seen) are
        RE-QUEUED for placement — without this they would sit
        offered=True until ``start_timeout``.  Rescinds are ordinary
        offer churn on a busy master, not task failures: they do NOT
        consume the two-phase failure budget (three rescinds of one
        slot's placements must not abort a cluster where nothing ever
        crashed).  The reference ignored rescinds entirely (no
        offerRescinded handler); a stale-offer launch then hung its
        bring-up."""
        to_requeue: List[str] = []
        revive = False
        with self._lock:
            for task in self.tasks:
                if (task.offer_id == offer_id and task.offered
                        and not task.initialized
                        and task.last_state != "TASK_RUNNING"):
                    to_requeue.append(task.id)
                    self.log.warning(
                        "offer %s rescinded before launch of %s confirmed; "
                        "re-queuing placement", offer_id, task)
                    task.reset()
                    revive = True
        for tid in to_requeue:
            # The ACCEPT may have raced the rescind server-side; a KILL for
            # a task that never launched is a no-op, and one that did
            # launch must die anyway (its id is now stale).  Guarded: one
            # failed HTTP call must not strand the remaining tasks.
            try:
                self.backend.kill(tid)
            except Exception as e:
                self.log.warning("rescind kill of %s failed: %s", tid[:8], e)
        if revive:
            self._revive_backend("rescind")

    def _revive_backend(self, context: str) -> None:
        """One revive POST with failure tracking: a failed POST arms the
        heartbeat backstop (``on_heartbeat``) to retry."""
        try:
            self.backend.revive()
            with self._lock:
                self._revive_failed = False
        except Exception as e:
            with self._lock:
                self._revive_failed = True
            self.log.warning("%s revive failed: %s", context, e)

    def on_heartbeat(self) -> None:
        """Master heartbeat (~15s): the liveness backstop for a REVIVE
        that failed or was rejected while the subscribe stream stayed
        healthy — with FOREVER decline filters active after suppression,
        nothing else would ever re-open the offer tap for an unplaced
        task (bring-up would idle into start_timeout).

        Gated on EVIDENCE the tap is closed: a prior revive POST failed,
        or no offer arrived since the last heartbeat.  While offers are
        flowing normally (gang scheduling's short declines included) an
        unconditional revive would clear every decline filter ~15s and
        spam re-offers on a busy master."""
        with self._lock:
            need = (not self._stopped and self._fatal is None
                    and (not self.started or self.dynamic)
                    and any(not t.offered for t in self.tasks)
                    and (self._revive_failed
                         or not self._offers_since_beat))
            self._offers_since_beat = False
        if need:
            self._revive_backend("heartbeat")

    def on_agent_lost(self, agent_id: str) -> None:
        """A lost agent: after start fatal, or a gang re-formation under
        the elastic policy; before start a revive of its tasks."""
        with self._lock:
            if self.started:
                self._post_start_failure(f"agent lost: {agent_id}")
                return
            lost = [task.id for task in self.tasks
                    if task.agent_id == agent_id and not task.initialized]
        for tid in lost:
            self.on_status(TaskStatus(tid, "TASK_LOST",
                                      message="agent lost",
                                      agent_id=agent_id))

    def on_error(self, message: str) -> None:
        self._set_fatal(f"backend error: {message}")

    def _set_fatal(self, message: str) -> None:
        if self._fatal is None:
            self._fatal = message
            self.log.error("fatal: %s", message)
            # Unpark the elastic thread so it sees the fatal and exits.
            self._recover_event.set()

    def _launch_env(self, task=None) -> Dict[str, str]:
        """Per-launch env: the user's plus the task's launch generation
        (echoed in its registration) and any per-task extra env."""
        env = dict(self.env)
        gen = getattr(task, "generation", None) if task is not None else None
        env["TPUMESOS_GENERATION"] = str(
            self.generation if gen is None else gen)
        extra = getattr(task, "extra_env", None) if task is not None else None
        if extra:
            env.update(extra)
        return env

    # -- elastic recovery --------------------------------------------------

    def _post_start_failure(self, why: str) -> None:
        """A task or agent died after cluster start (lock held): fatal
        under fail_fast, a recovery request under elastic."""
        if self.restart_policy != "elastic":
            self._set_fatal(why)
        else:
            self._request_recovery(why)

    def _charge_restart(self, why: str) -> bool:
        """Spend one unit of the sliding-window restart budget (lock
        held).  False — and the cluster is fatal — when the window
        already holds ``max_cluster_restarts`` restarts: a crash loop
        faster than the window is a problem restarts cannot fix."""
        now = time.monotonic()
        while (self._restart_times
               and now - self._restart_times[0] > self.restart_window):
            self._restart_times.popleft()
        if len(self._restart_times) >= self.max_cluster_restarts:
            self._set_fatal(
                f"elastic restart budget exhausted "
                f"({self.max_cluster_restarts} restarts within "
                f"{self.restart_window:.0f}s): {why}")
            return False
        self._restart_times.append(now)
        self._backoff_exponent = len(self._restart_times) - 1
        return True

    def _request_recovery(self, why: str) -> None:
        """Accept a post-start failure as a recovery (lock held): charge
        the budget, bump the generation, mark the cluster un-started and
        wake the recovery thread.  Idempotent while a recovery is in
        flight: one lost host surfaces as many signals (a dispatch's
        EOF, a terminal status a task, the agent) and buys exactly one
        re-formation."""
        if self._fatal or self._stopped or self._recovering:
            return
        if not self._charge_restart(why):
            return
        self._recovering = True
        self._recover_teardown_done = False
        self._recover_reason = why
        self.started = False
        self._broadcasting = False
        self.generation += 1
        self.log.warning("elastic recovery -> generation %d: %s",
                         self.generation, why)
        self._recover_event.set()

    def _elastic_loop(self) -> None:
        """The recovery thread: parked on ``_recover_event``, it runs one
        gang re-formation per accepted recovery."""
        while True:
            self._recover_event.wait()
            with self._lock:
                if self._stopped or self._fatal is not None:
                    return
                self._recover_event.clear()
                if not self._recovering:
                    continue
            try:
                self._recover()
            except Exception as e:      # pragma: no cover - defensive
                with self._lock:
                    self._set_fatal(f"elastic recovery crashed: {e}")
                return

    def _recover(self) -> None:
        """Tear the old gang down and form a new one, retrying (each retry
        charged to the restart budget) until the gang is up, the budget
        is spent, or the scheduler stops."""
        while True:
            with self._lock:
                if self._stopped or self._fatal is not None:
                    return
                backoff = min(
                    self.restart_backoff * (2 ** self._backoff_exponent),
                    self.restart_backoff_max)
                backoff *= (1.0 + self.restart_jitter
                            * self._restart_rng.random())
                generation = self.generation
            self.log.warning(
                "elastic: tearing down generation %d survivors; re-forming "
                "gang in %.2fs (restart %d)", generation - 1, backoff,
                len(self._restart_times))
            self._teardown_tasks()
            with self._lock:
                self._recover_teardown_done = True
            if self._interruptible_sleep(backoff):
                return
            with self._lock:
                if self._stopped or self._fatal is not None:
                    return
                # Fresh bring-up budgets for the new gang: the revive
                # counter guards one bring-up; crash loops across
                # generations are bounded by the restart window.
                self.task_failure_count.clear()
                self.job_finished.clear()
            self._revive_backend("elastic recovery")
            try:
                self._form_gang()
            except ClusterError as e:
                with self._lock:
                    if self._stopped or self._fatal is not None:
                        return
                    if not self._charge_restart(
                            f"gang re-formation failed: {e}"):
                        return
                self.log.warning("elastic: re-formation failed (%s); "
                                 "retrying", e)
                continue
            with self._lock:
                # _recovering was cleared with started=True inside
                # _start_cluster.
                self.cluster_restarts += 1
            self.log.warning("elastic: gang re-formed — generation %d live "
                             "(%d cluster restart(s) so far)",
                             generation, self.cluster_restarts)
            return

    def _teardown_tasks(self) -> None:
        """Give every task a fresh identity and kill whatever of the old
        gang still runs.  Survivors of a partial failure cannot be kept:
        the program they ran with the dead peer is gone (a survivor may
        be blocked in a collective with it), and their old connections
        and ids must never be mistaken for the new gang's."""
        with self._lock:
            old_ids = [t.id for t in self.tasks]
            for task in self.tasks:
                task.reset()        # closes the connection, fresh uuid
        for tid in old_ids:
            try:
                self.backend.kill(tid)
            except Exception as e:
                self.log.warning("teardown kill of %s failed: %s",
                                 tid[:8], e)

    def _interruptible_sleep(self, seconds: float) -> bool:
        """Sleep in short slices; True when stop or a fatal cut it."""
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            with self._lock:
                if self._stopped or self._fatal is not None:
                    return True
            time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))
        return False

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the cluster is started and not mid-recovery: True
        when ready, False on timeout; raises :class:`ClusterError` when
        the cluster went fatal (budget spent, bring-up dead).  The
        caller's half of the elastic policy: catch the
        :class:`ClusterError` a dispatch raised, ``wait_ready()``,
        restore the checkpoint, continue."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                if self._fatal:
                    raise ClusterError(self._fatal)
                if self._stopped:
                    raise ClusterError("scheduler stopped")
                if self.started and not self._recovering:
                    return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.05)

    @property
    def restart_stats(self) -> Dict[str, Any]:
        """The elastic policy's counters."""
        with self._lock:
            # Expire window-aged restarts, so restart_budget_left says
            # what _charge_restart would allow now.
            now = time.monotonic()
            while (self._restart_times
                   and now - self._restart_times[0] > self.restart_window):
                self._restart_times.popleft()
            return {
                "generation": self.generation,
                "cluster_restarts": self.cluster_restarts,
                "recovering": self._recovering,
                "restart_budget_left": max(
                    0, self.max_cluster_restarts - len(self._restart_times)),
            }

    def _fire_dynamic_death(self, cb, task) -> None:
        try:
            cb(task)
        except Exception as e:
            self.log.warning("on_dynamic_death(%s) raised: %s", task, e)

    def _find_task(self, task_id: str) -> Optional[Task]:
        for task in self.tasks:
            if task.id == task_id:
                return task
        return None

    # -- dynamic task management (serving fleets) --------------------------

    def add_task(self, job_name: str, cmd: str, cpus: float = 1.0,
                 mem: float = 1024.0, chips: int = 0,
                 env: Optional[Dict[str, str]] = None) -> Task:
        """Launch ONE new Mode-B task at runtime (dynamic mode only):
        the task enters the table with the NEXT index for its job, the
        offer tap re-opens, and its registration is served by the
        dynamic rendezvous.  The cluster generation current NOW is
        stamped on the task — a later rollout bump must not re-brand a
        launch that predates it.  ``env`` rides the launch env on top
        of the scheduler-wide one (gang identity travels this way)."""
        if not self.dynamic:
            raise ClusterError("add_task requires dynamic=True")
        with self._lock:
            task = self._add_task_locked(job_name, cmd, cpus, mem,
                                         chips, env)
        self.log.info("dynamic task added: %s (generation %d)", task,
                      task.generation)
        self._revive_backend("add_task")
        return task

    def _add_task_locked(self, job_name, cmd, cpus, mem, chips,
                         env) -> Task:
        if self._stopped:
            raise ClusterError("scheduler stopped")
        if self._fatal:
            raise ClusterError(self._fatal)
        index = self._dyn_index.get(job_name, 0)
        self._dyn_index[job_name] = index + 1
        task = Task(job_name, index, cpus=cpus, mem=mem,
                    chips=chips, cmd=cmd, volumes=self.volumes)
        task.dynamic = True
        task.generation = self.generation
        if env:
            task.extra_env = dict(env)
        self.tasks.append(task)
        return task

    def add_gang(self, job_name: str, cmds: List[str], cpus: float = 1.0,
                 mem: float = 1024.0, chips: int = 0,
                 envs: Optional[List[Dict[str, str]]] = None) -> List[Task]:
        """Launch N tasks as ONE atomic gang (dynamic mode only): all
        members enter the table under a single lock hold — one launch
        generation, one gang label — and the offer loop places the gang
        all-or-nothing within an offer batch.  Returns the member tasks
        in rank order; ``envs`` (one dict a member) rides each launch
        env under the gang identity this call stamps."""
        if not self.dynamic:
            raise ClusterError("add_gang requires dynamic=True")
        if not cmds:
            raise ValueError("add_gang needs at least one member cmd")
        if envs is not None and len(envs) != len(cmds):
            raise ValueError("envs must match cmds one-to-one")
        with self._lock:
            self._gang_seq += 1
            gang_id = f"{job_name}/g{self._gang_seq}"
            members = []
            for rank, cmd in enumerate(cmds):
                env = dict(envs[rank]) if envs else {}
                # Every member learns its identity from these three
                # variables; the caller cannot stamp them, since the
                # gang id is minted under this very lock hold.
                env["TPUMESOS_GANG_ID"] = gang_id
                env["TPUMESOS_GANG_SIZE"] = str(len(cmds))
                env["TPUMESOS_GANG_RANK"] = str(rank)
                task = self._add_task_locked(
                    job_name, cmd, cpus, mem, chips, env)
                task.gang = gang_id
                members.append(task)
            gen = members[0].generation
        self.log.info("dynamic gang added: %s x%d (generation %d)",
                      gang_id, len(members), gen)
        self._revive_backend("add_gang")
        return members

    def remove_task(self, task_id: str) -> bool:
        """Kill ONE task at runtime and forget it (dynamic mode only).
        Its terminal status then reports under an id no longer in the
        table and is ignored — deliberate: the removal was OUR
        decision, not a failure to react to."""
        if not self.dynamic:
            raise ClusterError("remove_task requires dynamic=True")
        with self._lock:
            task = self._find_task(task_id)
            if task is not None:
                self.tasks.remove(task)
        if task is None:
            return False
        self.log.info("dynamic task removed: %s", task)
        try:
            self.backend.kill(task_id)
        except Exception as e:
            self.log.warning("dynamic kill of %s failed: %s",
                             task_id[:8], e)
        return True

    def tasks_of(self, job_name: str) -> List[Task]:
        """Live tasks of one job (dynamic tiers poll this to converge
        actual toward target)."""
        with self._lock:
            return [t for t in self.tasks if t.job_name == job_name]

    def task_by_index(self, job_name: str, task_index: int) -> Optional[Task]:
        with self._lock:
            for t in self.tasks:
                if t.job_name == job_name and t.task_index == task_index:
                    return t
        return None

    def bump_generation(self) -> int:
        """Advance the fencing epoch (a blue-green rollout's shift
        token): tasks added after the bump launch, and register, with
        the new generation; stragglers of older generations can be
        fenced at the registry."""
        with self._lock:
            self.generation += 1
            return self.generation

    def _dynamic_accept_loop(self) -> None:
        """Post-start rendezvous: accept registrations forever and hand
        each dynamic task its config per-connection — a Mode-B serving
        task only needs its OWN config to exec, so there is no gang
        barrier here."""
        while True:
            with self._lock:
                if self._stopped:
                    return
            try:
                conn, _ = self._listen.accept()
            except OSError:
                return          # listener closed (stop())
            with self._lock:
                stopped = self._stopped
            if stopped:
                # The shutdown poke (wire.wake_listener), not a task.
                try:
                    conn.close()
                except OSError:
                    pass
                return
            threading.Thread(target=self._dynamic_handshake, args=(conn,),
                             name="dynamic-register", daemon=True).start()

    def _dynamic_config(self, task: Task) -> Dict[str, Any]:
        """The per-task config a dynamic registration receives — the
        same shape the gang broadcast sends, with membership computed
        from the live table (Mode-B serving tasks only read the env
        contract and ``cmd``)."""
        with self._lock:
            world = len(self.tasks)
            try:
                rank = self.tasks.index(task)
            except ValueError:
                rank = 0
            cluster_def: Dict[str, List[str]] = {}
            for t in self.tasks:
                cluster_def.setdefault(t.job_name, []).append(t.addr or "")
            gen = getattr(task, "generation", self.generation)
        return {
            "job_name": task.job_name, "task_index": task.task_index,
            "rank": rank, "world_size": world, "cpus": task.cpus,
            "mem": task.mem, "chips": task.chips, "cmd": task.cmd,
            "cwd": os.getcwd(), "cluster_def": cluster_def,
            "generation": gen, "coordinator": "",
            "forward_addresses": self.forward_addresses,
            "extra_config": self.extra_config, "protocol": self.protocol,
            "mesh_axes": self.mesh_axes or {}, "env": self.env,
        }

    def _dynamic_handshake(self, conn: socket.socket) -> None:
        """Serve ONE dynamic registration: validate (unknown/stale ids
        and stale generations dropped, exactly like the gang path),
        send the config, await the ack, mark the task initialized."""
        try:
            conn.settimeout(30.0)
            msg = wire.recv_msg(conn, self.token)
            if not (isinstance(msg, dict) and msg.get("op") == "register"):
                self.log.warning("unexpected dynamic rendezvous "
                                 "message: %r", msg)
                return
            task_id = msg.get("task_id", "")
            with self._lock:
                task = self._find_task(task_id)
                expect_gen = (getattr(task, "generation", self.generation)
                              if task is not None else None)
            if task is None:
                self.log.warning("dynamic registration from unknown/stale "
                                 "task id %s", task_id)
                return
            gen = msg.get("gen")
            if gen is not None:
                try:
                    gen = int(gen)
                except (TypeError, ValueError):
                    gen = -1
                if gen != expect_gen:
                    self.log.warning(
                        "dropping stale-generation dynamic registration "
                        "from task id %s (gen %s, expected %s)", task_id,
                        msg.get("gen"), expect_gen)
                    return
            wire.send_msg(conn, self._dynamic_config(task), self.token)
            ack = wire.recv_msg(conn, self.token)
            if ack != "ok":
                self.log.warning("dynamic task %s failed to ack: %r",
                                 task, ack)
                return
            with self._lock:
                task.addr = msg.get("addr")
                task.initialized = True
            self.log.info("dynamic task registered: %s", task)
        except (OSError, wire.WireError) as e:
            self.log.warning("dynamic registration failed: %s", e)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- bring-up ----------------------------------------------------------

    def start(self) -> None:
        """Bind rendezvous socket → start backend → event loop until every
        task registers → broadcast cluster config (reference start(),
        scheduler.py:320-369)."""
        self._listen = wire.bind_ephemeral()
        self.addr = wire.sock_addr(self._listen,
                                   advertise_host=os.environ.get("TPUMESOS_ADVERTISE_HOST"))
        self.log.info("rendezvous listening on %s", self.addr)
        if self.token_transport == "file":
            # Must exist before the first launch: tasks read it at startup.
            fd, path = tempfile.mkstemp(prefix="tpumesos-token-")
            with os.fdopen(fd, "w") as f:  # mkstemp creates mode 0600
                f.write(self.token)
            self._token_file = path
        self.backend.start(self)
        if self.restart_policy == "elastic":
            self._elastic_thread = threading.Thread(
                target=self._elastic_loop, name="elastic-recovery",
                daemon=True)
            self._elastic_thread.start()
        try:
            self._form_gang()
        except Exception:
            self.stop()
            raise
        if self.dynamic:
            # From here on registrations are served continuously: tasks
            # added by add_task() dial the same rendezvous address and
            # get their config per-connection, no gang barrier.
            t = threading.Thread(target=self._dynamic_accept_loop,
                                 name="dynamic-rendezvous", daemon=True)
            t.start()
            self._dynamic_thread = t

    def _form_gang(self) -> None:
        """Run the rendezvous loop until every task registered, then
        broadcast the cluster config: one gang formation, shared by the
        first bring-up and every elastic re-formation."""
        sel = selectors.DefaultSelector()
        sel.register(self._listen, selectors.EVENT_READ, ("accept", None, None))
        deadline = time.monotonic() + self.start_timeout
        try:
            while True:
                with self._lock:
                    if self._fatal:
                        raise ClusterError(self._fatal)
                    if self._stopped:
                        raise ClusterError("scheduler stopped during bring-up")
                    if all(t.initialized for t in self.tasks):
                        break
                if time.monotonic() > deadline:
                    raise ClusterError(
                        f"cluster bring-up timed out after {self.start_timeout}s; "
                        f"uninitialized: "
                        f"{[t for t in self.tasks if not t.initialized]}")
                for key, _ in sel.select(timeout=0.5):
                    kind, conn, framer = key.data
                    if kind == "accept":
                        conn, _ = self._listen.accept()
                        conn.setblocking(False)
                        sel.register(conn, selectors.EVENT_READ,
                                     ("conn", conn, wire.Framer(self.token)))
                        continue
                    try:
                        data = conn.recv(65536)
                    except (BlockingIOError, InterruptedError):
                        continue
                    except OSError:
                        data = b""
                    if not data:
                        sel.unregister(conn)
                        if not self._connection_owned(conn):
                            conn.close()
                        continue
                    try:
                        msgs = framer.feed(data)
                    except wire.WireError as e:
                        self.log.warning("rejecting connection: %s", e)
                        sel.unregister(conn)
                        conn.close()
                        continue
                    for msg in msgs:
                        if self._handle_register(conn, msg):
                            sel.unregister(conn)
            self._start_cluster()
        finally:
            sel.close()

    def _connection_owned(self, conn: socket.socket) -> bool:
        return any(t.connection is conn for t in self.tasks)

    def _handle_register(self, conn: socket.socket, msg: Any) -> bool:
        """One task dialing back (reference: scheduler.py:341-361; task side
        server.py:25-27).  Returns True when the connection is claimed by a
        task and must leave the selector."""
        if not (isinstance(msg, dict) and msg.get("op") == "register"):
            self.log.warning("unexpected rendezvous message: %r", msg)
            return False
        gen = msg.get("gen")
        if gen is not None:
            # Generation fence: a zombie of a torn-down gang re-dialing
            # the rendezvous must never be adopted into the current one.
            try:
                gen = int(gen)
            except (TypeError, ValueError):
                gen = -1
            if gen != self.generation:
                self.log.warning(
                    "dropping stale-generation registration from task id %s "
                    "(gen %s, current %d)", msg.get("task_id"), msg.get("gen"),
                    self.generation)
                conn.close()
                return True
        task = self._find_task(msg.get("task_id", ""))
        if task is None:
            self.log.warning("registration from unknown/stale task id %s",
                             msg.get("task_id"))
            conn.close()
            return True
        with self._lock:
            task.addr = msg["addr"]
            task.coord_port = int(msg.get("coord_port") or 0)
            task.connection = conn
            task.initialized = True
        self.log.info("task registered: %s", task)
        return True

    def _start_cluster(self) -> None:
        """Broadcast per-task config and await acks (reference
        _start_tf_cluster, scheduler.py:288-318).

        The revive window closes here: once every task has registered and the
        broadcast begins, peers may already be acting on their config, so a
        task death during the broadcast is fatal (matching the reference,
        where a socket error in _start_tf_cluster aborts bring-up).
        """
        with self._lock:
            if not self.tasks:
                # Dynamic mode may start with an EMPTY table: there is no
                # gang to broadcast to; tasks added later get their
                # config per-registration from the dynamic rendezvous.
                self.started = True
                self.log.info("cluster started empty (dynamic): tasks "
                              "join at runtime via add_task()")
                return
            self._broadcasting = True
            # Snapshot connections under the lock: the revive path can close
            # and null task.connection from the status-watcher thread.
            conns = [(task, task.connection) for task in self.tasks]
            if any(conn is None for _, conn in conns):
                raise ClusterError("task lost between registration and broadcast")
            cluster_def = self.cluster_def
            generation = self.generation

        world_size = len(self.tasks)
        rank0 = self.tasks[0]
        coordinator = f"{rank0.addr.rsplit(':', 1)[0]}:{rank0.coord_port}"

        for rank, (task, conn) in enumerate(conns):
            conn.setblocking(True)
            conn.settimeout(self.start_timeout)
            config = {
                "job_name": task.job_name,
                "task_index": task.task_index,
                "rank": rank,
                "world_size": world_size,
                "cpus": task.cpus,
                "mem": task.mem,
                "chips": task.chips,
                "cmd": task.cmd,
                "cwd": os.getcwd(),
                "cluster_def": cluster_def,
                "generation": generation,
                "coordinator": coordinator,
                "forward_addresses": self.forward_addresses,
                "extra_config": self.extra_config,
                "protocol": self.protocol,
                "mesh_axes": self.mesh_axes or self._default_mesh_axes(),
                "env": self.env,
            }
            try:
                wire.send_msg(conn, config, self.token)
            except OSError as e:
                raise ClusterError(f"task {task} died during config broadcast: {e}")
        for task, conn in conns:
            try:
                ack = wire.recv_msg(conn, self.token)
            except (OSError, wire.WireError) as e:
                raise ClusterError(f"task {task} died before acking: {e}")
            if ack != "ok":
                raise ClusterError(f"task {task} failed to ack: {ack!r}")
            self.log.info("task %s ready", task)
            if task.cmd is not None:
                # Mode B: the control connection's job is done.
                conn.close()
                task.connection = None
            else:
                # Mode A keeps it as the dispatch channel, with no
                # timeout: a dispatched function may run for hours, and
                # a killed peer still surfaces at once as EOF.
                conn.settimeout(None)
        with self._lock:
            if not all(t.initialized for t in self.tasks):
                # A terminal status raced the tail of the broadcast and
                # reset a task (the pre-start revive path): better a loud
                # formation failure (retried by elastic recovery, fatal
                # on the first bring-up) than a cluster with a hole in it.
                raise ClusterError("task lost during config broadcast")
            self.started = True
            # With started=True, atomically: a recovery is over the
            # moment the gang is live, so a death of the new gang is
            # never swallowed by a stale _recovering flag.
            self._recovering = False
            self._recover_reason = None
        self.log.info("cluster started: %d task(s), generation %d, "
                      "coordinator %s", world_size, generation, coordinator)

    def _default_mesh_axes(self) -> Dict[str, int]:
        """North-star mapping (BASELINE.json / SURVEY §2.7): ps jobs in the
        spec mean "shard the parameters", so the whole device set becomes an
        ``fsdp`` axis; workers-only means plain data parallelism.  -1 lets
        the runtime absorb however many devices actually exist."""
        has_ps = any(job.name == "ps" for job in self.task_spec)
        return {"fsdp": -1} if has_ps else {"dp": -1}

    # -- user-facing surface ----------------------------------------------

    @property
    def targets(self) -> Dict[str, str]:
        """Session-target map, kept for API parity with the reference
        (scheduler.py:279-286); the scheme reflects the data plane."""
        return {
            f"/job:{t.job_name}/task:{t.task_index}": f"{self.protocol}://{t.addr}"
            for t in self.tasks
        }

    @property
    def cluster_def(self) -> Dict[str, List[str]]:
        return {
            job.name: [t.addr for t in sorted(
                (t for t in self.tasks if t.job_name == job.name),
                key=lambda t: t.task_index)]
            for job in self.task_spec
        }

    def run(self, func: Any, *args: Any, **kwargs: Any) -> Any:
        """SPMD dispatch: run ``func`` on every Mode-A task and return the
        result of the lowest-ranked one (rank 0 whenever rank 0 is a
        Mode-A task).

        ``func`` is a callable, resolved on the task by module and
        qualname (it must be importable there: the launch forwards
        ``sys.path``; a function of the calling program's ``__main__`` file is
        imported from that file), or an explicit ``"module:qualname"``
        string.  Each task calls ``func(ctx, *args, **kwargs)`` with its
        :class:`~tfmesos_tpu_torch.runtime.TaskContext`.  Arguments and
        results travel as JSON (a result that is not JSON comes back as
        its ``repr``).  A function that raised on a task raises
        :class:`RemoteError`; a task lost during the call raises
        :class:`ClusterError`."""
        results = self.run_all(func, *args, **kwargs)
        return results[0]

    def run_on(self, ranks, func: Any, *args: Any, **kwargs: Any) -> List[Any]:
        """Targeted dispatch to a subset of tasks by global rank, results
        in the order of ``ranks``.  For per-process work only: a function
        that enters a collective must run on every rank or the group
        hangs (use :meth:`run` / :meth:`run_all`).  An unknown,
        non-dispatchable or repeated rank is an error, raised before any
        send."""
        return self._dispatch(func, args, kwargs, ranks=list(ranks))

    def run_all(self, func: Any, *args: Any, **kwargs: Any) -> List[Any]:
        """SPMD dispatch to every Mode-A task; the results in rank
        order."""
        return self._dispatch(func, args, kwargs, ranks=None)

    def _dispatch(self, func, args, kwargs, ranks) -> List[Any]:
        with self._lock:
            if self._fatal:
                raise ClusterError(self._fatal)
            if self._recovering:
                raise ClusterError(
                    f"cluster re-forming (generation {self.generation}): "
                    f"{self._recover_reason}")
            if not self.started:
                raise ClusterError("cluster not started")
            self._call_id += 1
            call_id = self._call_id
            generation = self.generation
            # The task list and its connections are read in the same
            # locked section as the generation: read after it, a
            # recovery finishing in between would hand this call the
            # new gang's tasks, which drop a dispatch of the old
            # generation without a reply.
            dispatchable = {rank: (t, t.connection)
                            for rank, t in enumerate(self.tasks)
                            if t.cmd is None and t.connection is not None}
        if self.chaos is not None:
            # Fault-injection trigger point: "kill task i at dispatch N"
            # is the deterministic stand-in for a mid-training preemption.
            self.chaos.event("scheduler.dispatch", key=str(call_id))
        spec = _func_spec(func)
        if ranks is None:
            targets = list(dispatchable.values())
        else:
            bad = [r for r in ranks if r not in dispatchable]
            if bad:
                raise ClusterError(
                    f"rank(s) {bad} are not connected in-graph tasks "
                    f"(dispatchable: {sorted(dispatchable)})")
            if len(set(ranks)) != len(ranks):
                raise ClusterError(
                    f"duplicate rank(s) in {ranks}: each dispatch targets a "
                    "rank at most once (call run_on again to repeat)")
            targets = [dispatchable[r] for r in ranks]  # request order
        mode_a = [t for t, _ in targets]
        if not mode_a:
            raise ClusterError("no in-graph (cmd=None) tasks to dispatch to")
        msg = {"op": "run", "call_id": call_id, "gen": generation,
               "func": spec, "args": list(args), "kwargs": kwargs}

        def _fatal_dispatch(why: str) -> ClusterError:
            # A dead peer or a desynchronized channel poisons the whole
            # dispatch path: survivors may hold frames of this call with
            # no way to resync, and half a collective hangs the group.
            # Fail-fast marks the cluster fatal; elastic turns the same
            # signal into a re-formation (this call still raises: the
            # caller resumes after wait_ready()).  A failure seen on a
            # gang a recovery already replaced charges nothing.
            with self._lock:
                if self.generation == generation:
                    self._post_start_failure(why)
            return ClusterError(why)

        task = None
        try:
            for task, conn in targets:
                wire.send_msg(conn, msg, self.token)
            replies = self._drain_replies(targets, call_id, generation,
                                          _fatal_dispatch)
        except (OSError, wire.WireError) as e:
            raise _fatal_dispatch(
                f"task {task} lost during dispatch: {e}") from e
        results = []
        errors = []
        for task, reply in zip(mode_a, replies):
            if not reply.get("ok"):
                errors.append(f"on {task}:\n{reply.get('error')}")
            results.append(reply.get("value"))
        if errors:
            raise RemoteError("remote failure " + "\n".join(errors))
        return results

    def _drain_replies(self, targets, call_id, generation, _fatal_dispatch):
        """Collect one reply a task from its (task, connection) pair,
        reading every connection at once.

        A blocking read rank by rank would sit on a survivor (which may
        run for hours) while a dead peer's EOF goes unseen; a selector
        surfaces any death — the socket's EOF, or the status thread
        marking the cluster fatal, recovering, or on another generation
        than the dispatch's — within a poll.  A reply of another
        generation (a zombie of an earlier gang flushing its last
        result) is logged and dropped, never matched to a current
        call.  The replies come back in the order of ``targets``."""
        replies: Dict[int, dict] = {}
        sel = selectors.DefaultSelector()
        framers = [wire.Framer(self.token) for _ in targets]
        try:
            for i, (task, conn) in enumerate(targets):
                try:
                    conn.setblocking(False)
                    sel.register(conn, selectors.EVENT_READ, i)
                except OSError as e:
                    raise _fatal_dispatch(
                        f"task {task} lost during dispatch: {e}") from e
            while len(replies) < len(targets):
                events = sel.select(timeout=0.5)
                with self._lock:
                    if self._fatal:
                        raise ClusterError(self._fatal)
                    if self._recovering:
                        raise ClusterError(
                            f"cluster re-forming (generation "
                            f"{self.generation}): {self._recover_reason}")
                    if self.generation != generation:
                        # A whole recovery ran while this call waited:
                        # no task of the old gang will ever answer.
                        raise ClusterError(
                            f"cluster re-forming (generation "
                            f"{self.generation}, the call's "
                            f"{generation})")
                for key, _ in events:
                    i = key.data
                    task = targets[i][0]
                    try:
                        data = key.fileobj.recv(1 << 16)
                    except (BlockingIOError, InterruptedError):
                        continue
                    except OSError as e:
                        raise _fatal_dispatch(
                            f"task {task} lost during dispatch: {e}") from e
                    if not data:
                        raise _fatal_dispatch(
                            f"task {task} died during dispatch (EOF)")
                    try:
                        msgs = framers[i].feed(data)
                    except wire.WireError as e:
                        raise _fatal_dispatch(
                            f"bad frame from {task} during dispatch: {e}"
                        ) from e
                    for reply in msgs:
                        if (isinstance(reply, dict) and "gen" in reply
                                and reply["gen"] != generation):
                            self.log.warning(
                                "dropping stale-generation reply from %s: "
                                "gen %r (current %d)", task,
                                reply.get("gen"), generation)
                            continue
                        if (i in replies
                                or not (isinstance(reply, dict)
                                        and reply.get("call_id") == call_id)):
                            raise _fatal_dispatch(
                                f"bad reply from {task}: {reply!r}")
                        replies[i] = reply
                    if i in replies:
                        sel.unregister(key.fileobj)
        finally:
            sel.close()
            for _, conn in targets:
                try:
                    conn.setblocking(True)
                    conn.settimeout(None)
                except OSError:
                    pass
        return [replies[i] for i in range(len(targets))]

    def finished(self) -> bool:
        """True when any job has fully TASK_FINISHED (reference semantics —
        all workers done ends the run even though ps tasks never exit,
        scheduler.py:474-477); never while a recovery is in flight (the
        next generation re-runs and re-counts)."""
        with self._lock:
            if self._fatal:
                raise ClusterError(self._fatal)
            if self._recovering:
                return False
            return any(
                self.job_finished.get(job.name, 0) >= (job.num - job.start)
                for job in self.task_spec
            )

    def join(self, poll: float = 0.1) -> None:
        """Block until ``finished()`` (tfrun's poll loop, tfrun:101-102)."""
        while not self.finished():
            time.sleep(poll)

    def stop(self) -> None:
        """Teardown (reference stop(), scheduler.py:459-472)."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            self._recover_event.set()   # unpark the elastic thread
        if (self._elastic_thread is not None
                and self._elastic_thread is not threading.current_thread()):
            self._elastic_thread.join(timeout=5.0)
        if self._dynamic_thread is not None and self._listen is not None:
            # close() alone does not interrupt a blocked accept():
            # poke the rendezvous awake so the dynamic accept loop
            # exits NOW instead of burning its whole join timeout.
            wire.wake_listener(self._listen)
            try:
                self._listen.close()
            except OSError:
                pass
            self._dynamic_thread.join(timeout=5.0)
        for task in self.tasks:
            if task.connection is not None:
                try:
                    wire.send_msg(task.connection, {"op": "shutdown"}, self.token)
                except OSError:
                    pass
                try:
                    task.connection.close()
                except OSError:
                    pass
                task.connection = None
        self.backend.stop()
        if self._listen is not None:
            self._listen.close()
            self._listen = None
        if self._token_file is not None:
            try:
                os.unlink(self._token_file)
            except OSError:
                pass
            self._token_file = None
        self.log.info("scheduler stopped")


def _func_spec(func: Any) -> dict:
    """How a dispatch names ``func``: ``{"module", "qualname", "path"}``,
    ``path`` the calling program's ``__main__`` file for a function defined
    there (the task imports that file)."""
    if isinstance(func, str):
        module, _, qualname = func.partition(":")
        if not qualname:
            raise ValueError(f"func string must be 'module:qualname', "
                             f"got {func!r}")
        return {"module": module, "qualname": qualname, "path": None}
    module = getattr(func, "__module__", None)
    qualname = getattr(func, "__qualname__", None)
    if not module or not qualname or "<locals>" in qualname:
        raise ValueError(
            f"{func!r} is not addressable as module:qualname; define it at "
            f"module top level (lambdas/closures cannot be shipped)")
    path = None
    if module == "__main__":
        main_mod = sys.modules.get("__main__")
        path = getattr(main_mod, "__file__", None)
        if path is None:
            raise ValueError("cannot ship a __main__ function from an "
                             "interactive session; use 'module:qualname'")
        path = os.path.abspath(path)
    return {"module": module, "qualname": qualname, "path": path}
