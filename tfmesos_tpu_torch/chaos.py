"""Deterministic fault injection for the control plane (port of
``tfmesos_tpu/chaos.py``).

The elastic recovery (scheduler ``restart_policy="elastic"``), the
checkpoint-coordinated resume (``train/supervisor.py``) and the fleet's
liveness grading (``fleet/registry.py``) all make promises that cannot be
trusted without a way to *cause* the failures on demand, repeatably.
This module is that way: a seeded :class:`FaultPlan` — an explicit list
of :class:`Fault` specs — consulted from small hooks threaded through
the control plane:

* ``scheduler._dispatch``      counts SPMD dispatches (site
  ``"scheduler.dispatch"``);
* ``backends/local.py``        registers every launched task's pid with the
  plan (so ``kill_task`` faults can SIGKILL by ``job:index`` name), counts
  launches (site ``"backend.launch"``), and executes ``drop_agent``;
* ``wire.py``                  consults installed hooks on every framed
  send/recv (sites ``"wire.send"`` / ``"wire.recv"``) so a plan can sever,
  delay, truncate, or drop frames on a live connection;
* ``fleet/registry.py``        consults the plan per heartbeat (site
  ``"registry.heartbeat"``) so beats can be dropped without touching the
  replica.

Everything a plan does is decided by **counters** (the Nth event at a
site, optionally filtered by a target substring) or **fixed timers**, plus
a seeded ``random.Random`` for any jittered choices — the same plan against
the same workload injects the same faults, which is what lets
``tests/test_torch_chaos.py`` assert exact recovery behavior (same final loss as
an uninterrupted run) instead of "it probably survived".
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from tfmesos_tpu_torch.utils.logging import get_logger

__all__ = ["Fault", "FaultPlan"]

log = get_logger("tfmesos_tpu_torch.chaos")

#: Actions a fault can take when its trigger fires.  ``kill_task`` /
#: ``drop_agent`` execute from ANY site (the trigger is just a counter);
#: ``sever`` / ``delay`` / ``truncate`` / ``drop`` are interpreted by the
#: hook site that observed the event (wire or registry).  ``slow_task``
#: is the GRAY-FAILURE generator: from its ``nth`` matching event ON it
#: stays live forever (``count`` is ignored — a slow task stays slow)
#: and injects a ``delay_s`` sleep into every matching event, e.g. every
#: ``wire.send`` toward one replica's addr — the process is alive, its
#: heartbeats are on time, and every dispatch is deterministically slow;
#: exactly the failure a circuit breaker (not a liveness registry) must
#: catch.  ``partition`` is the FABRIC-SPLIT generator: persistent like
#: ``slow_task``, it silently drops every frame between one specific
#: peer PAIR (``target="addrA|addrB"`` — both advertised ``host:port``
#: endpoints, either order) while leaving all other traffic — registry
#: heartbeats included — untouched, so both peers stay registry-alive
#: through the split.  It matches only sockets the sender TAGGED with
#: its own advertised addr (``wire.tag_socket`` — replica-to-replica
#: fabric RPC and direct KV pushes do), because an untagged socket
#: cannot prove which pair it belongs to.
ACTIONS = ("kill_task", "drop_agent", "sever", "delay", "truncate",
           "drop", "slow_task", "partition")


@dataclass
class Fault:
    """One planned fault.

    ``site``   — the counter that triggers it ("scheduler.dispatch",
    "backend.launch", "wire.send", "wire.recv", "registry.heartbeat", or
    "time" for a fixed-delay timer armed at install).
    ``nth``    — fires on the nth matching event (1-based); with
    ``count`` > 1 it stays live for that many consecutive matching events
    (e.g. drop 5 heartbeats in a row).  ``slow_task`` ignores ``count``:
    once armed at its nth event it delays EVERY later matching event
    (``fired`` records only the arming, so a long soak cannot bloat it).
    Each fault keeps its OWN counter
    of matching events, cumulative across every key its target matches.
    ``target`` — optional substring filter against the event's key (a task
    name ``job:index`` for launches, ``host:port`` peers for wire events,
    the replica addr for heartbeats); when set, only matching events
    advance the fault's counter.  A ``partition`` fault's target is the
    peer PAIR ``"addrA|addrB"`` (advertised endpoints, either order):
    only frames between those two tagged endpoints match.
    ``victim`` — for ``kill_task``: the ``job:index`` task to SIGKILL
    (defaults to ``target``).
    ``delay_s`` — sleep length for ``delay`` actions and the timer delay
    for ``site="time"``; ``None`` draws once from the plan's seeded RNG.
    """

    action: str
    site: str
    nth: int = 1
    count: int = 1
    target: Optional[str] = None
    victim: Optional[str] = None
    delay_s: Optional[float] = 0.05

    def __post_init__(self) -> None:
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}; "
                             f"want one of {ACTIONS}")
        if self.nth < 1 or self.count < 1:
            raise ValueError("nth and count are 1-based positives")


class FaultPlan:
    """A seeded, deterministic schedule of faults plus the wiring to
    execute them.  Thread-safe: hooks fire from backend/offer/dispatch
    threads concurrently.

    Pass the plan to the components under test
    (``LocalBackend(chaos=plan)``, ``TPUMesosScheduler(chaos=plan)``,
    ``ReplicaRegistry(chaos=plan)``) and ``install()`` it to arm the
    global wire hooks and any ``site="time"`` timers::

        plan = FaultPlan([Fault("kill_task", "scheduler.dispatch",
                                nth=4, victim="worker:1")], seed=7)
        with plan.installed():
            ...   # run the workload; the 4th dispatch SIGKILLs worker:1

    ``plan.fired`` records every executed fault as ``(site, key, action,
    n)`` tuples, so tests assert exactly what was injected.
    """

    def __init__(self, faults: List[Fault], seed: int = 0):
        self.faults = list(faults)
        self.rng = random.Random(seed)
        self.fired: List[Tuple[str, str, str, int]] = []
        self._lock = threading.RLock()
        self._counts: Dict[Any, int] = {}      # per-site event counters
        self._fault_hits: Dict[int, int] = {}  # per-fault MATCHED counters
        self._pids: Dict[str, int] = {}        # "job:index" -> pid
        self._backend = None                   # bound LocalBackend (or alike)
        self._timers: List[threading.Timer] = []
        self._installed = False
        # Resolve RNG-drawn delays ONCE, in declaration order, so the
        # draw sequence depends only on the seed and the plan.
        for f in self.faults:
            if f.delay_s is None:
                f.delay_s = self.rng.uniform(0.01, 0.1)

    # -- wiring ------------------------------------------------------------

    def bind_backend(self, backend) -> None:
        """Called by a chaos-aware backend at start: gives ``drop_agent``
        faults something to execute against."""
        with self._lock:
            self._backend = backend

    def observe_launch(self, name: str, task_id: str, pid: int) -> None:
        """Called by the backend per successful launch: registers the pid
        under its ``job:index`` name (latest launch wins — revives and
        elastic re-forms re-register) and counts the launch event."""
        with self._lock:
            self._pids[name] = pid
        self.event("backend.launch", key=name)

    def pid(self, name: str) -> Optional[int]:
        with self._lock:
            return self._pids.get(name)

    def install(self) -> "FaultPlan":
        """Arm the process-global wire hooks and any ``time`` faults."""
        from tfmesos_tpu_torch import wire
        with self._lock:
            if self._installed:
                return self
            self._installed = True
            wire.set_chaos(self.on_wire_send, self.on_wire_recv)
            for f in self.faults:
                if f.site != "time":
                    continue
                t = threading.Timer(f.delay_s or 0.0, self._fire_timed, (f,))
                t.daemon = True
                t.start()
                self._timers.append(t)
        return self

    def uninstall(self) -> None:
        from tfmesos_tpu_torch import wire
        with self._lock:
            if not self._installed:
                return
            self._installed = False
            timers, self._timers = self._timers, []
        wire.set_chaos(None, None)
        for t in timers:
            t.cancel()

    def installed(self):
        """Context manager form of install()/uninstall()."""
        import contextlib

        @contextlib.contextmanager
        def _cm():
            self.install()
            try:
                yield self
            finally:
                self.uninstall()
        return _cm()

    # -- trigger machinery -------------------------------------------------

    def event(self, site: str, key: str = "", **ctx) -> List[Fault]:
        """Count one event at ``site`` and execute/return the faults it
        triggers.  ``kill_task`` and ``drop_agent`` execute here (they are
        site-independent actions); connection-local actions (sever /
        delay / truncate / drop) are returned for the observing hook to
        interpret — ``delay`` is also slept here so every site honors it.
        """
        due: List[Fault] = []
        with self._lock:
            self._counts[site] = self._counts.get(site, 0) + 1
            if key:
                ck = (site, key)
                self._counts[ck] = self._counts.get(ck, 0) + 1
            for i, f in enumerate(self.faults):
                if f.site != site:
                    continue
                if f.action == "partition":
                    # Pair semantics: BOTH endpoints of the fault's
                    # ``target`` ("A|B") must appear in the event key
                    # (the tagged sender + the dialed peer), so only
                    # traffic between that specific pair matches.
                    if not _pair_match(f.target, key):
                        continue
                elif f.target and (not key or f.target not in key):
                    continue
                # Per-fault matched-event counter — cumulative across all
                # keys the target matches, so "the 2nd worker launch"
                # means the 2nd launch of ANY worker, not per-task (and
                # fires exactly once, not once per matching key).
                n = self._fault_hits[i] = self._fault_hits.get(i, 0) + 1
                if f.action in ("slow_task", "partition"):
                    # Persistent failures: armed at the nth event,
                    # live forever after.
                    if n >= f.nth:
                        due.append(f)
                        if n == f.nth:
                            self.fired.append((site, key, f.action, n))
                elif f.nth <= n < f.nth + f.count:
                    due.append(f)
                    self.fired.append((site, key, f.action, n))
        for f in due:
            self._execute(f, site=site, key=key)
        return due

    def _fire_timed(self, f: Fault) -> None:
        with self._lock:
            self.fired.append(("time", f.target or "", f.action, 1))
        self._execute(f, site="time", key=f.target or "")

    def _execute(self, f: Fault, site: str, key: str) -> None:
        # Attribution: every firing lands on the ACTIVE request trace
        # (thread-local — the router activates one around its routing
        # loop) plus the chaos flight recorder, so a soak anomaly maps
        # to the exact injected fault instead of "something was slow".
        # Lazy import: chaos must stay importable without the fleet
        # package.
        try:
            from tfmesos_tpu_torch.fleet import tracing as _tracing
            attrs = {"site": site, "key": key, "action": f.action}
            if f.action in ("delay", "slow_task"):
                attrs["delay_s"] = f.delay_s
            if _tracing.current() is not None:
                # cur_event copies into the chaos flight recorder too.
                _tracing.cur_event("chaos", "fault", **attrs)
            else:
                _tracing.flight("chaos").record(
                    dict(attrs, name="fault"))
        except Exception:       # tracing must never break injection
            pass
        if f.action == "kill_task":
            self.kill(f.victim or f.target or key)
        elif f.action == "drop_agent":
            backend = self._backend
            if backend is None:
                log.warning("chaos: drop_agent fault with no bound backend")
                return
            log.warning("chaos: dropping agent (site %s)", site)
            backend.chaos_drop_agent()
        elif f.action in ("delay", "slow_task"):
            # slow_task: the same seeded, deterministic sleep as delay,
            # just applied to every matching event once armed.
            time.sleep(f.delay_s or 0.0)
        # sever/truncate/drop are interpreted by the observing hook.

    def kill(self, name: str) -> bool:
        """SIGKILL the registered task ``job:index`` — the
        preemption/oom stand-in.  Kills the whole PROCESS GROUP when
        the pid leads one (LocalBackend launches tasks with
        start_new_session, and a Mode-B shell=True command's python
        lives UNDER the registered sh pid — killing only the wrapper
        would orphan the real task alive, a death that never
        happened), falling back to the single pid otherwise.  Returns
        False when the task was never observed (or already reaped)."""
        pid = self.pid(name)
        if pid is None:
            log.warning("chaos: kill_task %r: no registered pid", name)
            return False
        log.warning("chaos: SIGKILL task %s (pid %d)", name, pid)
        try:
            os.killpg(pid, signal.SIGKILL)
            return True
        except (ProcessLookupError, PermissionError):
            pass
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            return False
        return True

    # -- hook-site adapters ------------------------------------------------

    def on_wire_send(self, sock, data: bytes) -> bool:
        """wire.send_msg hook: returns True when the frame was consumed
        (dropped — ``drop`` and armed ``partition`` faults); raises
        OSError for sever/truncate."""
        for f in self.event("wire.send", key=_pair_key(sock)):
            if f.action == "sever":
                _close(sock)
                raise OSError("chaos: connection severed (wire.send)")
            if f.action == "truncate":
                try:
                    sock.sendall(data[:max(1, len(data) // 2)])
                finally:
                    _close(sock)
                raise OSError("chaos: frame truncated (wire.send)")
            if f.action in ("drop", "partition"):
                return True
        return False

    def on_wire_recv(self, sock) -> None:
        """wire.recv_msg hook: raises OSError for sever."""
        for f in self.event("wire.recv", key=_pair_key(sock)):
            if f.action == "sever":
                _close(sock)
                raise OSError("chaos: connection severed (wire.recv)")

    def on_heartbeat(self, addr: str) -> bool:
        """Registry hook: True — this heartbeat never arrived.  Counts
        beat-bearing messages only ("hello" is the first beat; "drain"
        is operator intent and never reaches this hook)."""
        return any(f.action == "drop"
                   for f in self.event("registry.heartbeat", key=addr))


def _peer(sock) -> str:
    try:
        name = sock.getpeername()
    except OSError:
        return ""
    if isinstance(name, tuple) and len(name) >= 2:
        return f"{name[0]}:{name[1]}"
    return str(name)       # AF_UNIX sockets name a path (or nothing)


def _pair_key(sock) -> str:
    """The wire event key: ``"<tagged local ident>|<dialed peer>"`` for
    sockets a named endpoint tagged (wire.tag_socket — the fabric's
    replica-to-replica links), the dialed peer alone otherwise.  The
    peer stays a SUBSTRING of the composite key, so plain
    ``target="host:port"`` faults keep matching tagged traffic too."""
    from tfmesos_tpu_torch import wire
    peer = _peer(sock)
    ident = wire.sock_ident(sock)
    return f"{ident}|{peer}" if ident else peer


def _pair_match(target: Optional[str], key: str) -> bool:
    """Whether a ``partition`` fault's ``"A|B"`` pair both appear in
    the event key (either order; each endpoint a substring, matching
    the rest of chaos's target semantics)."""
    if not target or not key:
        return False
    parts = [p for p in target.split("|") if p]
    return len(parts) == 2 and all(p in key for p in parts)


def _close(sock) -> None:
    try:
        sock.close()
    except OSError:
        pass
