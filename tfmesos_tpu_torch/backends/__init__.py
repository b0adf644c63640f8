"""Resource backends (port of ``tfmesos_tpu/backends/__init__.py``).

``TPUMesosScheduler`` owns the cluster logic and talks to a narrow
``ResourceBackend`` interface, with two implementations:
``LocalBackend`` (subprocess fan-out on this host, no Mesos needed) and
``MesosBackend`` (the Mesos v1 HTTP scheduler API on the stdlib, with
``zk://`` masters resolved through ``backends/zk.py``).
"""

from __future__ import annotations

import abc
from typing import List, Sequence

from tfmesos_tpu_torch.spec import Offer

FOREVER = 0xFFFFFFFF  # reference: scheduler.py:17


class ResourceBackend(abc.ABC):
    """Delivers offers/status to the scheduler and executes its decisions.

    A backend pushes events by calling the scheduler's callback surface
    (``on_registered`` / ``on_offers`` / ``on_status`` / ``on_agent_lost`` /
    ``on_error``) from its own thread; the scheduler serializes state behind
    its own lock.
    """

    #: True when launched tasks share the scheduler's filesystem (so secrets
    #: can travel as mode-0600 files instead of state-visible env vars).
    colocated = False

    @abc.abstractmethod
    def start(self, scheduler) -> None:
        """Connect and begin delivering events."""

    @abc.abstractmethod
    def stop(self) -> None:
        """Tear down; kill anything still running that we launched."""

    @abc.abstractmethod
    def launch(self, offer: Offer, task_infos: Sequence[dict]) -> None:
        """Launch tasks against an offer (reference: driver.launchTasks,
        scheduler.py:277)."""

    @abc.abstractmethod
    def decline(self, offer: Offer, refuse_seconds: float = 5.0) -> None:
        """Return an offer unused (reference: scheduler.py:230-232)."""

    @abc.abstractmethod
    def suppress(self) -> None:
        """Stop receiving offers once fully placed (reference: scheduler.py:229)."""

    @abc.abstractmethod
    def revive(self) -> None:
        """Resume receiving offers after a task revive (reference:
        scheduler.py:430)."""

    @abc.abstractmethod
    def kill(self, task_id: str) -> None:
        """Kill one task by id."""

    def acknowledge(self, status) -> None:  # only meaningful for Mesos
        pass


def first_fit(tasks, offer: Offer) -> List:
    """First-fit packing of unoffered tasks into one offer — the reference's
    allocation strategy (scheduler.py:252-275).  Mutates ``offer``'s free
    resources and returns the tasks placed."""
    placed = []
    for task in tasks:
        if task.offered:
            continue
        if task.fits(offer):
            task.take_from(offer)
            task.offered = True
            task.offer_id = offer.id
            task.agent_id = offer.agent_id
            task.hostname = offer.hostname
            placed.append(task)
    return placed
