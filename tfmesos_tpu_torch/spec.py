"""Cluster model: Job groups, Task records, resource Offers (port of
``tfmesos_tpu/spec.py``: the launched node runtime is
``tfmesos_tpu_torch.server``).

Mirrors the capability surface of the reference's ``Job`` (scheduler.py:21-31)
and ``Task`` (scheduler.py:34-177) but re-targeted at TPU pod slices: the GPU
resource dimension (``gpus``) becomes ``chips`` (TPU chips per task), and
``to_task_info`` renders the Mesos **v1 HTTP API JSON** shape rather than the
protobuf-shaped addict.Dict the reference builds, because our Mesos backend
speaks the v1 HTTP API directly (no pymesos).
"""

from __future__ import annotations

import base64
import os
import sys
import uuid
from dataclasses import InitVar, dataclass, field
from typing import Any, Dict, List, Optional

from tfmesos_tpu_torch.wire import (TOKEN_ENV as _TOKEN_ENV,
                                    TOKEN_FILE_ENV as _TOKEN_FILE_ENV)


@dataclass
class Job:
    """A homogeneous group of tasks (reference: scheduler.py:21-31).

    ``start`` supports launching a partial index range, exactly as the
    reference allows (scheduler.py:29-31).  ``gpus=`` is accepted as a
    drop-in alias for ``chips`` so reference job specs work unchanged.
    """

    name: str
    num: int
    cpus: float = 1.0
    mem: float = 1024.0
    chips: int = 0
    cmd: Optional[str] = None
    start: int = 0
    gpus: InitVar[Optional[int]] = None

    def __post_init__(self, gpus: Optional[int] = None) -> None:
        if gpus is not None:
            if self.chips:
                raise ValueError(f"job {self.name!r}: pass chips or gpus, not both")
            self.chips = gpus
        if self.num <= 0:
            raise ValueError(f"job {self.name!r}: num must be positive, got {self.num}")
        if not 0 <= self.start < self.num:
            raise ValueError(f"job {self.name!r}: start must be in [0, num), "
                             f"got start={self.start} num={self.num}")


def normalize_jobs(jobs: Any) -> List[Job]:
    """Accept a Job, a dict of Job kwargs, or a list of either — the exact
    normalization contract of the reference API (tfmesos/__init__.py:9-16)."""
    if isinstance(jobs, (Job, dict)):
        jobs = [jobs]
    out = []
    for j in jobs:
        if isinstance(j, dict):
            j = Job(**j)
        if not isinstance(j, Job):
            raise TypeError(f"cannot interpret {j!r} as a Job")
        out.append(j)
    return out


@dataclass
class Offer:
    """A resource offer from whichever backend is in use.

    For the Mesos backend this is parsed out of a v1 ``OFFERS`` event; the
    local backend synthesizes one describing the host.
    """

    id: str
    agent_id: str
    hostname: str
    cpus: float = 0.0
    mem: float = 0.0
    chips: int = 0
    #: resource name the chips were advertised under ("tpus", or "gpus" on
    #: GPU agents) — TaskInfo must request them by the same name.
    chips_resource: str = "tpus"
    attributes: Dict[str, str] = field(default_factory=dict)
    raw: Optional[dict] = None


@dataclass
class TaskStatus:
    task_id: str
    state: str  # TASK_RUNNING / TASK_FINISHED / TASK_FAILED / ...
    message: str = ""
    agent_id: str = ""
    uuid: str = ""  # ack handle for Mesos explicit acknowledgements

    TERMINAL = frozenset(
        [
            "TASK_FINISHED",
            "TASK_FAILED",
            "TASK_KILLED",
            "TASK_ERROR",
            "TASK_LOST",
            "TASK_DROPPED",
            "TASK_GONE",
        ]
    )

    @property
    def terminal(self) -> bool:
        return self.state in self.TERMINAL


class Task:
    """One schedulable cluster member (reference: scheduler.py:34-177).

    Keeps the reference's lifecycle fields — a fresh ``uuid4`` id per launch
    attempt, ``offered`` flag, registered ``addr``, live control
    ``connection``, ``initialized`` flag — and its renderer to a backend
    TaskInfo.  (The reference misspells ``initalized``; we do not.)
    """

    def __init__(self, job_name: str, task_index: int, cpus: float = 1.0,
                 mem: float = 1024.0, chips: int = 0, cmd: Optional[str] = None,
                 volumes: Optional[Dict[str, str]] = None):
        self.job_name = job_name
        self.task_index = task_index
        self.cpus = cpus
        self.mem = mem
        self.chips = chips
        self.cmd = cmd
        self.volumes = volumes or {}

        self.id: str = str(uuid.uuid4())
        self.offered: bool = False
        self.offer_id: Optional[str] = None    # offer this attempt was placed on
        self.last_state: Optional[str] = None  # latest backend status state
        self.agent_id: Optional[str] = None
        self.hostname: Optional[str] = None
        self.addr: Optional[str] = None        # task's control addr, set at registration
        self.coord_port: Optional[int] = None  # port reserved for jax.distributed coordinator
        self.connection = None                 # live control socket while handshaking
        self.initialized: bool = False

    def __repr__(self) -> str:  # matches the reference's log-friendly repr intent
        return (f"<Task {self.job_name}:{self.task_index} id={self.id[:8]} "
                f"cpus={self.cpus} mem={self.mem} chips={self.chips} addr={self.addr}>")

    def reset(self) -> None:
        """Revive with a fresh identity (reference: scheduler.py:422-430)."""
        self.id = str(uuid.uuid4())
        self.offered = False
        self.offer_id = None
        self.last_state = None
        self.agent_id = None
        self.hostname = None
        self.addr = None
        self.coord_port = None
        if self.connection is not None:
            try:
                self.connection.close()
            except OSError:
                pass
        self.connection = None
        self.initialized = False

    def fits(self, offer: Offer) -> bool:
        return (offer.cpus >= self.cpus and offer.mem >= self.mem
                and offer.chips >= self.chips)

    def take_from(self, offer: Offer) -> None:
        offer.cpus -= self.cpus
        offer.mem -= self.mem
        offer.chips -= self.chips

    # -- rendering ---------------------------------------------------------

    def to_task_info(self, offer: Offer, master_addr: str, token: str,
                     docker_image: Optional[str] = None,
                     containerizer_type: Optional[str] = None,
                     force_pull_image: bool = False,
                     env: Optional[Dict[str, str]] = None,
                     token_file: Optional[str] = None,
                     secret_token: bool = False) -> dict:
        """Render a Mesos v1 JSON ``TaskInfo`` (reference: scheduler.py:61-177).

        The launched command is the port's node runtime dialing back to
        the scheduler's rendezvous address — the same bootstrap contract as
        the JAX package's:

            python -m tfmesos_tpu_torch.server <task_id> <master_addr>
        """
        env = dict(env or {})
        # The reference overwrites PYTHONPATH with the scheduler's sys.path so
        # tasks resolve the same code (scheduler.py:168-176); keep that.
        env["PYTHONPATH"] = ":".join(sys.path)
        # Token delivery, least-exposed transport first: a mode-0600 file
        # (co-located backends), a Mesos SECRET-typed variable (clusters with
        # a secret resolver; never shown in state endpoints), or — the
        # documented fallback — a plain env var, which anyone able to read
        # Mesos state or the agent's /proc can see.
        secret_vars = []
        if token_file:
            env[_TOKEN_FILE_ENV] = token_file
        elif secret_token:
            secret_vars.append({
                "name": _TOKEN_ENV,
                "type": "SECRET",
                "secret": {"type": "VALUE",
                           "value": {"data": base64.b64encode(
                               token.encode()).decode()}},
            })
        else:
            env[_TOKEN_ENV] = token

        ti: dict = {
            "name": f"{self.job_name}:{self.task_index}",
            "task_id": {"value": self.id},
            "agent_id": {"value": offer.agent_id},
            "resources": [
                _scalar("cpus", self.cpus),
                _scalar("mem", self.mem),
            ],
            "command": {
                "shell": True,
                "value": (f"{sys.executable} -m tfmesos_tpu_torch.server "
                          f"{self.id} {master_addr}"),
                "environment": {
                    "variables": [
                        {"name": k, "value": str(v)} for k, v in sorted(env.items())
                    ] + secret_vars
                },
            },
        }
        if self.chips:
            # Chips are requested under the SAME resource name the offer
            # advertised ("tpus" on TPU-VM agents, "gpus" on GPU agents) —
            # requesting a name the agent never offered would fail at launch.
            ti["resources"].append(
                _scalar(offer.chips_resource, float(self.chips)))

        image = docker_image or os.environ.get("DOCKER_IMAGE")
        if image:
            ti["container"] = _container(image, containerizer_type or "MESOS",
                                         force_pull_image, self.volumes)
        return ti


def _scalar(name: str, value: float) -> dict:
    return {"name": name, "type": "SCALAR", "scalar": {"value": value}}


def _container(image: str, containerizer_type: str, force_pull: bool,
               volumes: Dict[str, str]) -> dict:
    """Container config (reference: scheduler.py:82-146).

    The reference's nvidia-docker v1 plugin dance (scheduler.py:96-119) has no
    TPU analogue — TPU-VM containers only need /dev/vfio plumbed through,
    which the MESOS containerizer handles via the image rootfs — so only the
    rootfs/image and volume mounts survive.  /etc/passwd and /etc/group are
    mounted read-only so uids resolve identically in- and out-of-container
    (reference: scheduler.py:133-139).
    """
    vols = [
        {"container_path": "/etc/passwd", "host_path": "/etc/passwd", "mode": "RO"},
        {"container_path": "/etc/group", "host_path": "/etc/group", "mode": "RO"},
    ]
    for host_path, container_path in sorted(volumes.items()):
        vols.append({"container_path": container_path, "host_path": host_path,
                     "mode": "RW"})
    if containerizer_type == "DOCKER":
        return {
            "type": "DOCKER",
            "volumes": vols,
            "docker": {
                "image": image,
                "network": "HOST",
                "force_pull_image": force_pull,
                "parameters": [{"key": "memory-swap", "value": "-1"}],
            },
        }
    return {
        "type": "MESOS",
        "volumes": vols,
        "mesos": {"image": {"type": "DOCKER",
                            "docker": {"name": image},
                            "cached": not force_pull}},
    }
