"""Task-side runtime: the env contract, the process group and the data
mesh (port of ``tfmesos_tpu/runtime.py``).

A task's command learns where it sits in the cluster from environment
variables: the ``TFMESOS_*`` set kept for drop-in compatibility with
between-graph programs, and the ``TPUMESOS_*`` set (rank, world size,
coordinator, cluster map, mesh axes).  :class:`TaskContext` reads them
back.  A program calls :func:`initialize` once: it binds this rank's
device and joins ``torch.distributed`` at the coordinator (rank 0's host
and its reserved port), and ``TaskContext.mesh()`` then hands it the
data mesh its collectives run over.  Nothing here imports torch until
:func:`initialize` or ``mesh()`` runs, so a Mode-B task that only reads
its env pays nothing for it.
"""

from __future__ import annotations

import collections
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from tfmesos_tpu_torch.utils.logging import get_logger

__all__ = ["TaskContext", "task_env", "initialize", "shutdown",
           "rank_hosts", "local_index", "choose_backend"]

ENV_RANK = "TPUMESOS_RANK"
ENV_WORLD = "TPUMESOS_WORLD_SIZE"
ENV_COORDINATOR = "TPUMESOS_COORDINATOR"
ENV_CLUSTER_DEF = "TPUMESOS_CLUSTER_DEF"
ENV_JOB_NAME = "TPUMESOS_JOB_NAME"
ENV_TASK_INDEX = "TPUMESOS_TASK_INDEX"
ENV_MESH_AXES = "TPUMESOS_MESH_AXES"
#: Seconds a collective (and the rendezvous) may wait for a peer before
#: it raises: far above a training step (and a first step's kernel
#: build), far below torch's 30 minutes.
PG_TIMEOUT_S = 600.0

log = get_logger("tfmesos_tpu_torch.runtime")

# The device initialize() bound in this process (None before): process
# state, as torch.cuda.set_device and the process group are.
_device = None


@dataclass
class TaskContext:
    """Everything one cluster member knows about itself and its peers."""

    rank: int = 0
    world_size: int = 1
    job_name: str = "worker"
    task_index: int = 0
    coordinator: Optional[str] = None
    cluster_def: Dict[str, List[str]] = field(default_factory=dict)
    mesh_axes: Optional[Dict[str, int]] = None
    extra_config: Dict[str, Any] = field(default_factory=dict)

    @property
    def is_chief(self) -> bool:
        return self.rank == 0

    @property
    def device(self):
        """The ``torch.device`` :func:`initialize` bound in this process
        (None before it ran)."""
        return _device

    def mesh(self, axes: Optional[Dict[str, int]] = None):
        """The mesh over every rank (``parallel.mesh.build_mesh``: dp,
        fsdp and tp, one rank a device): ``axes`` or the cluster's mesh
        axes, all ``dp`` when neither is given, on the device type
        :func:`initialize` bound."""
        from tfmesos_tpu_torch.parallel.mesh import build_mesh

        return build_mesh(axes or self.mesh_axes, world_size=self.world_size,
                          device_type=_device.type if _device else "cpu")

    @classmethod
    def from_env(cls) -> "TaskContext":
        cluster_def = json.loads(os.environ.get(ENV_CLUSTER_DEF, "{}"))
        mesh_axes_raw = os.environ.get(ENV_MESH_AXES, "")
        return cls(
            rank=int(os.environ.get(ENV_RANK, "0")),
            world_size=int(os.environ.get(ENV_WORLD, "1")),
            job_name=os.environ.get(ENV_JOB_NAME, "worker"),
            task_index=int(os.environ.get(ENV_TASK_INDEX, "0")),
            coordinator=os.environ.get(ENV_COORDINATOR) or None,
            cluster_def=cluster_def,
            mesh_axes=json.loads(mesh_axes_raw) if mesh_axes_raw else None,
        )

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "TaskContext":
        return cls(
            rank=int(config.get("rank", 0)),
            world_size=int(config.get("world_size", 1)),
            job_name=config.get("job_name", "worker"),
            task_index=int(config.get("task_index", 0)),
            coordinator=config.get("coordinator"),
            cluster_def=config.get("cluster_def") or {},
            mesh_axes=config.get("mesh_axes"),
            extra_config=config.get("extra_config") or {},
        )


def task_env(config: Dict[str, Any]) -> Dict[str, str]:
    """The env-var contract for a task config: the compatible
    ``TFMESOS_*`` set and the ``TPUMESOS_*`` set."""
    cluster_def = config.get("cluster_def") or {}
    env = {
        # Compatible set (ps/worker names as the original framework
        # hard-codes them; empty when those jobs don't exist).
        "TFMESOS_PS_HOSTS": ",".join(cluster_def.get("ps", [])),
        "TFMESOS_WORKER_HOSTS": ",".join(cluster_def.get("worker", [])),
        "TFMESOS_JOB_NAME": str(config.get("job_name", "")),
        "TFMESOS_TASK_INDEX": str(config.get("task_index", 0)),
        "TFMESOS_DISTRIBUTED": "1",
        ENV_RANK: str(config.get("rank", 0)),
        ENV_WORLD: str(config.get("world_size", 1)),
        ENV_JOB_NAME: str(config.get("job_name", "")),
        ENV_TASK_INDEX: str(config.get("task_index", 0)),
        ENV_CLUSTER_DEF: json.dumps(cluster_def, separators=(",", ":")),
        "PYTHONUNBUFFERED": "1",
    }
    if config.get("coordinator"):
        env[ENV_COORDINATOR] = config["coordinator"]
    if config.get("mesh_axes"):
        env[ENV_MESH_AXES] = json.dumps(config["mesh_axes"],
                                        separators=(",", ":"))
    return env


def rank_hosts(ctx: TaskContext) -> List[str]:
    """The host of every rank, in rank order: ``cluster_def`` lists the
    jobs in declared order and each job's tasks by index, which is the
    scheduler's rank order.  When it does not cover the world (a program
    started by hand), every rank counts as on one host."""
    hosts = [addr.rsplit(":", 1)[0]
             for addrs in ctx.cluster_def.values() for addr in addrs]
    return hosts if len(hosts) == ctx.world_size else [""] * ctx.world_size


def local_index(ctx: TaskContext) -> int:
    """This rank's position among the ranks on its own host."""
    hosts = rank_hosts(ctx)
    return hosts[:ctx.rank].count(hosts[ctx.rank])


def choose_backend(ctx: TaskContext, device_type: str,
                   device_count: int) -> str:
    """The process group's backend, decided before it exists:

    * ``gloo`` when the ranks run on the CPU;
    * ``nccl`` on the card when no host runs more ranks than it has
      cards (``device_count``, this host's; hosts are taken to be
      alike, so every rank decides the same), each rank on a card of
      its own;
    * ``gloo`` over CUDA tensors when ranks share a card, which NCCL
      refuses ("Duplicate GPU detected"): gloo stages each collective
      through host memory.
    """
    if device_type != "cuda":
        return "gloo"
    busiest = max(collections.Counter(rank_hosts(ctx)).values())
    return "nccl" if busiest <= device_count else "gloo"


def initialize(ctx: Optional[TaskContext] = None, device=None
               ) -> TaskContext:
    """Bind this rank's device and join the process group.

    ``device`` follows the port's entry points (``device.resolve_device``:
    the card unless ``"cpu"``; no card raises).  On the card the rank
    binds ``cuda:(local index % device_count)``.  At world size 1 no
    process group is made, as the JAX runtime makes none; otherwise
    ``torch.distributed.init_process_group`` rendezvouses at
    ``tcp://<coordinator>`` with this context's rank and world size, on
    the backend :func:`choose_backend` picks (logged), with collectives
    timing out after ``PG_TIMEOUT_S``.  One all-reduce over the new
    group proves it before return: a failing NCCL raises here, and is
    never retried as gloo.  Calling it again in a process that already
    joined returns ``ctx``."""
    global _device
    import datetime

    import torch
    import torch.distributed as dist

    from tfmesos_tpu_torch.device import resolve_device

    if ctx is None:
        ctx = TaskContext.from_env()
    dev = resolve_device(device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_index(ctx) % n_cards)
        torch.cuda.set_device(dev)
    _device = dev
    if ctx.world_size <= 1 or dist.is_initialized():
        return ctx
    if not ctx.coordinator:
        raise RuntimeError(f"rank {ctx.rank} of {ctx.world_size} has no "
                           f"coordinator address ({ENV_COORDINATOR})")
    backend = choose_backend(ctx, dev.type, n_cards)
    log.info("rank %d of %d joins a %s process group at %s on %s "
             "(%d rank(s) on the busiest host, %d card(s) here)",
             ctx.rank, ctx.world_size, backend, ctx.coordinator, dev,
             max(collections.Counter(rank_hosts(ctx)).values()), n_cards)
    extra = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{ctx.coordinator}",
                            rank=ctx.rank, world_size=ctx.world_size,
                            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S),
                            **extra)
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    if int(probe.item()) != ctx.world_size:
        raise RuntimeError(f"process group probe summed {probe.item()} "
                           f"over {ctx.world_size} ranks")
    return ctx


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
