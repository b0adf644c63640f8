"""Task-side runtime, the env half (port of ``tfmesos_tpu/runtime.py:1-112``).

A Mode-B task's command learns where it sits in the cluster from
environment variables: the ``TFMESOS_*`` set kept for drop-in
compatibility with between-graph programs, and the ``TPUMESOS_*`` set
(rank, world size, coordinator, cluster map, mesh axes).
:class:`TaskContext` reads them back.  The JAX package's ``initialize``
(``jax.distributed``) and ``TaskContext.mesh`` are not ported: they are
Mode A, which waits (ROADMAP A.9).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["TaskContext", "task_env"]

ENV_RANK = "TPUMESOS_RANK"
ENV_WORLD = "TPUMESOS_WORLD_SIZE"
ENV_COORDINATOR = "TPUMESOS_COORDINATOR"
ENV_CLUSTER_DEF = "TPUMESOS_CLUSTER_DEF"
ENV_JOB_NAME = "TPUMESOS_JOB_NAME"
ENV_TASK_INDEX = "TPUMESOS_TASK_INDEX"
ENV_MESH_AXES = "TPUMESOS_MESH_AXES"


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
