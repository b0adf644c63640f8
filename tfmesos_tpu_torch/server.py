"""Node runtime: the process a backend launches per task (port of
``tfmesos_tpu/server.py``, Mode B).

    python -m tfmesos_tpu_torch.server <task_id> <scheduler_addr>

It dials the scheduler's rendezvous address given on the command line,
registers, receives its config and acks, then execs the task's command
with the env contract (:func:`~tfmesos_tpu_torch.runtime.task_env`) and
``{placeholder}`` substitution, pumping the child's output to its own
stdout and, when asked, over TCP to a log collector.  A config without a
command is Mode A, the SPMD executor over ``jax.distributed``: not
ported yet (ROADMAP A.9), so such a task exits non-zero.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Any, Dict, Optional

from tfmesos_tpu_torch import wire
from tfmesos_tpu_torch.logpump import pump_lines
from tfmesos_tpu_torch.runtime import task_env
from tfmesos_tpu_torch.utils.logging import get_logger

log = get_logger("tfmesos_tpu_torch.server")

MODE_A_REFUSAL = "not ported yet: Mode A (ROADMAP A.9)"


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("usage: python -m tfmesos_tpu_torch.server <task_id> "
              "<scheduler_addr>", file=sys.stderr)
        return 2
    task_id, scheduler_addr = argv
    token = wire.load_token()
    # The launch generation, echoed in the registration so the scheduler
    # can fence out registrations of an older epoch.
    try:
        generation = int(os.environ.get("TPUMESOS_GENERATION", "0") or 0)
    except ValueError:
        generation = 0

    # Our identity address; control flows over the dial-back connection.
    listen = wire.bind_ephemeral()
    addr = wire.sock_addr(listen, advertise_host=os.environ.get(
        "TPUMESOS_ADVERTISE_HOST"))

    # The registration carries a reserved coordinator port as the JAX
    # runtime's does; a Mode-B task never uses it.
    coord_sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    coord_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    coord_sock.bind(("", 0))
    coord_port = coord_sock.getsockname()[1]

    sock = wire.connect(scheduler_addr)
    wire.send_msg(sock, {"op": "register", "task_id": task_id, "addr": addr,
                         "coord_port": coord_port, "gen": generation}, token)
    # A static job's config comes only once every task has registered,
    # which can be long after ours: this wait gets its own timeout.
    sock.settimeout(float(os.environ.get("TPUMESOS_HANDSHAKE_TIMEOUT",
                                         "300")))
    config = wire.recv_msg(sock, token)
    log.info("task %s registered as %s:%s rank=%s", task_id[:8],
             config.get("job_name"), config.get("task_index"),
             config.get("rank"))
    coord_sock.close()
    listen.close()
    if config.get("cmd") is None:
        print(f"tfmesos_tpu_torch.server: {MODE_A_REFUSAL}",
              file=sys.stderr)
        sock.close()
        return 2

    forward_fd = _connect_forwarder(config)
    wire.send_msg(sock, "ok", token)
    sock.close()
    return _run_cmd(config, forward_fd)


class _SafeDict(dict):
    """``str.format_map`` helper: leave unknown ``{placeholders}`` intact."""

    def __missing__(self, key: str) -> str:
        return "{" + key + "}"


def _substitute_cmd(cmd: str, config: Dict[str, Any]) -> str:
    """The placeholder contract of the JAX runtime's Mode B."""
    cluster_def = config.get("cluster_def") or {}
    mapping = _SafeDict(
        ps_hosts=",".join(cluster_def.get("ps", [])),
        worker_hosts=",".join(cluster_def.get("worker", [])),
        job_name=config.get("job_name", ""),
        task_index=config.get("task_index", 0),
        rank=config.get("rank", 0),
        world_size=config.get("world_size", 1),
        coordinator=config.get("coordinator", ""),
    )
    return cmd.format_map(mapping)


def _connect_forwarder(config: Dict[str, Any]) -> Optional[socket.socket]:
    """Dial the log collector if this task's logs were requested."""
    forward = (config.get("forward_addresses") or {})
    key = f"{config.get('job_name')}:{config.get('task_index')}"
    target = forward.get(key) or forward.get("*")
    if not target:
        return None
    try:
        return wire.connect(target, timeout=10.0)
    except OSError as e:
        log.warning("cannot reach log collector %s: %s", target, e)
        return None


def _run_cmd(config: Dict[str, Any],
             forward_fd: Optional[socket.socket]) -> int:
    extra = config.get("extra_config") or {}
    env = dict(os.environ)
    env.update(task_env(config))
    for key, value in (config.get("env") or {}).items():
        env[str(key)] = str(value)

    initializer = extra.get("initializer")
    if initializer:
        subprocess.check_call(initializer, shell=True, env=env)

    cmd = _substitute_cmd(config["cmd"], config)
    cwd = config.get("cwd")
    if cwd and not os.path.isdir(cwd):
        cwd = None  # no shared filesystem; run where we are
    log.info("exec: %s", cmd)
    proc = subprocess.Popen(cmd, shell=True, env=env, cwd=cwd,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    prefix = f"[{config.get('job_name')}:{config.get('task_index')}] ".encode()
    pump_lines(proc.stdout, sys.stdout.buffer,
               forward_fd.fileno() if forward_fd else -1, prefix)
    rc = proc.wait()

    finalizer = extra.get("finalizer")
    if finalizer:
        subprocess.check_call(finalizer, shell=True, env=env)
    if forward_fd is not None:
        try:
            forward_fd.close()
        except OSError:
            pass
    return rc


if __name__ == "__main__":
    sys.exit(main())
