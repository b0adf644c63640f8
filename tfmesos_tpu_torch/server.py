"""Node runtime: the process a backend launches per task (port of
``tfmesos_tpu/server.py``).

    python -m tfmesos_tpu_torch.server <task_id> <scheduler_addr>

It dials the scheduler's rendezvous address given on the command line,
registers, receives its config and acks, then runs one of two modes:

* **Mode A** (a config without ``cmd``): the SPMD executor.  It applies
  the env contract to its own environment, joins the process group
  (:func:`~tfmesos_tpu_torch.runtime.initialize`) and serves dispatches
  on the kept-open control connection: each ``run`` names a function by
  module and qualname, every rank calls ``func(ctx, *args, **kwargs)``
  and replies ``{op: result, call_id, gen, ok, value | error}``.  A
  dispatch stamped with another generation is dropped.  ``shutdown`` or
  the scheduler's EOF leaves the process group and exits 0.  Two
  ``extra_config`` keys steer it: ``no_jax`` (the JAX package's key,
  kept so configs serve both) makes no runtime at all, and ``device``
  is the device :func:`~tfmesos_tpu_torch.runtime.initialize` binds
  (``"cpu"``, else the card).
* **Mode B** (``cmd`` set): exec the command with the env contract
  (:func:`~tfmesos_tpu_torch.runtime.task_env`) and ``{placeholder}``
  substitution, pumping the child's output to our stdout and, when
  asked, over TCP to a log collector, between the ``initializer`` and
  ``finalizer`` hooks.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import traceback
from typing import Any, Dict, Optional

from tfmesos_tpu_torch import wire
from tfmesos_tpu_torch.logpump import pump_lines
from tfmesos_tpu_torch.runtime import TaskContext, task_env
from tfmesos_tpu_torch.utils.logging import get_logger

log = get_logger("tfmesos_tpu_torch.server")


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

    # Reserve a port for the process group's rendezvous store; rank 0's
    # reservation becomes the cluster's coordinator address.
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
    listen.close()
    if config.get("cmd") is None:
        wire.send_msg(sock, "ok", token)
        return _run_executor(sock, config, token, coord_sock)

    coord_sock.close()
    forward_fd = _connect_forwarder(config)
    wire.send_msg(sock, "ok", token)
    sock.close()
    return _run_cmd(config, forward_fd)


# -- Mode A: SPMD executor -------------------------------------------------


def _run_executor(sock: socket.socket, config: Dict[str, Any], token: str,
                  coord_sock: socket.socket) -> int:
    ctx = TaskContext.from_config(config)
    os.environ.update(task_env(config))
    for key, value in (config.get("env") or {}).items():
        os.environ[str(key)] = str(value)
    runtime = None
    if not ctx.extra_config.get("no_jax"):
        # torch imports (seconds) before the reserved port is released,
        # so rank 0's rendezvous store binds it a moment after the close.
        import torch.distributed  # noqa: F401

        from tfmesos_tpu_torch import runtime
    coord_sock.close()
    if runtime is not None:
        runtime.initialize(ctx, device=ctx.extra_config.get("device"))
    generation = int(config.get("generation", 0) or 0)
    sock.settimeout(None)
    try:
        return _serve_dispatches(sock, ctx, token, generation)
    finally:
        if runtime is not None:
            runtime.shutdown()


def _serve_dispatches(sock: socket.socket, ctx: TaskContext, token: str,
                      generation: int) -> int:
    while True:
        try:
            msg = wire.recv_msg(sock, token)
        except (wire.WireError, OSError):
            return 0            # the scheduler went away: teardown
        if not isinstance(msg, dict):
            continue
        op = msg.get("op")
        if op == "shutdown":
            return 0
        if op != "run":
            log.warning("unknown op %r", op)
            continue
        if "gen" in msg and msg["gen"] != generation:
            # A dispatch of another gang epoch must not run here: half a
            # collective would hang the current group.  The scheduler's
            # reply fence handles the mirror case.
            log.warning("dropping stale-generation dispatch (gen %r, ours "
                        "%d)", msg.get("gen"), generation)
            continue
        reply: Dict[str, Any] = {"op": "result",
                                 "call_id": msg.get("call_id"),
                                 "gen": generation}
        try:
            func = _resolve_func(msg["func"])
            value = func(ctx, *msg.get("args", ()), **msg.get("kwargs", {}))
            try:
                json.dumps(value)
            except (TypeError, ValueError):
                value = repr(value)
            reply.update(ok=True, value=value)
        except Exception:       # the function's failure is the reply
            reply.update(ok=False, error=traceback.format_exc())
        try:
            wire.send_msg(sock, reply, token)
        except OSError:
            return 0


def _resolve_func(spec: Dict[str, Any]):
    """The function a dispatch names: ``module`` + ``qualname``, or, for
    a function of the calling program's ``__main__`` script, that file (``path``)
    imported as a module (a shared filesystem, as the cwd forwarding
    assumes)."""
    module_name, qualname = spec["module"], spec["qualname"]
    path = spec.get("path")
    if path:
        loaded = sys.modules.get("__tpumesos_main__")
        if loaded is None or getattr(loaded, "__file__", None) != path:
            mod_spec = importlib.util.spec_from_file_location(
                "__tpumesos_main__", path)
            loaded = importlib.util.module_from_spec(mod_spec)
            sys.modules["__tpumesos_main__"] = loaded
            mod_spec.loader.exec_module(loaded)
        target: Any = loaded
    else:
        target = importlib.import_module(module_name)
    for part in qualname.split("."):
        target = getattr(target, part)
    return target


# -- Mode B: user command --------------------------------------------------


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
