"""Checkpoint and resume of training state (port of
``tfmesos_tpu/train/checkpoint.py``), with a format of its own: the
reference writes through Orbax, which needs JAX.

A state tree is nested dicts, tuples and lists whose leaves are torch
tensors, :class:`~tfmesos_tpu_torch.ops.quant.QTensor` pairs, the
optimizer's :class:`~tfmesos_tpu_torch.train.optim.OptState` and Python
ints.  A checkpoint is one directory ``step_<N>`` under the manager's
``workdir`` holding ``state.pt``: a flat ``{path: value}`` dict written
by ``torch.save`` and read back with ``torch.load(weights_only=True)``.
A path joins the tree's keys with ``/``; a QTensor ends in ``/values``
and ``/scales``; an OptState gives ``<path>/count`` (optax's update
count) and ``<path>/{exp_avg,exp_avg_sq,step}/<param name>`` (the torch
optimizer's state of each leaf, by the param's flattened name).

:func:`convert_orbax` writes such a checkpoint from an Orbax checkpoint
of the JAX trainer, read back as numpy by the caller.

On a mesh whose params are cut per ``partition_specs`` (a manager made
with ``mesh`` and ``param_specs``), a save gathers every cut leaf whole
(the params and their AdamW moments) and rank 0 alone writes, so the
format is the one-process format; a restore cuts each saved leaf to
the rank's block.  A run saved on one mesh continues on another, or on
one process.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import time
from collections.abc import Mapping
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from tfmesos_tpu_torch.convert import flatten, params_from_jax
from tfmesos_tpu_torch.ops.quant import QTensor
from tfmesos_tpu_torch.train.optim import OptState
from tfmesos_tpu_torch.utils.logging import get_logger

log = get_logger("tfmesos_tpu_torch.checkpoint")

STATE_FILE = "state.pt"
_STEP_DIR = re.compile(r"step_(\d+)")


def flat_state(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """The ``{path: leaf}`` view of a state tree (see the module
    docstring).  An OptState's per-leaf state is created where it is
    missing (:meth:`OptState.moments`), so its view can be restored
    into."""
    out: Dict[str, Any] = {}
    if isinstance(tree, OptState):
        out[prefix + "count"] = tree.count
        for m, named in tree.moments().items():
            for name, t in named.items():
                out[f"{prefix}{m}/{name}"] = t
    elif isinstance(tree, QTensor):
        out[prefix + "values"], out[prefix + "scales"] = tree
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(flat_state(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(flat_state(v, f"{prefix}{i}/"))
    elif isinstance(tree, (torch.Tensor, int)) and not isinstance(tree,
                                                                  bool):
        out[prefix.rstrip("/")] = tree
    else:
        raise TypeError(f"checkpoint leaf {prefix.rstrip('/') or '<root>'}"
                        f" of type {type(tree).__name__}: a state tree "
                        f"holds tensors, QTensors, OptStates and ints")
    return out


def _restore_into(tree: Any, saved: Dict[str, Any], prefix: str = "") -> Any:
    """Copy ``saved`` into ``tree``'s tensors in place, by path; returns
    the tree with its ints replaced by the saved ones (tensors, QTensors
    and OptStates are the template's own objects)."""
    if isinstance(tree, OptState):
        tree.count = _restore_into(tree.count, saved, prefix + "count/")
        for m, named in tree.moments().items():
            for name, t in named.items():
                _restore_into(t, saved, f"{prefix}{m}/{name}/")
        return tree
    if isinstance(tree, QTensor):
        for t, f in zip(tree, QTensor._fields):
            _restore_into(t, saved, f"{prefix}{f}/")
        return tree
    if isinstance(tree, Mapping):
        return {k: _restore_into(v, saved, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_restore_into(v, saved, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    path = prefix.rstrip("/")
    if path not in saved:
        raise KeyError(f"checkpoint has no {path!r}")
    got = saved[path]
    if isinstance(tree, torch.Tensor):
        if not isinstance(got, torch.Tensor):
            raise TypeError(f"{path}: checkpoint holds "
                            f"{type(got).__name__}, template a tensor")
        if got.shape != tree.shape or got.dtype != tree.dtype:
            raise ValueError(
                f"{path}: checkpoint {got.dtype}{list(got.shape)} does not "
                f"match the template's {tree.dtype}{list(tree.shape)}")
        with torch.no_grad():
            tree.copy_(got)
        return tree
    if not isinstance(got, int) or isinstance(got, bool):
        raise TypeError(f"{path}: checkpoint holds {type(got).__name__}, "
                        f"template an int")
    return got


class CheckpointManager:
    """Save and restore state trees under ``workdir``, keeping the
    newest ``max_to_keep`` steps (``None`` keeps all).

    A save writes into a hidden temporary directory and then renames it
    to ``step_<N>`` in one ``os.replace``, so a crash mid-write leaves
    every earlier step readable and :meth:`latest_step` never sees a
    partial one; the oldest steps are removed only after the new one has
    landed."""

    def __init__(self, workdir: str, max_to_keep: Optional[int] = 3,
                 mesh=None, param_specs: Optional[Mapping] = None):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1 or None, got "
                             f"{max_to_keep}")
        self.workdir = os.path.abspath(workdir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.workdir, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # Host buffers of the last snapshot, by path, reused by the next
        # save (pinned for a card's tensors).
        self._host: Dict[str, torch.Tensor] = {}
        # A sharded state: the mesh its leaves are cut over and each
        # param's spec by flattened name ("layers/wq").
        self.mesh = mesh if mesh is not None and mesh.size() > 1 else None
        self._specs: Dict[str, Any] = {}
        if self.mesh is not None and param_specs is not None:
            self._specs = _flat_specs(param_specs)

    @property
    def writer(self) -> bool:
        """Whether this process writes (rank 0 of a sharded state)."""
        return self.mesh is None or self.mesh.rank == 0

    def _spec_of(self, path: str, leaf: torch.Tensor):
        """The spec of the param whose flattened name ends ``path`` (a
        param or one of its moments, of the param's rank), else None."""
        parts = path.split("/")
        for i in range(len(parts)):
            spec = self._specs.get("/".join(parts[i:]))
            if spec is not None and len(spec) == leaf.dim():
                return spec
        return None

    def _whole(self, flat: Dict[str, Any]) -> Dict[str, Any]:
        """``flat`` with every cut leaf gathered whole (collectives, in
        path order on every rank)."""
        from tfmesos_tpu_torch.parallel.sharding import uncut

        if not self._specs:
            return flat
        out = {}
        for path, v in flat.items():
            spec = (self._spec_of(path, v) if isinstance(v, torch.Tensor)
                    else None)
            out[path] = v if spec is None else uncut(v.detach(), spec,
                                                     self.mesh)
        return out

    def _cut(self, saved: Dict[str, Any], template: Any) -> Dict[str, Any]:
        """The saved whole leaves cut to this rank's blocks, per the
        template's paths."""
        from tfmesos_tpu_torch.parallel.sharding import cut

        if not self._specs:
            return saved
        out = dict(saved)
        for path, v in flat_state(template).items():
            spec = (self._spec_of(path, v) if isinstance(v, torch.Tensor)
                    else None)
            if spec is not None and path in saved:
                out[path] = cut(saved[path], spec, self.mesh)
        return out

    # -- saving ------------------------------------------------------------

    def _snapshot(self, flat: Dict[str, Any]) -> Dict[str, Any]:
        """Every tensor of the flat state copied to the host.  Card
        tensors go to pinned buffers on the current stream, then ONE
        stream sync; the training step updates params and moments in
        place, so a write that kept references would write a later
        step's values."""
        snap: Dict[str, Any] = {}
        cuda_streams = set()
        for path, v in flat.items():
            if not isinstance(v, torch.Tensor):
                snap[path] = v
                continue
            v = v.detach()
            buf = self._host.get(path)
            if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                buf = torch.empty(v.shape, dtype=v.dtype,
                                  pin_memory=v.is_cuda)
                self._host[path] = buf
            if v.is_cuda:
                buf.copy_(v, non_blocking=True)
                cuda_streams.add(torch.cuda.current_stream(v.device))
            else:
                buf.copy_(v)
            snap[path] = buf
        for stream in cuda_streams:
            stream.synchronize()
        return snap

    def _write(self, step: int, snap: Dict[str, Any]) -> None:
        final = os.path.join(self.workdir, f"step_{step}")
        tmp = os.path.join(self.workdir,
                           f".tmp-step_{step}-{os.getpid()}-"
                           f"{threading.get_ident()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                torch.save(snap, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.isdir(final):           # a re-save of this step
                old = tmp + ".old"
                os.replace(final, old)
                os.replace(tmp, final)
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.replace(tmp, final)
            dir_fd = os.open(self.workdir, os.O_RDONLY)
            try:
                os.fsync(dir_fd)                # the rename itself durable
            finally:
                os.close(dir_fd)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()

    def _prune(self) -> None:
        if self.max_to_keep is None:
            return
        for step in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.workdir, f"step_{step}"),
                          ignore_errors=True)

    def save(self, step: int, state: Any, wait: bool = True) -> None:
        """Save ``state`` at ``step``.

        ``wait=False`` returns once the state is copied to host memory;
        a writer thread then writes it, overlapping the file write with
        the next training steps.  One write is in flight at a time: the
        next save (or :meth:`wait_until_finished`, :meth:`restore`,
        :meth:`close`) first joins it and raises what it raised.  On a
        sharded state every rank calls it (the gather is collective) and
        rank 0 writes."""
        self.wait_until_finished()
        flat = self._whole(flat_state(state))
        if not self.writer:
            return
        snap = self._snapshot(flat)
        if wait:
            self._write(step, snap)
        else:
            def write():
                try:
                    self._write(step, snap)
                except BaseException as e:     # re-raised by the next join
                    self._error = e

            self._writer = threading.Thread(
                target=write, name=f"checkpoint-step-{step}", daemon=True)
            self._writer.start()
        log.info("saved checkpoint step=%d at %s%s", step, self.workdir,
                 "" if wait else " (async)")

    def wait_until_finished(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- reading -----------------------------------------------------------

    def all_steps(self) -> List[int]:
        """The complete steps on disk, oldest first."""
        steps = []
        for name in os.listdir(self.workdir):
            m = _STEP_DIR.fullmatch(name)
            if m and os.path.isfile(os.path.join(self.workdir, name,
                                                 STATE_FILE)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """Copy step ``step`` (default: the latest) into ``state_like``'s
        tensors, on their devices, and return the tree with its ints
        restored; ``None`` when there is no checkpoint.  The template's
        tensors are the restored ones, since other objects hold them
        (an OptState's leaves ARE the param tensors).  Raises on a name
        the checkpoint lacks, or a shape or dtype that differs."""
        self.wait_until_finished()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        t0 = time.perf_counter()
        path = os.path.join(self.workdir, f"step_{step}", STATE_FILE)
        saved = torch.load(path, map_location="cpu", weights_only=True)
        restored = _restore_into(state_like, self._cut(saved, state_like))
        log.info("restored checkpoint step=%d (%.3f s)", step,
                 time.perf_counter() - t0)
        return restored

    def close(self) -> None:
        self.wait_until_finished()


def _flat_specs(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    """``{"layers/wq": spec, ...}`` of a nested spec dict."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# -- an Orbax checkpoint of the JAX trainer -----------------------------------


def _adam_nodes(tree: Any, path: str = "") -> List[Any]:
    """Every node of ``tree`` with the fields ``count``, ``mu`` and
    ``nu`` (optax's ScaleByAdamState as a NamedTuple, or the dict a
    template-free restore gives), wherever it is nested."""
    fields = getattr(tree, "_fields", None)
    if fields is not None and {"count", "mu", "nu"} <= set(fields):
        return [tree._asdict()]
    if isinstance(tree, Mapping):
        if {"count", "mu", "nu"} <= set(tree):
            return [tree]
        return [n for v in tree.values() for n in _adam_nodes(v)]
    if isinstance(tree, (tuple, list)):
        return [n for v in tree for n in _adam_nodes(v)]
    return []


def opt_state_from_optax(params: Mapping, opt_state: Any) -> Dict[str, Any]:
    """The checkpoint form of the port's OptState from an optax
    ``adamw`` state (numpy leaves), chained after
    ``clip_by_global_norm`` or not: ``count`` and each leaf's
    ``exp_avg`` / ``exp_avg_sq`` from the one node holding ``count``,
    ``mu`` and ``nu``, and torch's per-leaf ``step`` set to that count,
    so the bias correction and a schedule of the count carry on where
    JAX left off."""
    nodes = _adam_nodes(opt_state)
    if len(nodes) != 1:
        raise ValueError(f"expected exactly one optax Adam state (fields "
                         f"count, mu, nu), found {len(nodes)}")
    adam = nodes[0]
    count = int(np.asarray(adam["count"]))
    names = list(flatten(params))
    mu = flatten(params_from_jax(adam["mu"]))
    nu = flatten(params_from_jax(adam["nu"]))
    if sorted(mu) != sorted(names) or sorted(nu) != sorted(names):
        raise ValueError("the Adam moments' names differ from the params'")
    return {"count": count,
            "exp_avg": {n: mu[n] for n in names},
            "exp_avg_sq": {n: nu[n] for n in names},
            "step": {n: torch.tensor(float(count), dtype=torch.float32)
                     for n in names}}


def convert_orbax(tree: Any, workdir: str, step: Optional[int] = None,
                  max_to_keep: Optional[int] = 3) -> int:
    """Write a checkpoint of the port from an Orbax checkpoint of the JAX
    trainer, restored and turned to numpy by the caller (on a host with
    JAX: ``jax.tree_util.tree_map(np.asarray, mgr.restore(...))``).

    ``tree`` is the example's ``(params, opt_state)`` or ``TrainLoop``'s
    ``{"params", "opt_state", "step"}``; the port's checkpoint keeps that
    shape, so the same template restores it.  ``step`` defaults to the
    tree's own ``step`` (required for the tuple form).  Returns the step
    written."""
    if isinstance(tree, Mapping):
        params, opt, own = tree["params"], tree["opt_state"], tree.get("step")
    else:
        (params, opt), own = tree, None
    if step is None:
        if own is None:
            raise ValueError("step is required: the tree carries none")
        step = int(np.asarray(own))
    tparams = params_from_jax(params)
    topt = opt_state_from_optax(tparams, opt)
    out: Any = ({"params": tparams, "opt_state": topt, "step": step}
                if isinstance(tree, Mapping) else (tparams, topt))
    mgr = CheckpointManager(workdir, max_to_keep=max_to_keep)
    try:
        mgr.save(step, out)
    finally:
        mgr.close()
    return step
