"""Run a JAX control-plane test file's cases on the port.

:func:`port_cases` reads ``tests/<name>``, points every import of
``tfmesos_tpu`` at ``tfmesos_tpu_torch`` (the control-plane modules keep
their names in the port), runs the result as a module of its own and
returns its test functions and fixtures, for a port test file to put in
its globals.  The cases themselves are the JAX file's, unchanged: a
port module that disagrees with its reference fails them.
"""

from __future__ import annotations

import re
import sys
import types
from pathlib import Path

__all__ = ["port_cases", "port_module", "timeless"]

TESTS = Path(__file__).resolve().parent
_JAX = re.compile(r"\btfmesos_tpu\b(?!_torch)")


def port_module(name: str, deps=(), subs=()) -> types.ModuleType:
    """``tests/<name>`` with ``tfmesos_tpu`` read as ``tfmesos_tpu_torch``,
    loaded as the module ``torch_port_<stem>``.  ``subs``: further
    ``(pattern, replacement)`` rewrites of the source, applied after
    that one (an import pointed at a bridge that carries the JAX file's
    arrays to the port).

    ``deps`` names the JAX test files it imports from (``test_scheduler.py``
    for ``from test_scheduler import FakeBackend``): each is ported too,
    and the import is read as one of its port copy, so that the JAX test
    module itself, which a later test file of the same process may
    import, stays as it is."""
    path = TESTS / name
    src = _JAX.sub("tfmesos_tpu_torch", path.read_text())
    for pattern, repl in subs:
        src = re.sub(pattern, repl, src)
    for dep in deps:
        stem = Path(dep).stem
        if f"torch_port_{stem}" not in sys.modules:
            port_module(dep)
        src = re.sub(rf"\bfrom {stem} import\b",
                     f"from torch_port_{stem} import", src)
    mod_name = f"torch_port_{path.stem}"
    mod = types.ModuleType(mod_name)
    mod.__file__ = str(path)
    sys.modules[mod_name] = mod
    exec(compile(src, f"{path} (on tfmesos_tpu_torch)", "exec"),
         mod.__dict__)
    return mod


def port_cases(name: str, deps=(), subs=()) -> dict:
    """The test functions and fixtures of :func:`port_module`\\ (name,
    deps, subs)."""
    mod = port_module(name, deps, subs)
    return {k: v for k, v in vars(mod).items()
            if k.startswith("test_") or hasattr(v, "_pytestfixturefunction")
            or type(v).__name__ == "FixtureFunctionDefinition"}


def timeless(res):
    """A simulator result (``fleet.sim``) without the keys read off the
    wall clock (``wall_s``, ``*per_sec*``,
    ``sim_replicas_per_wallclock_sec``), tuples as lists (as JSON gives
    them): what the JAX and the port simulators must agree on."""
    if isinstance(res, dict):
        return {k: timeless(v) for k, v in res.items()
                if k != "wall_s" and "per_sec" not in k
                and k != "sim_replicas_per_wallclock_sec"}
    if isinstance(res, (list, tuple)):
        return [timeless(v) for v in res]
    return res
