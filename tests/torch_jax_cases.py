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

__all__ = ["port_cases", "port_module"]

TESTS = Path(__file__).resolve().parent
_JAX = re.compile(r"\btfmesos_tpu\b(?!_torch)")


def port_module(name: str) -> types.ModuleType:
    """``tests/<name>`` with ``tfmesos_tpu`` read as ``tfmesos_tpu_torch``,
    loaded as the module ``torch_port_<stem>``."""
    path = TESTS / name
    src = _JAX.sub("tfmesos_tpu_torch", path.read_text())
    mod_name = f"torch_port_{path.stem}"
    mod = types.ModuleType(mod_name)
    mod.__file__ = str(path)
    sys.modules[mod_name] = mod
    exec(compile(src, f"{path} (on tfmesos_tpu_torch)", "exec"),
         mod.__dict__)
    return mod


def port_cases(name: str) -> dict:
    """The test functions and fixtures of :func:`port_module`\\ (name)."""
    mod = port_module(name)
    return {k: v for k, v in vars(mod).items()
            if k.startswith("test_") or hasattr(v, "_pytestfixturefunction")
            or type(v).__name__ == "FixtureFunctionDefinition"}
