"""Child-stdout line pump with optional TCP forwarding (port of
``tfmesos_tpu/logpump.py``).

The node runtime's hottest control-plane loop: every byte of a Mode-B
child's output passes through it.  ``native/logpump.cpp`` (a copy of the
JAX package's) splices child stdout to the local stdout, and each
complete line, prefixed ``[job:idx]``, to the forward socket, entirely
in C.  It is built with ``g++`` at first use by
:func:`~tfmesos_tpu_torch.kernels.build.build_host` and loaded with
``ctypes``; a failed build raises.  The pure-Python loop runs only where
the caller asks for it (``_lib = None`` with ``_lib_tried = True``, as
the tests do) or where the native pump reports a read or write error.
"""

from __future__ import annotations

import ctypes
import os
from typing import BinaryIO, Optional

__all__ = ["pump_lines"]

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if not _lib_tried:
        from tfmesos_tpu_torch.kernels.build import build_host

        lib = ctypes.CDLL(str(build_host("logpump")))
        lib.tpumesos_pump_lines.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.tpumesos_pump_lines.restype = ctypes.c_int
        _lib = lib
        _lib_tried = True
    return _lib


def pump_lines(src: BinaryIO, local_out: BinaryIO, forward_fd: int,
               prefix: bytes) -> None:
    """Pump ``src`` to ``local_out`` until EOF; each line also goes to
    ``forward_fd`` (if >= 0) with ``prefix`` prepended.  A failed forward
    write stops forwarding, never the local pump."""
    lib = _load()
    if lib is not None:
        local_out.flush()
        rc = lib.tpumesos_pump_lines(src.fileno(), local_out.fileno(),
                                     forward_fd, prefix, len(prefix))
        if rc == 0:
            return
    for line in iter(src.readline, b""):
        local_out.write(line)
        local_out.flush()
        if forward_fd >= 0:
            try:
                os.write(forward_fd, prefix + line)
            except OSError:
                forward_fd = -1
