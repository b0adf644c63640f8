"""Child-stdout line pump with optional TCP forwarding (port of
``tfmesos_tpu/logpump.py``, its pure-Python path: the JAX package's
native C++ pump is not built for the port yet).
"""

from __future__ import annotations

import os
from typing import BinaryIO

__all__ = ["pump_lines"]


def pump_lines(src: BinaryIO, local_out: BinaryIO, forward_fd: int,
               prefix: bytes) -> None:
    """Pump ``src`` to ``local_out`` line by line until EOF; each line
    also goes to ``forward_fd`` (if >= 0) with ``prefix`` prepended.  A
    failed forward write stops forwarding, never the local pump."""
    for line in iter(src.readline, b""):
        local_out.write(line)
        local_out.flush()
        if forward_fd >= 0:
            try:
                os.write(forward_fd, prefix + line)
            except OSError:
                forward_fd = -1
