"""Structured logging (port of ``tfmesos_tpu/utils/logging.py``).

One call sets up a logger with a parseable line format; the level comes
from ``TPUMESOS_LOGLEVEL`` (default INFO), as in the JAX package, so one
setting covers the processes of both.
"""

from __future__ import annotations

import logging
import os

_FORMAT = "%(asctime)s %(levelname)s [%(name)s] %(message)s"


def setup_logger(logger: logging.Logger, quiet: bool = False) -> None:
    if quiet:
        return
    if any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        return
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    # Our own handler is attached, so records must not also bubble up to
    # a root handler some library installed (each would print twice).
    logger.propagate = False
    level = os.environ.get("TPUMESOS_LOGLEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))


def get_logger(name: str, quiet: bool = False) -> logging.Logger:
    logger = logging.getLogger(name)
    setup_logger(logger, quiet=quiet)
    return logger
