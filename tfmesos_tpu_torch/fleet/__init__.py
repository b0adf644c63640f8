"""The fleet replica of the port (counterpart of ``tfmesos_tpu/fleet``,
same module names): :mod:`~tfmesos_tpu_torch.fleet.replica` is the
process ``python -m tfmesos_tpu_torch.fleet.replica`` that serves a
``ContinuousBatcher`` over the wire; :mod:`client` holds the
multiplexed link to a replica, :mod:`tracing` the hop-local trace,
:mod:`kvtier` the direct KV push.  The registry, router, gateway and
launcher are the JAX package's for now: a port replica registers with
them unchanged."""

from __future__ import annotations

from tfmesos_tpu_torch.fleet.client import (CallTimeout, ConnectionLost,
                                            MuxConnection, Overloaded,
                                            RateLimited, ReaderDied,
                                            RequestFailed)
from tfmesos_tpu_torch.fleet.tracing import TraceContext, new_trace_id

__all__ = ["CallTimeout", "ConnectionLost", "MuxConnection", "Overloaded",
           "RateLimited", "ReaderDied", "RequestFailed", "TraceContext",
           "new_trace_id"]
