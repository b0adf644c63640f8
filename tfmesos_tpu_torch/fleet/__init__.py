"""Fleet serving of the PyTorch port (counterpart of ``tfmesos_tpu/fleet``,
same module names): online multi-replica inference over port replicas.

* :mod:`~tfmesos_tpu_torch.fleet.registry` — replica liveness via
  heartbeats over the authenticated wire (alive → draining → dead →
  evicted).
* :mod:`~tfmesos_tpu_torch.fleet.router` — prefix affinity, then
  least-outstanding p2c routing; bounded retry onto a different replica
  under a fleet retry budget, per-replica circuit breakers, end-to-end
  deadlines, the disaggregated prefill → KV transfer → decode handoff,
  and drain migration of suspended requests.
* :mod:`~tfmesos_tpu_torch.fleet.admission` — weighted-fair class
  queues with explicit ``Overloaded`` / ``RateLimited`` /
  ``DeadlineExceeded`` sheds.
* :mod:`~tfmesos_tpu_torch.fleet.containment` — the retry budget and
  the circuit breakers.
* :mod:`~tfmesos_tpu_torch.fleet.gateway` — the event-loop TCP front
  door that admits, routes and relays completions (streamed per token
  when asked).
* :mod:`~tfmesos_tpu_torch.fleet.metrics` — counters, histograms,
  gauges, the report line and the Prometheus exposition.
* :mod:`~tfmesos_tpu_torch.fleet.tracing` — request traces, flight
  recorders and the waterfall.
* :mod:`~tfmesos_tpu_torch.fleet.client` — the multiplexed link
  (:class:`MuxConnection`) and the caller's :class:`FleetClient`.
* :mod:`~tfmesos_tpu_torch.fleet.replica` — the replica process
  ``python -m tfmesos_tpu_torch.fleet.replica``: a ``ContinuousBatcher``
  behind a TCP server.
* :mod:`~tfmesos_tpu_torch.fleet.launcher` — ``FleetServer``: registry
  + gateway + replicas launched as Mode-B tasks through the port's
  scheduler and ``LocalBackend``.
* :mod:`~tfmesos_tpu_torch.fleet.kvtier` — the tiered KV store (bounded
  host RAM over an HMAC-framed disk directory, byte-compatible with the
  JAX store's), the cross-host KV fabric and the direct KV push.
* :mod:`~tfmesos_tpu_torch.fleet.catalog` — the adapter delta's wire
  codec (the replica's ``swap_adapter`` op); the catalog itself waits.

The wire is byte-compatible with the JAX package's, so a port replica
serves behind the JAX registry and gateway and a JAX replica behind the
port's.  Not ported yet: the autoscaler, the model catalog, gang
replicas, gateway processes, the HTTP edge, the simulator (ROADMAP A.9,
A.12).
"""

from __future__ import annotations

from tfmesos_tpu_torch.fleet.admission import (AdmissionController,
                                               DeadlineExceeded, Overloaded,
                                               RateLimited, TokenBucket)
from tfmesos_tpu_torch.fleet.client import (CallTimeout, ConnectionLost,
                                            FleetClient, MuxConnection,
                                            ReaderDied, RequestFailed)
from tfmesos_tpu_torch.fleet.containment import (BreakerBoard, BreakerConfig,
                                                 RetryBudget)
from tfmesos_tpu_torch.fleet.gateway import Gateway
from tfmesos_tpu_torch.fleet.kvtier import KVTierFull, KVTierStore
from tfmesos_tpu_torch.fleet.launcher import FleetServer
from tfmesos_tpu_torch.fleet.metrics import FleetMetrics
from tfmesos_tpu_torch.fleet.registry import (DECODE, PREFILL, UNIFIED,
                                              ReplicaInfo, ReplicaRegistry)
from tfmesos_tpu_torch.fleet.router import Router, RoutingError
from tfmesos_tpu_torch.fleet.tracing import (FlightRecorder, TraceBook,
                                             TraceContext, format_waterfall,
                                             new_trace_id)

__all__ = [
    "AdmissionController", "Overloaded", "RateLimited",
    "DeadlineExceeded", "TokenBucket",
    "BreakerBoard", "BreakerConfig", "RetryBudget",
    "CallTimeout", "ConnectionLost", "FleetClient", "MuxConnection",
    "ReaderDied", "RequestFailed",
    "Gateway", "FleetServer", "FleetMetrics", "KVTierFull",
    "KVTierStore", "ReplicaInfo",
    "ReplicaRegistry", "Router", "RoutingError",
    "FlightRecorder", "TraceBook", "TraceContext", "format_waterfall",
    "new_trace_id",
    "UNIFIED", "PREFILL", "DECODE",
]
