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
  scheduler and ``LocalBackend``, plus the blue-green
  ``FleetServer.rollout`` control op.
* :mod:`~tfmesos_tpu_torch.fleet.autoscaler` — the control-plane
  feedback loop that grows and shrinks each tier from live load
  signals (queue-wait p99 for prompt tiers, KV headroom for decode)
  within min/max bounds, with hysteresis, per-tier cooldowns,
  drain-migrate-kill scale-down and a never-below-one-alive invariant.
* :mod:`~tfmesos_tpu_torch.fleet.kvtier` — the tiered KV store (bounded
  host RAM over an HMAC-framed disk directory, byte-compatible with the
  JAX store's), the cross-host KV fabric and the direct KV push.
* :mod:`~tfmesos_tpu_torch.fleet.catalog` — the model catalog, the
  warm pool's keys, the cross-model replica trader and the adapter
  delta's wire codec (the replica's ``swap_adapter`` op).
* :mod:`~tfmesos_tpu_torch.fleet.gang` — gang replicas: one routable
  replica over N member processes.
* :mod:`~tfmesos_tpu_torch.fleet.http` — the HTTP/SSE edge on a
  gateway's port; the gateway module is also the gateway process
  (``python -m tfmesos_tpu_torch.fleet.gateway``) with its registry
  sidecar.  ``FleetServer(batch_lane=True)`` adds the offline lane.
* :mod:`~tfmesos_tpu_torch.fleet.sim` /
  :mod:`~tfmesos_tpu_torch.fleet.workload` — the trace-driven fleet
  simulator: the admission, router, containment, registry, autoscaler
  and catalog code above on a virtual clock against simulated
  replicas, with synthesized or trace-replayed workloads, named
  scenarios (``tfserve simulate``) and policy-constant sweeps.

The wire is byte-compatible with the JAX package's, so a port replica
serves behind the JAX registry and gateway and a JAX replica behind the
port's.
"""

from __future__ import annotations

from tfmesos_tpu_torch.fleet.admission import (AdmissionController,
                                               DeadlineExceeded, Overloaded,
                                               RateLimited, TokenBucket)
from tfmesos_tpu_torch.fleet.autoscaler import (AutoscalerConfig,
                                                FleetAutoscaler)
from tfmesos_tpu_torch.fleet.catalog import (ModelCatalog, ModelSpec,
                                             ModelTrader, TraderConfig)
from tfmesos_tpu_torch.fleet.client import (CallTimeout, ConnectionLost,
                                            FleetClient, MuxConnection,
                                            ReaderDied, RequestFailed)
from tfmesos_tpu_torch.fleet.containment import (BreakerBoard, BreakerConfig,
                                                 RetryBudget)
from tfmesos_tpu_torch.fleet.gateway import Gateway
from tfmesos_tpu_torch.fleet.kvtier import KVTierFull, KVTierStore
from tfmesos_tpu_torch.fleet.launcher import FleetServer, RolloutError
from tfmesos_tpu_torch.fleet.metrics import FleetMetrics
from tfmesos_tpu_torch.fleet.registry import (DECODE, PREFILL, UNIFIED,
                                              ReplicaInfo, ReplicaRegistry)
from tfmesos_tpu_torch.fleet.router import Router, RoutingError
from tfmesos_tpu_torch.fleet.sim import (FleetSim, ReplicaModel, SimConfig,
                                         SimEngine, VirtualClock,
                                         run_scenario, run_sweep)
from tfmesos_tpu_torch.fleet.tracing import (FlightRecorder, TraceBook,
                                             TraceContext, format_waterfall,
                                             new_trace_id)
from tfmesos_tpu_torch.fleet.workload import (Request, SyntheticWorkload,
                                              fit_replica_model,
                                              replay_from_traces)

__all__ = [
    "AdmissionController", "Overloaded", "RateLimited",
    "DeadlineExceeded", "TokenBucket",
    "AutoscalerConfig", "FleetAutoscaler", "RolloutError",
    "ModelCatalog", "ModelSpec", "ModelTrader", "TraderConfig",
    "BreakerBoard", "BreakerConfig", "RetryBudget",
    "CallTimeout", "ConnectionLost", "FleetClient", "MuxConnection",
    "ReaderDied", "RequestFailed",
    "Gateway", "FleetServer", "FleetMetrics", "KVTierFull",
    "KVTierStore", "ReplicaInfo",
    "ReplicaRegistry", "Router", "RoutingError",
    "FlightRecorder", "TraceBook", "TraceContext", "format_waterfall",
    "new_trace_id",
    "FleetSim", "ReplicaModel", "SimConfig", "SimEngine",
    "VirtualClock", "run_scenario", "run_sweep",
    "Request", "SyntheticWorkload", "fit_replica_model",
    "replay_from_traces",
    "UNIFIED", "PREFILL", "DECODE",
]
