"""Admission control and backpressure for the fleet gateway (port of ``tfmesos_tpu/fleet/admission.py``).

Overload policy, in order of application:

1. **Deadline sheds**: a request whose end-to-end deadline has already
   passed is rejected with :class:`DeadlineExceeded` BEFORE the
   capacity check and BEFORE the token bucket is consulted — expired
   work must cost the fleet nothing, not a queue slot and not a rate
   token (the client gave up; serving it would be pure waste).  The
   same check runs again at DISPATCH (:meth:`AdmissionController.get`):
   a request that expired while waiting in its class queue is shed
   there with the per-class ``shed_deadline`` counter and handed to the
   ``on_expired`` callback so the gateway can still answer the client
   explicitly.
2. **Per-class bounded queues**: every request belongs to a priority
   class (the ``priority``/``tenant`` label on the wire, mapped here);
   each class has its own queue bound, and a full class sheds with
   :class:`Overloaded` WITHOUT touching any other class's capacity — a
   background flood fills the background queue and sheds there, while
   interactive arrivals keep being admitted.
3. **Token-bucket rate limiter** (optional): a sustained requests/s cap
   with a burst allowance, checked only AFTER the queue-capacity check
   so a shed never burns a token (an overloaded gateway must not
   double-penalize clients).  Over-rate arrivals are rejected with
   :class:`RateLimited`.

Dispatch is **weighted fair queueing** across the classes: each
admitted item gets a virtual-time finish tag ``max(vnow, class_last) +
1/weight`` and :meth:`AdmissionController.get` always serves the
smallest tag — so a class with weight ``w`` is guaranteed ~``w/Σw`` of
dispatcher throughput whenever it has work, and no class can starve
another no matter how hard it floods (the flood's tags race ahead of
the victim's).  With one class (the default) this degenerates to the
original FIFO queue exactly.

Both rejections are EXPLICIT wire replies — the contract is "never a
hang": a client always gets either a completion or an immediate
overload signal it can back off on.  (The alternative — unbounded
queueing — converts overload into unbounded latency, which at serving
scale is indistinguishable from an outage.)
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Overloaded", "RateLimited", "DeadlineExceeded", "TokenBucket",
           "PriorityClass", "AdmissionController", "DEFAULT_MAX_QUEUE"]

#: Default per-class ingress queue bound.  64 holds ~8 dispatch rounds
#: of backlog for the default 8-worker gateway before shedding; the
#: simulator's ``steady`` scenario (``tfserve simulate steady --sweep
#: admission.max_queue=16,64,256``) shows queue-wait p99 growing
#: roughly linearly with the bound under overload while the shed rate
#: falls — 64 keeps p99 under one service time at 2x overload.
#: Sweepable by path as ``admission.max_queue``.
DEFAULT_MAX_QUEUE = 64


class Overloaded(Exception):
    """Explicit shed: the ingress queue is at its bound."""

    kind = "overloaded"


class RateLimited(Overloaded):
    """Explicit shed: the token bucket is empty."""

    kind = "rate_limited"


class DeadlineExceeded(Exception):
    """Explicit shed: the request's end-to-end deadline already passed.
    Deliberately NOT an :class:`Overloaded` — the fleet is not asking
    the client to back off, it is telling it this request is dead."""

    kind = "deadline_exceeded"


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill up to ``burst``
    capacity; ``try_acquire`` never blocks (admission sheds instead of
    queueing over-rate work)."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock=time.monotonic):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(1.0, rate))
        if self.burst < 1.0:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


@dataclasses.dataclass
class PriorityClass:
    """One admission class (docs/SERVING.md "Priorities, preemption &
    migration").

    ``weight`` is the WFQ share (a weight-8 class gets ~8x the
    dispatcher throughput of a weight-1 class under contention);
    ``rank`` is the PREEMPTION priority forwarded to replicas (higher
    rank may suspend lower-rank resident rows under allocation
    pressure) — the two are deliberately separate knobs: fair-share is
    about throughput under sustained load, preemption about latency of
    the next arrival.  ``max_queue`` bounds this class's own ingress
    queue (``None`` = the controller default).  ``model_quota`` bounds
    how many of the queued slots ONE model may hold within this class
    (the per-tenant+per-model quota of the model catalog,
    docs/SERVING.md "Model catalog"): a tenant flooding one model
    sheds there without starving its own traffic to other models;
    ``None`` = unlimited, the pre-catalog behavior exactly.

    ``batch`` marks the OFFLINE lane (docs/SERVING.md "Offline lane"):
    a batch class dispatches only when every non-batch queue is EMPTY —
    strict background priority BELOW the WFQ fair-share, so batch work
    soaks up idle dispatcher capacity without ever consuming a share an
    interactive class could have used.  Batch classes are deadline-less
    by convention (submitters omit ``deadline_ms``) and should carry a
    ``rank`` below every interactive class so resident batch rows yield
    their decode slots to the first interactive arrival via the
    replica's preemption machinery."""

    name: str
    weight: float = 1.0
    rank: int = 0
    max_queue: Optional[int] = None
    model_quota: Optional[int] = None
    batch: bool = False

    def __post_init__(self):
        if not self.name:
            raise ValueError("priority class needs a non-empty name")
        if self.model_quota is not None and self.model_quota < 1:
            raise ValueError(f"class {self.name!r} model_quota must be "
                             f">= 1, got {self.model_quota}")
        # Finite AND positive: a NaN weight poisons every WFQ tag
        # comparison (dispatch order degrades to dict order) and an
        # inf weight's zero tag increment would starve every other
        # class — both break the no-starvation guarantee silently.
        if not math.isfinite(self.weight) or self.weight <= 0:
            raise ValueError(f"class {self.name!r} weight must be a "
                             f"finite positive number, got {self.weight}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"class {self.name!r} max_queue must be "
                             f">= 1, got {self.max_queue}")


class _ClassQ:
    """One class's live state: spec + queue + WFQ tag + shed counters."""

    __slots__ = ("spec", "q", "last_tag", "shed_queue", "shed_rate",
                 "shed_deadline", "shed_quota", "admitted",
                 "model_counts")

    def __init__(self, spec: PriorityClass):
        self.spec = spec
        # (finish_tag, seq, item, deadline, model)
        self.q: deque = deque()
        self.last_tag = 0.0
        self.shed_queue = 0
        self.shed_rate = 0
        self.shed_deadline = 0
        self.shed_quota = 0
        self.admitted = 0
        # model -> queued count (the per-tenant+per-model quota's
        # live book; decremented as items dequeue or expire).
        self.model_counts: Dict[str, int] = {}

    def _model_out(self, model: Optional[str]) -> None:
        if model is None:
            return
        n = self.model_counts.get(model, 0) - 1
        if n > 0:
            self.model_counts[model] = n
        else:
            self.model_counts.pop(model, None)


class AdmissionController:
    """Per-class bounded queues + WFQ dispatch + optional rate limiter.

    The gateway's connection threads call :meth:`admit` (which raises
    on shed); its dispatcher workers call :meth:`get`.  ``depth()`` is
    exported as the ``queue_depth`` gauge, :meth:`class_depths` as the
    per-class one.  Without ``classes`` this is exactly the original
    single-FIFO controller.
    """

    def __init__(self, max_queue: int = DEFAULT_MAX_QUEUE,
                 rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 classes: Optional[List[PriorityClass]] = None,
                 clock=time.monotonic):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = int(max_queue)
        self.bucket = TokenBucket(rate, burst, clock=clock) \
            if rate is not None else None
        specs = list(classes) if classes else [PriorityClass("default")]
        names = [c.name for c in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate priority class names in {names}")
        self._classes: Dict[str, _ClassQ] = {
            c.name: _ClassQ(c) for c in specs}
        # Unlabeled (and unknown-label) traffic maps to the FIRST
        # listed class — operators list highest-priority first, so
        # adding a background tier never degrades existing clients.
        self._default = specs[0].name
        self._clock = clock
        self._cond = threading.Condition()
        self._vtime = 0.0           # virtual time = last dispatched tag
        self._seq = 0               # FIFO tiebreak within equal tags
        # Called (outside the lock) with each item shed at DISPATCH
        # time because its deadline passed while queued — the gateway
        # hooks this to send the client its explicit
        # ``deadline_exceeded`` error instead of a silent drop.
        self.on_expired: Optional[Any] = None

    # -- class resolution --------------------------------------------------

    def resolve(self, label: Optional[str]) -> PriorityClass:
        """The class a request labeled ``label`` belongs to (the
        default class for ``None`` or an unknown label — a typo'd
        tenant must be served, just without special treatment)."""
        c = self._classes.get(label) if isinstance(label, str) else None
        if c is None:
            c = self._classes[self._default]
        return c.spec

    @property
    def class_names(self) -> List[str]:
        return list(self._classes)

    # -- admission ---------------------------------------------------------

    def admit(self, item: Any, cls: Optional[str] = None,
              deadline: Optional[float] = None,
              model: Optional[str] = None) -> None:
        """Enqueue ``item`` under class ``cls`` or raise — never blocks
        the caller's connection thread.  ``deadline`` is an absolute
        clock reading (the controller's ``clock``, monotonic by
        default) past which the request is dead: an already-expired
        arrival sheds FIRST — before the capacity check and before the
        token bucket, which must not be debited for work nobody will
        wait for — and a queued item that expires before dispatch is
        shed by :meth:`get`.  Capacity is checked BEFORE the token
        bucket is debited: a shed must not also burn a token
        (double-penalizing clients exactly when the gateway is already
        overloaded)."""
        spec = self.resolve(cls)
        c = self._classes[spec.name]
        bound = spec.max_queue if spec.max_queue is not None \
            else self.max_queue
        with self._cond:
            if deadline is not None and self._clock() >= deadline:
                c.shed_deadline += 1
                raise DeadlineExceeded(
                    f"request deadline expired before admission "
                    f"(class {spec.name!r})")
            if len(c.q) >= bound:
                c.shed_queue += 1
                raise Overloaded(
                    f"ingress queue full for class {spec.name!r} "
                    f"({bound} requests waiting)")
            if model is not None and spec.model_quota is not None \
                    and c.model_counts.get(model, 0) >= spec.model_quota:
                # Per-tenant+per-model quota (checked AFTER the class
                # bound — one consistent shed order — and BEFORE the
                # token bucket, which a shed must never debit): this
                # tenant's flood of ONE model sheds without touching
                # its own slots for other models or any other class.
                c.shed_quota += 1
                raise Overloaded(
                    f"model quota full for class {spec.name!r} / model "
                    f"{model!r} ({spec.model_quota} queued)")
            if self.bucket is not None and not self.bucket.try_acquire():
                c.shed_rate += 1
                raise RateLimited(
                    f"rate limit exceeded ({self.bucket.rate:g} req/s, "
                    f"burst {self.bucket.burst:g})")
            # WFQ virtual-time finish tag: service owed to this class so
            # far (its last tag) or global virtual now, whichever is
            # later, plus this item's 1/weight of service.
            tag = max(self._vtime, c.last_tag) + 1.0 / spec.weight
            c.last_tag = tag
            self._seq += 1
            c.q.append((tag, self._seq, item, deadline, model))
            if model is not None:
                c.model_counts[model] = c.model_counts.get(model, 0) + 1
            c.admitted += 1
            self._cond.notify()

    def get(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Next admitted item in WFQ order (smallest finish tag wins;
        FIFO within a class), or ``None`` on timeout — workers poll so
        shutdown never needs queue poisoning.  Items whose deadline
        passed while queued are shed here, BEFORE dispatch: each counts
        its class's ``shed_deadline`` and is handed to ``on_expired``
        (outside the lock), and the walk continues to the next live
        item — expired work never reaches a router worker."""
        item, expired = self._get(timeout)
        cb = self.on_expired
        if cb is not None:
            for it in expired:
                try:
                    cb(it)
                except Exception:   # pragma: no cover - gateway's duty
                    pass
        return item

    def _get(self, timeout: Optional[float]) -> tuple:
        # The poll deadline runs on the INJECTED clock, like the
        # deadline sheds above — under time.monotonic (production) this
        # is the old behavior exactly; under the simulator's virtual
        # clock a timeout=0 poll returns without ever touching the
        # condition's real-time wait (calling time.monotonic here
        # directly was a latent clock-mixing bug for any injected-clock
        # caller).
        poll_deadline = None if timeout is None \
            else self._clock() + timeout
        expired = []
        with self._cond:
            while True:
                # WFQ over the non-batch classes first; the offline
                # lane (batch=True classes) is served ONLY when every
                # non-batch queue is empty — strict background
                # priority, so batch backlog can never dilute an
                # interactive class's fair share.
                best = None
                for c in self._classes.values():
                    if c.spec.batch or not c.q:
                        continue
                    if best is None or c.q[0][:2] < best.q[0][:2]:
                        best = c
                if best is None:
                    for c in self._classes.values():
                        if not c.spec.batch or not c.q:
                            continue
                        if best is None or c.q[0][:2] < best.q[0][:2]:
                            best = c
                if best is not None:
                    tag, _, item, dl, model = best.q.popleft()
                    best._model_out(model)
                    if tag > self._vtime:
                        self._vtime = tag
                    if dl is not None and self._clock() >= dl:
                        best.shed_deadline += 1
                        expired.append(item)
                        continue
                    return item, expired
                remaining = None if poll_deadline is None \
                    else poll_deadline - self._clock()
                if remaining is not None and remaining <= 0:
                    return None, expired
                if not self._cond.wait(remaining):
                    return None, expired

    # -- observability -----------------------------------------------------

    def depth(self) -> int:
        with self._cond:
            return sum(len(c.q) for c in self._classes.values())

    def class_depths(self) -> Dict[str, int]:
        """Per-class queue depths (the gateway's ``queue_depths``
        gauge)."""
        with self._cond:
            return {name: len(c.q) for name, c in self._classes.items()}

    def shed_counts(self) -> Dict[str, Tuple[int, int, int]]:
        """Per-class ``(queue sheds, rate sheds, deadline sheds)``
        since start."""
        with self._cond:
            return {name: (c.shed_queue, c.shed_rate, c.shed_deadline)
                    for name, c in self._classes.items()}

    def quota_shed_counts(self) -> Dict[str, int]:
        """Per-class sheds from the per-tenant+per-model quota."""
        with self._cond:
            return {name: c.shed_quota
                    for name, c in self._classes.items()}
