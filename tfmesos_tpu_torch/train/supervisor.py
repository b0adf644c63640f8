"""Driver-level restart supervision, checkpoint-coordinated (port of
``tfmesos_tpu/train/supervisor.py``).

* :func:`supervise` — the bare restart loop: re-run an attempt function
  until it returns, retrying only :class:`ClusterError` (infrastructure
  death), never workload bugs (:class:`RemoteError` included).
* :func:`supervise_training` — the checkpoint-coordinated form: each
  attempt restores the latest :class:`~tfmesos_tpu_torch.train.
  checkpoint.CheckpointManager` step into its :class:`~tfmesos_tpu_torch.
  train.trainer.TrainLoop`, realigns the batch iterator to the resumed
  step (a pluggable skip-ahead hook: the default drains the iterator,
  seekable pipelines jump), runs only the remaining steps with periodic
  saves, and reports restart and resume counters.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from tfmesos_tpu_torch.scheduler import ClusterError, RemoteError
from tfmesos_tpu_torch.utils.logging import get_logger

log = get_logger("tfmesos_tpu_torch.supervisor")


@dataclass
class SuperviseResult:
    value: Any
    attempts: int
    elapsed_s: float


def supervise(run_attempt: Callable[[int], Any], max_restarts: int = 3,
              restart_wait: float = 5.0,
              should_retry: Optional[Callable[[BaseException], bool]] = None,
              ) -> SuperviseResult:
    """Run ``run_attempt(attempt_index)`` until it returns, restarting on
    cluster failure.

    ``run_attempt`` owns the whole attempt: bring up a cluster, restore the
    latest checkpoint, train, tear down (in the reference the ``cluster()``
    context manager tears down even on failure; the port's comes with
    ROADMAP A.9).  Only :class:`ClusterError` — i.e.
    infrastructure death, the thing restarts can actually fix — triggers a
    retry by default; workload bugs propagate immediately, including
    exceptions raised by dispatched functions on tasks
    (:class:`RemoteError`).  ``should_retry`` widens/narrows that policy.
    """
    start = time.monotonic()
    attempt = 0
    while True:
        try:
            value = run_attempt(attempt)
            return SuperviseResult(value=value, attempts=attempt + 1,
                                   elapsed_s=time.monotonic() - start)
        except BaseException as e:
            retry = (should_retry(e) if should_retry is not None
                     else isinstance(e, ClusterError)
                     and not isinstance(e, RemoteError))
            if not retry or attempt >= max_restarts:
                raise
            attempt += 1
            log.warning("attempt %d failed (%s: %s); restarting in %.1fs "
                        "(%d restart(s) left)", attempt, type(e).__name__, e,
                        restart_wait, max_restarts - attempt + 1)
            time.sleep(restart_wait)


# -- checkpoint-coordinated supervision -------------------------------------


def skip_batches(batches: Iterator, n: int) -> Iterator:
    """The stock batch-iterator skip-ahead: drain ``n`` batches so a
    resumed run sees exactly the data an uninterrupted one would have at
    the same step.  Correct for any iterator; O(resumed step).  Pipelines
    with seekable state (e.g. ``TokenFileDataset.batches(start_step=...)``)
    should plug their own hook and jump in O(1)."""
    for _ in range(n):
        next(batches)
    return batches


@dataclass
class TrainSuperviseResult:
    """What a supervised training run actually did."""

    result: Dict[str, Any]          # the final attempt's TrainLoop.run dict
    attempts: int                   # total attempts (1 = no restart)
    restarts: int                   # attempts - 1
    resumed_steps: List[int] = field(default_factory=list)  # per attempt
    elapsed_s: float = 0.0


def supervise_training(build: Callable[[int], Tuple[Any, Iterator]],
                       total_steps: int,
                       manager: Any,
                       save_every: int = 50,
                       max_restarts: int = 3,
                       restart_wait: float = 5.0,
                       skip_hook: Optional[Callable[[Iterator, int],
                                                    Iterator]] = skip_batches,
                       should_retry: Optional[Callable[[BaseException],
                                                       bool]] = None,
                       ) -> TrainSuperviseResult:
    """Run a training job to ``total_steps``, restarting on cluster
    failure and resuming each attempt from the latest checkpoint.

    ``build(attempt) -> (loop, batches)`` constructs a fresh
    :class:`~tfmesos_tpu_torch.train.trainer.TrainLoop` (state initialized from
    scratch — the restore overwrites it) and its batch iterator, started
    from step 0.  Per attempt this supervisor: attaches ``manager`` to the
    loop, restores the latest saved step, realigns ``batches`` via
    ``skip_hook`` (pass ``None`` when ``build`` already starts the
    iterator at the resumed step — e.g. a seekable dataset reading
    ``manager.latest_step()`` itself), then runs only the remaining steps
    with a save every ``save_every`` global steps.

    Retry policy is :func:`supervise`'s: only :class:`ClusterError`
    restarts by default; workload bugs (and :class:`RemoteError`)
    propagate immediately.
    """
    if total_steps < 0:
        raise ValueError(f"total_steps must be >= 0, got {total_steps}")
    resumed_steps: List[int] = []

    def attempt(i: int) -> Dict[str, Any]:
        loop, batches = build(i)
        loop.checkpoint = manager
        loop.save_every = save_every
        start = loop.resume()
        resumed_steps.append(start)
        remaining = max(0, total_steps - start)
        if start and remaining and skip_hook is not None:
            batches = skip_hook(batches, start)
        return loop.run(batches, remaining)

    r = supervise(attempt, max_restarts=max_restarts,
                  restart_wait=restart_wait, should_retry=should_retry)
    return TrainSuperviseResult(result=r.value, attempts=r.attempts,
                                restarts=r.attempts - 1,
                                resumed_steps=resumed_steps,
                                elapsed_s=r.elapsed_s)
