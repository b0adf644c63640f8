"""CUDA graphs of the decode steps: capture a step over static buffers
once per shape, then replay it (the port's counterpart of the JAX
package compiling each decode shape ahead of time, ``jax.jit`` plus
``ContinuousBatcher.warmup``).

A step is a function of no arguments that reads its inputs from static
device buffers and writes its results into static device buffers, so a
replay reruns it on whatever the buffers hold now.  :class:`StepGraphs`
keeps one graph per key (the batcher's table width, or generate's one
step):

- **One eager call first.**  Before a key is captured, the step runs once
  eagerly on the capture stream: what must not happen inside a capture
  happens there (``nvcc`` and the ``ctypes`` load in ``kernels/build.py``,
  each kernel's one-time shared-memory attribute, the split-plan and SM
  memos, cuBLAS's handle and workspace).
- **Launch accounting.**  The kernel wrappers count their launches in
  Python (``ops/attention.py`` and ``ops/quant.py`` ``LAUNCHES``), which
  a replay does not run: the capture's counts are taken back (a capture
  launches nothing) and added again at every replay, so the counters
  still say how many kernels ran.
- **One memory pool** (``torch.cuda.graph_pool_handle``) for every graph
  of one owner.  A step leaves no tensor of its capture alive (results go
  into buffers allocated outside), and one owner replays its graphs one
  at a time on one stream, so they can share the pool in any order.
- **Failures raise.**  A capture or replay error propagates; nothing
  falls back to eager on the card.

On the CPU (and with ``eager`` set, a diagnostic for comparing the two
paths on the card) every call runs the step eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple, Union

import torch

from tfmesos_tpu_torch.ops import attention, quant

Step = Callable[[], None]


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, one dict."""
    return {**attention.LAUNCHES, **quant.LAUNCHES}


def add_launches(delta: Dict[str, int], sign: int = 1) -> None:
    """Add ``sign`` x ``delta`` to the wrappers' counters."""
    for name, n in delta.items():
        counters = attention.LAUNCHES if name in attention.LAUNCHES \
            else quant.LAUNCHES
        counters[name] += sign * n


class StepGraphs:
    """The captured steps of one owner (a batcher, or one ``generate``
    call) on ``device``: :meth:`run` replays a key's graph, capturing it
    at the key's first call; :meth:`warm` captures ahead of time.
    ``pool_bytes`` is the device memory the captures reserved."""

    def __init__(self, device: Union[str, torch.device]):
        self.device = torch.device(device)
        self.eager = self.device.type != "cuda"
        self.pool_bytes = 0
        self._graphs: Dict[Hashable, Tuple[Callable[[], None],
                                           Dict[str, int]]] = {}
        self._pool = None
        self._stream = None

    def __contains__(self, key: Hashable) -> bool:
        return key in self._graphs

    def run(self, key: Hashable, step: Step) -> None:
        """Run ``step`` once: the replay of ``key``'s graph, or, at the
        key's first call, the step eagerly and then its capture (the
        eager call is this call's work)."""
        if self.eager:
            step()
            return
        entry = self._graphs.get(key)
        if entry is None:
            self._warm_capture(key, step)
            return
        replay, delta = entry
        replay()
        add_launches(delta)

    def warm(self, key: Hashable, step: Step) -> None:
        """Capture ``key`` ahead of time (one eager call, then the
        capture); a no-op once captured.  The eager call does the step's
        work on whatever its buffers hold."""
        if self.eager:
            step()
        elif key not in self._graphs:
            self._warm_capture(key, step)

    def _warm_capture(self, key: Hashable, step: Step) -> None:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        self._on_stream(step)
        before = launch_counts()
        reserved = self._reserved()
        replay = self._capture(step)
        self.pool_bytes += self._reserved() - reserved
        delta = {k: n - before[k] for k, n in launch_counts().items()
                 if n != before[k]}
        add_launches(delta, -1)               # the capture launched nothing
        self._graphs[key] = (replay, delta)

    def _on_stream(self, step: Step) -> None:
        """``step`` eagerly on the capture stream, ordered after the
        caller's stream and before its next work."""
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            step()
        current.wait_stream(self._stream)

    def _reserved(self) -> int:
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(self.device)

    def _capture(self, step: Step) -> Callable[[], None]:
        """Record ``step`` into a new graph; returns its replay."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            step()
        return graph.replay
