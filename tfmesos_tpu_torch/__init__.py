"""tfmesos_tpu_torch — the PyTorch/CUDA port of ``tfmesos_tpu``, for
NVIDIA Hopper (H100).

Module names mirror the JAX package (``ops/attention.py`` here is the
counterpart of ``tfmesos_tpu/ops/attention.py``), so each port module
has exactly one reference module.  The package imports ``torch`` and
never ``jax``, nor anything of ``tfmesos_tpu``: where it needs code
from there it keeps its own copy.

The public surface is the JAX package's: the :func:`cluster` context
manager over :class:`TPUMesosScheduler`, with its jobs normalization;
``python -m tfmesos_tpu_torch.cli run`` is ``tfrun``.  Importing the
package imports no torch.

The TPU kernels are hand-written CUDA C++ under ``csrc/``, built by
``kernels/build.py`` at first use.  A kernel wrapper launches its
kernel on CUDA tensors (or raises) and runs the plain PyTorch version
only for CPU tensors; entry points default to ``device="cuda"`` and
raise without a card unless ``device="cpu"`` is passed (see
``device.py``).
"""

from __future__ import annotations

from contextlib import contextmanager

from tfmesos_tpu_torch.scheduler import (ClusterError, RemoteError,
                                         TPUMesosScheduler)
from tfmesos_tpu_torch.spec import Job, normalize_jobs

__version__ = "0.1.0"
__VERSION__ = __version__

__all__ = ["cluster", "Job", "TPUMesosScheduler", "ClusterError",
           "RemoteError", "__VERSION__", "__version__"]


@contextmanager
def cluster(jobs, **kwargs):
    """Bring up a cluster, yield the scheduler, always tear it down.

    ``jobs`` may be a :class:`Job`, a dict of Job keyword arguments, or a
    list of either (the JAX package's normalization).  Keyword arguments
    go to :class:`TPUMesosScheduler`."""
    jobs = normalize_jobs(jobs)
    scheduler = TPUMesosScheduler(jobs, **kwargs)
    scheduler.start()
    try:
        yield scheduler
    finally:
        scheduler.stop()
