"""tfmesos_tpu_torch — the PyTorch/CUDA port of ``tfmesos_tpu``'s model
and serving path, for NVIDIA Hopper (H100).

Module names mirror the JAX package (``ops/attention.py`` here is the
counterpart of ``tfmesos_tpu/ops/attention.py``), so each port module
has exactly one reference module.  The package imports ``torch`` and
never ``jax``, nor anything of ``tfmesos_tpu``: where it needs code
from there it keeps its own copy.

The TPU kernels on the serving path are hand-written CUDA C++ under
``csrc/``, built by ``kernels/build.py`` at first use.  A kernel
wrapper launches its kernel on CUDA tensors (or raises) and runs the
plain PyTorch version only for CPU tensors; entry points default to
``device="cuda"`` and raise without a card unless ``device="cpu"`` is
passed (see ``device.py``).
"""

__version__ = "0.1.0"
