"""Device resolution for the port's entry points.

Counterpart of ``tfmesos_tpu/utils/platform.py``: one place that decides
where the program runs.  The rule is strict — an entry point runs on the
card unless its caller asks for the CPU, and it never drops to the CPU
on its own: a missing card is an error, not a slower run.
"""

from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``None`` means the card (``"cuda"``).  A CUDA device with no card
    present raises ``RuntimeError`` naming the way out (pass
    ``device="cpu"``).  Also pins float32 matmuls and convolutions to
    full float32 (no TF32), so a float32 run on the card computes what
    the CPU reference computes."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            f"available; pass device='cpu' to run the plain PyTorch "
            f"path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev

