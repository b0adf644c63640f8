"""The mnist_replica workload model (port of
``tfmesos_tpu/models/mlp.py``): one hidden ReLU layer (100 units by
default), softmax cross entropy, and accuracy as its metric.

Same parameter dict as the JAX package (``w1``, ``b1``, ``w2``,
``b2``), so JAX weights carry across through
``convert.params_from_jax``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Union

import torch

from tfmesos_tpu_torch.ops.layers import cross_entropy_loss

__all__ = ["MLPConfig", "init_params", "forward", "loss_fn"]


@dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: int = 100
    n_classes: int = 10
    dtype: Any = torch.float32


def init_params(cfg: MLPConfig, generator: torch.Generator,
                device: Union[str, torch.device] = "cpu") -> Dict[str, Any]:
    """Random params with the JAX layout and scales (normal weights over
    sqrt(fan-in), zero biases), drawn on the CPU from ``generator`` so a
    seed gives the same weights on every device."""
    def norm(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(cfg.dtype).to(device)

    return {
        "w1": norm((cfg.in_dim, cfg.hidden), cfg.in_dim),
        "b1": torch.zeros((cfg.hidden,), dtype=cfg.dtype, device=device),
        "w2": norm((cfg.hidden, cfg.n_classes), cfg.hidden),
        "b2": torch.zeros((cfg.n_classes,), dtype=cfg.dtype, device=device),
    }


def forward(cfg: MLPConfig, params, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def loss_fn(cfg: MLPConfig, params, batch):
    """``(mean cross entropy, {"accuracy": ...})`` over ``batch``'s
    ``image`` [B, in_dim] and ``label`` [B]."""
    logits = forward(cfg, params, batch["image"])
    loss = cross_entropy_loss(logits, batch["label"])
    acc = (logits.argmax(-1) == batch["label"].long()).float().mean()
    return loss, {"accuracy": acc}
