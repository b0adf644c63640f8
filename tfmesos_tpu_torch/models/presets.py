"""Model presets (port of ``tfmesos_tpu/fleet/replica.py:976-1000``).

Same configurations as the JAX package's ``tiny_model`` and
``flagship_model``; the weights are drawn from a ``torch.Generator``
seeded with ``seed``, so they are reproducible but not the JAX
package's numbers (carry those across with ``convert.py``).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from tfmesos_tpu_torch.models.transformer import (Params, TransformerConfig,
                                                  init_params)


def tiny_model(seed: int = 0, device: Union[str, torch.device] = "cpu"
               ) -> Tuple[TransformerConfig, Params]:
    """The CI model: vocab 97, d32, 2 layers, 4 heads, float32."""
    cfg = TransformerConfig(vocab_size=97, d_model=32, n_layers=2,
                            n_heads=4, d_ff=64, max_seq_len=128,
                            dtype=torch.float32)
    return cfg, init_params(cfg, torch.Generator().manual_seed(seed), device)


def flagship_model(seed: int = 0, max_len: int = 1024,
                   device: Union[str, torch.device] = "cpu"
                   ) -> Tuple[TransformerConfig, Params]:
    """The flagship serving config: vocab 8192, d512, 8 layers, 8 heads
    (head_dim 64, MHA), d_ff 1408, bf16 compute (about 34M params)."""
    cfg = TransformerConfig(vocab_size=8192, d_model=512, n_layers=8,
                            n_heads=8, d_ff=1408, max_seq_len=max_len,
                            dtype=torch.bfloat16)
    return cfg, init_params(cfg, torch.Generator().manual_seed(seed), device)
