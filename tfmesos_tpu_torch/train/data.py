"""Deterministic synthetic token batches and their host-to-card prefetch
(port of ``tfmesos_tpu/train/data.py:21-27, 61-83, 121-149``).

The stream is numpy, copied as is from the JAX package, so a seed gives
the same arrays in both packages for every ``(seed, start_step)``.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, Union

import numpy as np
import torch


def _step_rng(seed: int, step: int) -> np.random.RandomState:
    """Independent RNG for (stream seed, step): seeding MT19937 with the
    pair makes any step reachable in O(1), so a resumed stream never
    replays the skipped steps' draws."""
    return np.random.RandomState(
        np.array([seed & 0x7FFFFFFF, step], dtype=np.uint32))


def token_batches(batch_size: int, seq_len: int, vocab_size: int,
                  seed: int = 0, start_step: int = 0
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless ``{"tokens": [B, T+1] int32}`` batches with mild structure
    (bigram-ish) so a language model has something learnable: a Zipf
    unigram draw where half the positions follow the deterministic
    successor of their predecessor.  ``start_step`` jumps straight to
    that step."""
    # The vocabulary structure comes from the base seed, not the step.
    ranks = np.arange(1, vocab_size + 1)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    successor = np.random.RandomState(seed).permutation(vocab_size)
    step = start_step
    while True:
        rng = _step_rng(seed, step)
        step += 1
        base = rng.choice(vocab_size, size=(batch_size, seq_len + 1), p=probs)
        follow = rng.rand(batch_size, seq_len) < 0.5
        for t in range(1, seq_len + 1):
            base[:, t] = np.where(follow[:, t - 1], successor[base[:, t - 1]],
                                  base[:, t])
        yield {"tokens": base.astype(np.int32)}


def prefetch(batches: Iterator[Dict[str, np.ndarray]],
             device: Union[str, torch.device], depth: int = 2
             ) -> Iterator[Dict[str, torch.Tensor]]:
    """Overlap the host-to-card copy with compute: each numpy batch
    becomes tensors on ``device`` ``depth`` batches ahead of the
    consumer.  For a CUDA device the host tensors are pinned and copied
    with ``non_blocking=True``, so the copy engine streams the next
    inputs while the current step runs."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def place(batch):
        out = {}
        for k, a in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(a))
            if pin:
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=pin)
        return out

    queue: collections.deque = collections.deque()
    for batch in batches:
        queue.append(place(batch))
        if len(queue) > depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
