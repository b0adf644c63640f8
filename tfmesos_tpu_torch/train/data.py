"""Token batches, synthetic or from a token file, the synthetic MNIST
stand-in, and their host-to-card prefetch (port of
``tfmesos_tpu/train/data.py:21-83, 121-337``).

The streams are numpy, copied as is from the JAX package, so a seed
gives the same arrays in both packages for every ``(seed, start_step)``.
"""

from __future__ import annotations

import collections
import ctypes
import os
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch


def _step_rng(seed: int, step: int) -> np.random.RandomState:
    """Independent RNG for (stream seed, step): seeding MT19937 with the
    pair makes any step reachable in O(1), so a resumed stream never
    replays the skipped steps' draws."""
    return np.random.RandomState(
        np.array([seed & 0x7FFFFFFF, step], dtype=np.uint32))


@dataclass
class SyntheticMNIST:
    """A seeded generative stand-in for MNIST (nothing is downloaded):
    each class is a fixed random template in [0, 1]^784 plus noise,
    which a one-hidden-layer MLP separates at MNIST's scale.  The
    templates come from ``seed``; each batch stream from its own seed."""

    n_classes: int = 10
    dim: int = 784
    noise: float = 0.35
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.templates = rng.rand(self.n_classes, self.dim).astype(
            np.float32)

    def batches(self, batch_size: int, seed: int = 1, start_step: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Endless ``{"image": [B, dim] float32, "label": [B] int32}``
        batches, each from a per-step RNG, so ``start_step`` jumps
        straight to that step."""
        step = start_step
        while True:
            rng = _step_rng(seed, step)
            labels = rng.randint(0, self.n_classes, size=batch_size)
            images = self.templates[labels] + self.noise * rng.randn(
                batch_size, self.dim).astype(np.float32)
            yield {"image": np.clip(images, 0.0, 1.0).astype(np.float32),
                   "label": labels.astype(np.int32)}
            step += 1

    def eval_batch(self, batch_size: int = 1000, seed: int = 999):
        return next(self.batches(batch_size, seed=seed))


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


class _NativeTokenGather:
    """ctypes wrapper over ``native/tokenloader.cpp`` (built with ``g++``
    at first use by :func:`~tfmesos_tpu_torch.kernels.build.build_host`):
    mmap + madvise gather and convert of [B, T+1] token windows in C++,
    optionally on a background thread (double-buffering against the
    train step).  Output is bit-identical to the numpy memmap path.
    ``load()`` returns None when the library does not build — callers
    fall back to numpy."""

    _lib = None
    _tried = False

    @classmethod
    def load(cls):
        if not cls._tried:
            cls._tried = True
            from tfmesos_tpu_torch.kernels.build import build_host
            try:
                lib = ctypes.CDLL(str(build_host("tokenloader")))
            except (OSError, RuntimeError):
                return None
            lib.tl_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.tl_open.restype = ctypes.c_void_p
            lib.tl_n_tokens.argtypes = [ctypes.c_void_p]
            lib.tl_n_tokens.restype = ctypes.c_int64
            ptr = ctypes.POINTER
            args = [ctypes.c_void_p, ptr(ctypes.c_int64), ctypes.c_int64,
                    ctypes.c_int64, ptr(ctypes.c_int32)]
            lib.tl_gather.argtypes = args
            lib.tl_gather.restype = ctypes.c_int
            lib.tl_gather_async.argtypes = args
            lib.tl_gather_async.restype = ctypes.c_int
            lib.tl_wait.argtypes = [ctypes.c_void_p]
            lib.tl_wait.restype = ctypes.c_int
            lib.tl_close.argtypes = [ctypes.c_void_p]
            lib.tl_close.restype = None
            cls._lib = lib
        return cls._lib

    def __init__(self, path: str, dtype: np.dtype):
        self.lib = self.load()
        if self.lib is None:
            raise RuntimeError("libtokenloader.so did not build")
        self.handle = self.lib.tl_open(
            os.fsencode(os.path.abspath(path)), int(dtype.itemsize))
        if not self.handle:
            raise RuntimeError(f"tl_open failed for {path}")
        self.n_tokens = self.lib.tl_n_tokens(self.handle)
        # Keep the in-flight gather's operands alive until wait().
        self._inflight = None

    @staticmethod
    def _ptrs(starts: np.ndarray, out: np.ndarray):
        c = ctypes
        return (starts.ctypes.data_as(c.POINTER(c.c_int64)),
                len(starts), out.shape[1],
                out.ctypes.data_as(c.POINTER(c.c_int32)))

    def gather(self, starts: np.ndarray, t1: int) -> np.ndarray:
        starts = np.ascontiguousarray(starts, np.int64)
        out = np.empty((len(starts), t1), np.int32)
        rc = self.lib.tl_gather(self.handle, *self._ptrs(starts, out))
        if rc != 0:
            raise ValueError(f"tl_gather rc={rc}")
        return out

    def gather_async(self, starts: np.ndarray, t1: int) -> None:
        starts = np.ascontiguousarray(starts, np.int64)
        out = np.empty((len(starts), t1), np.int32)
        rc = self.lib.tl_gather_async(self.handle,
                                      *self._ptrs(starts, out))
        if rc != 0:
            raise ValueError(f"tl_gather_async rc={rc}")
        self._inflight = (starts, out)

    def wait(self) -> np.ndarray:
        starts, out = self._inflight
        self.lib.tl_wait(self.handle)
        self._inflight = None
        return out

    def close(self) -> None:
        if getattr(self, "handle", None):
            self.lib.tl_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


@dataclass
class TokenFileDataset:
    """Memmap-backed token stream — the standard pretraining format: one
    flat on-disk array of token ids (uint16 for vocab <= 65536, else
    uint32), sampled as random [B, T+1] windows.

    Distributed reads shard by POSITION STRIPE: rank r of w samples only
    from its contiguous 1/w-th of the file, so hosts never touch the same
    pages and streams stay decorrelated by construction."""

    path: str
    dtype: str = "uint16"
    seed: int = 0

    def __post_init__(self):
        self.tokens = np.memmap(self.path, dtype=np.dtype(self.dtype),
                                mode="r")
        if self.tokens.size < 2:
            raise ValueError(f"{self.path}: too few tokens "
                             f"({self.tokens.size})")

    @staticmethod
    def write(path: str, tokens: np.ndarray, dtype: str = "uint16") -> None:
        """Write a flat token array in this dataset's format."""
        np.asarray(tokens).astype(np.dtype(dtype)).tofile(path)

    def batches(self, batch_size: int, seq_len: int, rank: int = 0,
                world_size: int = 1, seed: Optional[int] = None,
                start_step: int = 0, native: Optional[bool] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Endless [B, T+1] next-token batches from this rank's stripe.

        ``start_step`` starts at that step for exact O(1) resume (per-step
        RNG; no skipped data is drawn or read).

        ``native=None`` uses the C++ gather when it builds: the window
        copies and the int32 convert run off the GIL, the NEXT step's
        batch assembling on a background thread while the current step
        trains — bit-identical output to the numpy path.  ``False``
        forces numpy; ``True`` raises if the library does not build.
        """
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside world of {world_size}")
        n = self.tokens.size
        lo = n * rank // world_size
        hi = n * (rank + 1) // world_size
        if hi - lo < seq_len + 1:
            raise ValueError(
                f"stripe [{lo}, {hi}) of {self.path} shorter than one "
                f"window ({seq_len + 1}); fewer ranks or a bigger file")
        base_seed = self.seed if seed is None else seed
        starts_max = hi - (seq_len + 1)
        t1 = seq_len + 1

        def starts_for(step):
            return _step_rng(base_seed, step).randint(
                lo, starts_max + 1, size=batch_size)

        loader = None
        if native is not False:
            try:
                loader = _NativeTokenGather(self.path, np.dtype(self.dtype))
            except RuntimeError:
                if native:
                    raise
        if loader is None:
            step = start_step
            while True:
                starts = starts_for(step)
                step += 1
                batch = np.stack([self.tokens[s:s + t1] for s in starts])
                yield {"tokens": batch.astype(np.int32)}
        # Double-buffered native path: step N's gather overlapped with the
        # consumer's work on step N-1.  close() on GeneratorExit so an
        # abandoned iterator releases the mmap and joins the worker thread
        # deterministically, not at GC time.
        try:
            step = start_step
            loader.gather_async(starts_for(step), t1)
            while True:
                batch = loader.wait()
                step += 1
                loader.gather_async(starts_for(step), t1)
                yield {"tokens": batch}
        finally:
            loader.close()
