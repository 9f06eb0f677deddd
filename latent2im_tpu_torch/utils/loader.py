"""Batches of images decoded ahead on a fixed pool of threads.

The pool under the port's native ``Loader`` (latent2im_tpu_torch/native,
the JAX package's threaded libjpeg/libpng loader) and under the Pillow-path
loaders of ``cli/train_regressor.py`` (its test split, and its training
split and ``--updateGAN``'s real batches where the native module is
hidden, ``cli/train.py:_make_real_batcher``). The caller gives the stream of index
batches and a function that loads one image; the loader keeps DEPTH
batches in flight on its threads while the caller's step runs, and yields
exactly the batches of the sequential path, in its order: the same index
batches, each image loaded by the same function, stacked in the same order.
An image that fails to load raises at its batch, as it would in sequence.

The threads overlap because the decode and resize run in compiled code that
releases the GIL (the ctypes calls into ops/csrc/*.cpp, zlib, numpy); the
Python between them holds it. The pool is
``os.cpu_count()`` threads, at most ``MAX_THREADS``.
"""

from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator

import numpy as np

MAX_THREADS = 8
DEPTH = 2  # batches in flight beyond the one the caller waits for


def default_threads() -> int:
    return max(1, min(os.cpu_count() or 1, MAX_THREADS))


class Loader:
    """``load_one(i) -> uint8 array``, run on ``threads`` threads. Close it
    (or use it as a context manager) to stop its threads."""

    def __init__(self, load_one: Callable[[int], np.ndarray], threads: int | None = None):
        self.load_one = load_one
        self.threads = threads or default_threads()
        self._pool = ThreadPoolExecutor(self.threads, thread_name_prefix="l2i-loader")

    def batches(self, index_batches: Iterable) -> Iterator[tuple[np.ndarray, list]]:
        """-> (uint8 [B, ...] stacked in index order, the indices as a list)
        for each index batch, loaded DEPTH batches ahead."""
        pending: collections.deque = collections.deque()
        it = iter(index_batches)
        try:
            while True:
                while len(pending) <= DEPTH:
                    idx = next(it, None)
                    if idx is None:
                        break
                    idx = list(idx)
                    pending.append((idx, [self._pool.submit(self.load_one, i) for i in idx]))
                if not pending:
                    return
                idx, futures = pending.popleft()
                yield np.stack([f.result() for f in futures]), idx
        finally:  # the caller stopped early or a load raised: drop the rest
            for _, futures in pending:
                for f in futures:
                    f.cancel()

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
