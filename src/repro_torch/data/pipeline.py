"""Host data pipeline: shuffle → batch → (per-host shard) → prefetch.
The port's own copy of ``repro.data.pipeline`` (numpy only): the same
seed, epoch, host index and host count give the same batches.

At pod scale each host feeds only its addressable shard of the global
batch (``host_shard``); a slow host therefore delays nothing but its own
shard's collective entry — the straggler story is handled at the trainer
level (see train/trainer.py watchdog).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np


class BatchPipeline:
    def __init__(self, arrays: Dict[str, np.ndarray], *, batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 host_index: int = 0, host_count: int = 1):
        self.arrays = arrays
        n = next(iter(arrays.values())).shape[0]
        if any(a.shape[0] != n for a in arrays.values()):
            raise ValueError("arrays differ in their leading dimension")
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.host_index = host_index
        self.host_count = host_count
        if batch_size % host_count:
            raise ValueError(f"batch_size {batch_size} is not a multiple of"
                             f" host_count {host_count}")

    def epoch(self, epoch_idx: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(self.n)
        if self.shuffle:
            # same permutation on every host: shard by position
            np.random.RandomState(self.seed + epoch_idx).shuffle(order)
        bs = self.batch_size
        per_host = bs // self.host_count
        lo = self.host_index * per_host
        for i in range(0, self.n - (bs if self.drop_last else 1) + 1, bs):
            idx = order[i:i + bs][lo:lo + per_host]
            yield {k: a[idx] for k, a in self.arrays.items()}

    def forever(self) -> Iterator[Dict[str, np.ndarray]]:
        e = 0
        while True:
            yield from self.epoch(e)
            e += 1


class Prefetcher:
    """Background-thread prefetch (depth-bounded) over any iterator."""

    def __init__(self, it: Iterator, depth: int = 2,
                 transform: Optional[Callable] = None):
        self.it = it
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.transform = transform
        self._done = object()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            for item in self.it:
                if self.transform:
                    item = self.transform(item)
                self.q.put(item)
        finally:
            self.q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._done:
            raise StopIteration
        return item
