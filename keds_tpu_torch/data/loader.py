"""Single-process batching loader (counterpart of ``keds_tpu/data/loader.py``
for one process).

The epoch order is the JAX package's: ``np.random.default_rng(seed +
epoch).permutation(n)`` when shuffling, reseeded by :meth:`set_epoch`.  A
batch's samples are read by the calling thread, or by a thread pool of
``num_workers``; numpy leaves are stacked and strings (the text stream's
subjects) listed.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Sequence

import numpy as np


def default_collate(samples: Sequence[Any]):
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(default_collate([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, np.ndarray):
        return np.stack(samples)
    return list(samples)


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle for ``epoch``."""
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        """This epoch's sample order."""
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    @property
    def num_batches(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator:
        idx = self.indices()
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(self.num_batches)]
        if self.num_workers <= 0:
            for b in batches:
                yield default_collate([self.dataset[int(i)] for i in b])
            return
        with ThreadPoolExecutor(self.num_workers) as pool:
            def submit(b):
                return [pool.submit(self.dataset.__getitem__, int(i)) for i in b]

            pending = submit(batches[0]) if batches else []
            for j in range(len(batches)):
                current = pending
                # the next batch decodes while this one is consumed
                pending = submit(batches[j + 1]) if j + 1 < len(batches) else []
                yield default_collate([f.result() for f in current])
